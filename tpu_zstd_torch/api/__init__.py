"""User-facing surface of the port: compression configuration and the batch
manager."""
