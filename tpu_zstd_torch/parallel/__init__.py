"""Batch sharding across the ranks of a `torch.distributed` group."""

from .multihost import compress_batch_distributed, initialize
from .sharding import compress_blocks_sharded, make_mesh

__all__ = [
    "compress_batch_distributed",
    "compress_blocks_sharded",
    "initialize",
    "make_mesh",
]
