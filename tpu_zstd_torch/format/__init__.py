"""Host-side (numpy) format helpers the port needs: FSE encode tables and
the frame header."""
