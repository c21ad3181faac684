"""Host-side RFC 8878 codec (numpy, pure Python): frame headers, the
literals and sequences sections, FSE and Huffman tables, XXH64, the
decode-acceleration sidecar, and the host compressor and decoder."""
