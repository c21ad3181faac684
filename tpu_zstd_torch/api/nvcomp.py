"""nvCOMP-v5-style batch interface: a chunked container with metadata.

Counterpart of tpu_zstd/api/nvcomp.py, with the same container:

  [skippable frame: magic 0x184D2A55, size, {version 1, chunk count,
   per chunk <QQ uncompressed and compressed size}]
  [zstd frame of chunk 0] [zstd frame of chunk 1] ...

Stock libzstd decodes the whole container (skippable frames are skipped by
the spec), and `decompress_chunk` reads one chunk at random. The chunks
compress in one device batch (`compress_items`) on the manager's device
(None means CUDA; raises without it); decompression runs on the host
decoder. The temp-size queries return 0: the caching allocator owns device
memory.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..constants import SKIPPABLE_MAGIC_MIN
from ..ops.pipeline import resolve_device
from .config import CompressionConfig, Status, estimate_compressed_size
from .manager import _decompress_host, compress_items

_META_VERSION = 1
_META_MAGIC = SKIPPABLE_MAGIC_MIN | 0x5  # 0x184D2A55, one of the 16 skippable magics


@dataclass
class NvcompMetadata:
    version: int
    chunk_count: int
    uncompressed_sizes: list[int]
    compressed_sizes: list[int]

    @property
    def total_uncompressed(self) -> int:
        return sum(self.uncompressed_sizes)


class NvcompV5BatchManager:
    """Chunk-array batch compression into one self-describing container."""

    def __init__(self, level: int = 3, config: CompressionConfig | None = None, device=None):
        self.config = config or CompressionConfig.from_level(level)
        self.device = resolve_device(device)

    # -- capacity queries ------------------------------------------------------
    def get_compress_temp_size(self, chunk_count: int, max_chunk_size: int) -> int:
        return 0

    def get_max_compressed_chunk_size(self, max_chunk_size: int) -> int:
        return estimate_compressed_size(max_chunk_size)

    def get_decompress_temp_size(self, chunk_count: int, max_chunk_size: int) -> int:
        return 0

    # -- compress -------------------------------------------------------------
    def compress(self, chunks: list[bytes]) -> bytes:
        return self.compress_async(chunks)()

    def compress_async(self, chunks: list[bytes]):
        """Compress now; the returned zero-argument resolver joins the
        container."""
        frames = compress_items([bytes(c) for c in chunks], self.config, device=self.device)

        def resolve() -> bytes:
            meta = self._build_metadata_frame([len(c) for c in chunks], [len(f) for f in frames])
            return meta + b"".join(frames)

        return resolve

    # -- decompress -----------------------------------------------------------
    def decompress(self, container: bytes) -> list[bytes]:
        meta, pos = self.get_metadata(container)
        out = []
        for usize, csize in zip(meta.uncompressed_sizes, meta.compressed_sizes):
            frame = container[pos : pos + csize]
            out.append(_decompress_host(frame, max_output_size=max(usize, 1)))
            pos += csize
        return out

    def decompress_chunk(self, container: bytes, index: int) -> bytes:
        """One chunk, read at random."""
        meta, pos = self.get_metadata(container)
        if not (0 <= index < meta.chunk_count):
            raise IndexError(index)
        pos += sum(meta.compressed_sizes[:index])
        frame = container[pos : pos + meta.compressed_sizes[index]]
        return _decompress_host(frame, max_output_size=max(meta.uncompressed_sizes[index], 1))

    # -- metadata -------------------------------------------------------------
    @staticmethod
    def _build_metadata_frame(usizes: list[int], csizes: list[int]) -> bytes:
        payload = struct.pack("<II", _META_VERSION, len(usizes))
        payload += b"".join(struct.pack("<QQ", u, c) for u, c in zip(usizes, csizes))
        return struct.pack("<II", _META_MAGIC, len(payload)) + payload

    @staticmethod
    def get_metadata(container: bytes) -> tuple[NvcompMetadata, int]:
        """The metadata frame: (metadata, offset of the first chunk)."""
        if len(container) < 8:
            raise ValueError("container too small")
        magic, size = struct.unpack_from("<II", container, 0)
        if magic != _META_MAGIC:
            raise ValueError(f"not an nvcomp-style container (magic 0x{magic:08X})")
        payload = container[8 : 8 + size]
        version, count = struct.unpack_from("<II", payload, 0)
        if version != _META_VERSION:
            raise ValueError(f"unsupported container version {version}")
        usizes, csizes = [], []
        off = 8
        for _ in range(count):
            u, c = struct.unpack_from("<QQ", payload, off)
            usizes.append(u)
            csizes.append(c)
            off += 16
        return NvcompMetadata(version, count, usizes, csizes), 8 + size

    @staticmethod
    def status_to_nvcomp_error(status: Status) -> int:
        """Status -> nvCOMP error code (5 for any other status)."""
        table = {
            Status.SUCCESS: 0,
            Status.ERROR_INVALID_PARAMETER: 1,
            Status.ERROR_OUT_OF_MEMORY: 2,
            Status.ERROR_CORRUPT_DATA: 3,
            Status.ERROR_BUFFER_TOO_SMALL: 4,
        }
        return table.get(status, 5)
