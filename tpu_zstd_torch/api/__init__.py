"""User-facing surface of the port: configuration, status codes, the
managers (the streaming compressor too) and the decoders (the counterpart
of tpu_zstd/api, less the hybrid engine)."""

from .config import (
    ChecksumPolicy,
    CompressionConfig,
    CompressionStats,
    ExecutionPath,
    Status,
    Strategy,
    estimate_compressed_size,
)
from .decompress import (
    DecompressPlan,
    decompress_batch_to_device,
    decompress_batch_tpu,
    prepare_decompress_batch,
)
from .manager import (
    BatchItem,
    BatchManager,
    Manager,
    StreamingDecompressor,
    StreamingManager,
    compress_items,
)

__all__ = [
    "BatchItem",
    "BatchManager",
    "ChecksumPolicy",
    "CompressionConfig",
    "CompressionStats",
    "DecompressPlan",
    "ExecutionPath",
    "Manager",
    "Status",
    "Strategy",
    "StreamingDecompressor",
    "StreamingManager",
    "compress_items",
    "decompress_batch_to_device",
    "decompress_batch_tpu",
    "estimate_compressed_size",
    "prepare_decompress_batch",
]
