"""User-facing surface of the port: configuration, status codes, the
managers (the streaming compressor too), the decoders and the hybrid engine
(the counterpart of tpu_zstd/api; `adaptive` and `nvcomp` are modules of
their own, as in the reference)."""

from .config import (
    ChecksumPolicy,
    CompressionConfig,
    CompressionStats,
    ExecutionPath,
    Status,
    Strategy,
    estimate_compressed_size,
)
from .hybrid import (
    Backend,
    DataLocation,
    HybridConfig,
    HybridEngine,
    HybridResult,
    RoutingMode,
    detect_location,
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
    "Backend",
    "BatchItem",
    "BatchManager",
    "ChecksumPolicy",
    "CompressionConfig",
    "CompressionStats",
    "DataLocation",
    "DecompressPlan",
    "ExecutionPath",
    "HybridConfig",
    "HybridEngine",
    "HybridResult",
    "Manager",
    "RoutingMode",
    "Status",
    "Strategy",
    "StreamingDecompressor",
    "StreamingManager",
    "compress_items",
    "decompress_batch_to_device",
    "decompress_batch_tpu",
    "detect_location",
    "estimate_compressed_size",
    "prepare_decompress_batch",
]
