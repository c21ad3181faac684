"""PyTorch + CUDA port of tpu_zstd, a batch Zstandard (RFC 8878) codec.

Sits beside the JAX package `tpu_zstd`, which stays the reference: given the
same `PipelineConfig`, the port emits the same frame bytes. Plain tensor code
is PyTorch; every Pallas TPU kernel on the port's path is a hand-written CUDA
kernel for Hopper (`csrc/`), built at first use. Entry points run on the CUDA
device unless the caller passes `device="cpu"`, where each kernel wrapper runs
its plain PyTorch version instead.

Module map:
  tpu_zstd_torch.format  host-side RFC 8878 codec (numpy, pure Python)
  tpu_zstd_torch.ops     the device pipeline (torch ops and the CUDA kernels)
  tpu_zstd_torch.api     managers, decoders, the hybrid engine, configuration,
                         status codes, adaptive levels, the nvCOMP container
  tpu_zstd_torch.dictionary  dictionary training, compression against one
  tpu_zstd_torch.parallel    batch sharding over torch.distributed
  tpu_zstd_torch.utils   the native host runtime (C++, built at first use),
                         the stage profiler

The one-shot functions below route as the reference's do: `compress` and
`decompress` through `Manager` (inputs under 1 MiB compress on the host,
larger ones on the card; `decompress` decodes on the host),
`compress_batch` and `decompress_batch` through `BatchManager`,
`hybrid_compress` and `hybrid_decompress` through `HybridEngine`. Each
takes `device=None`, meaning CUDA, and raises without it.
"""

from __future__ import annotations

import torch

from .api import (
    Backend,
    BatchItem,
    BatchManager,
    ChecksumPolicy,
    CompressionConfig,
    CompressionStats,
    DataLocation,
    DecompressPlan,
    ExecutionPath,
    HybridConfig,
    HybridEngine,
    HybridResult,
    Manager,
    RoutingMode,
    Status,
    Strategy,
    StreamingDecompressor,
    StreamingManager,
    compress_items,
    decompress_batch_to_device,
    decompress_batch_tpu,
    detect_location,
    estimate_compressed_size,
    prepare_decompress_batch,
)
from .dictionary import (
    CoverParams,
    Dictionary,
    compress_with_dict,
    decompress_with_dict,
    read_dictionary,
    train_dictionary,
    write_structured_dictionary,
)

__version__ = "0.1.0"


def is_cuda_available() -> bool:
    """True when torch sees a CUDA device (the reference's is_tpu_available)."""
    return torch.cuda.is_available()


def compress(data: bytes, level: int = 3, checksum: bool = False, device=None) -> bytes:
    """One-shot compression, routed by size (host codec under 1 MiB)."""
    cfg = CompressionConfig.from_level(level)
    if checksum:
        cfg.checksum = ChecksumPolicy.COMPUTE
    with Manager(config=cfg, device=device) as m:
        return m.compress(data)


def decompress(data: bytes, max_output_size: int | None = None, device=None) -> bytes:
    """One-shot decompression of (concatenated) zstd frames on the host."""
    with Manager(device=device) as m:
        return m.decompress(data, max_output_size)


def compress_batch(items: list[bytes], level: int = 3, device=None) -> list[bytes]:
    """Compress many independent buffers in one device batch."""
    with BatchManager(level=level, device=device) as m:
        return [it.output for it in m.compress_batch(items)]


def decompress_batch(items: list[bytes], device=None) -> list[bytes]:
    """Decompress many frames item by item on the host (None for an item
    that does not decode)."""
    with BatchManager(device=device) as m:
        return [it.output for it in m.decompress_batch(items)]


def hybrid_compress(data, level: int = 3, device=None) -> bytes:
    """Compress with the hybrid engine's routing (host engine or the card)."""
    return HybridEngine(compression=CompressionConfig.from_level(level),
                        device=device).compress(data)


def hybrid_decompress(data, max_output_size: int | None = None, device=None) -> bytes:
    """Decompress with the hybrid engine's routing."""
    return HybridEngine(device=device).decompress(data, max_output_size)


def validate_compressed_data(data: bytes) -> bool:
    """Structural validation on the host: the frames and blocks parse and
    decode and, where a checksum is present, it matches."""
    try:
        from .format.frame import decompress as _dec

        _dec(data, verify_checksum=True)
        return True
    except Exception:
        return False


def get_decompressed_size(data: bytes) -> int | None:
    """The frame header's content size, if recorded."""
    from .format.frame import parse_frame_header

    try:
        return parse_frame_header(data).content_size
    except Exception:
        return None
