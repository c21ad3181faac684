"""HybridEngine: routing between the host and the card, with profiling
feedback.

Counterpart of tpu_zstd/api/hybrid.py: `decide_route` is the reference's
matrix with its reasons (forced modes; device-resident data on the card;
host-bound decode on the CPU; host buffers from `tpu_batch_threshold` up on
the card), and ADAPTIVE keeps a rolling MB/s history per backend and
switches to the card when its average beats the CPU's by the hysteresis
(1.2x), falling through to AUTO until both backends have samples.

Where the port differs by design:
- the CPU backend is the native engine (utils/native.py
  `NativeEngine.create(level)`), the engine the reference's own `Manager`
  takes for its host route; the reference's is libzstd (`zstandard`), which
  the card's machine does not have. Where no C++ compiler exists it is the
  pure-Python host codec. The enum keeps the reference's name,
  `Backend.CPU_LIBZSTD`;
- `detect_location`: a CUDA `torch.Tensor` is DEVICE; a CPU tensor, bytes,
  bytearray, memoryview or numpy array is HOST;
- the engine resolves its device when made (None means CUDA, and it raises
  without a card), even where an input then takes the host route;
- no fallback hides the card or a kernel: the reference decodes on the host
  after any exception of its device decode. Here only a ValueError raised
  while the host parses the frames, before any launch, sends an input to the
  host decoder; every error after that propagates.
"""

from __future__ import annotations

import enum
import struct
import time
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.pipeline import resolve_device
from .config import CompressionConfig


class Backend(enum.IntEnum):
    CPU_LIBZSTD = 0
    TPU_KERNELS = 1


class RoutingMode(enum.IntEnum):
    AUTO = 0
    FORCE_CPU = 1
    FORCE_TPU = 2
    ADAPTIVE = 3


class DataLocation(enum.IntEnum):
    UNKNOWN = 0
    HOST = 1
    DEVICE = 2


@dataclass
class HybridConfig:
    """Routing thresholds."""

    mode: RoutingMode = RoutingMode.AUTO
    tpu_batch_threshold: int = 4 << 20   # host-resident data below this -> CPU
    tpu_device_threshold: int = 64 << 10  # device-resident data >= this -> the card
    adaptive_history: int = 16
    adaptive_hysteresis: float = 1.2
    enable_profiling: bool = True
    level: int = 3


@dataclass
class HybridResult:
    """Per-call breakdown."""

    backend: Backend = Backend.CPU_LIBZSTD
    routing_reason: str = ""
    total_time_s: float = 0.0
    compute_time_s: float = 0.0
    transfer_time_s: float = 0.0
    input_size: int = 0
    output_size: int = 0

    @property
    def throughput_mbps(self) -> float:
        return self.input_size / self.total_time_s / 1e6 if self.total_time_s else 0.0


def detect_location(data) -> DataLocation:
    """DEVICE for a CUDA tensor; HOST for a CPU tensor, bytes, bytearray,
    memoryview or numpy array; else UNKNOWN."""
    if isinstance(data, torch.Tensor):
        return DataLocation.DEVICE if data.device.type == "cuda" else DataLocation.HOST
    if isinstance(data, (bytes, bytearray, memoryview, np.ndarray)):
        return DataLocation.HOST
    return DataLocation.UNKNOWN


class HybridEngine:
    """Routes each call to the host engine or the card's pipeline, on
    `device` (None means CUDA; raises without it)."""

    def __init__(self, config: HybridConfig | None = None,
                 compression: CompressionConfig | None = None, device=None):
        self.config = config or HybridConfig()
        self.compression = compression or CompressionConfig.from_level(self.config.level)
        self.device = resolve_device(device)
        self._history: dict[Backend, deque[float]] = {
            Backend.CPU_LIBZSTD: deque(maxlen=self.config.adaptive_history),
            Backend.TPU_KERNELS: deque(maxlen=self.config.adaptive_history),
        }

    # -- routing --------------------------------------------------------------
    def decide_route(self, size: int, location: DataLocation, is_compress: bool,
                     accel: bool = False) -> tuple[Backend, str]:
        mode = self.config.mode
        if mode == RoutingMode.FORCE_CPU:
            return Backend.CPU_LIBZSTD, "forced CPU"
        if mode == RoutingMode.FORCE_TPU:
            return Backend.TPU_KERNELS, "forced TPU"
        if mode == RoutingMode.ADAPTIVE:
            cpu_avg = self._avg(Backend.CPU_LIBZSTD)
            tpu_avg = self._avg(Backend.TPU_KERNELS)
            if cpu_avg and tpu_avg:
                if tpu_avg > cpu_avg * self.config.adaptive_hysteresis:
                    return (Backend.TPU_KERNELS,
                            f"adaptive: TPU {tpu_avg:.0f} > CPU {cpu_avg:.0f} MB/s")
                return Backend.CPU_LIBZSTD, f"adaptive: CPU {cpu_avg:.0f} MB/s wins"
            # falls through to AUTO until both backends have samples
        if location == DataLocation.DEVICE:
            if size >= self.config.tpu_device_threshold:
                return Backend.TPU_KERNELS, "device-resident data stays on TPU"
            return Backend.TPU_KERNELS, "device-resident small data (avoid transfer)"
        if not is_compress:
            # The card's decoder pays when the output stays on the device
            # (decompress_to_device), which routes explicitly.
            return Backend.CPU_LIBZSTD, "host-bound decode: CPU libzstd wins"
        if size >= self.config.tpu_batch_threshold:
            return Backend.TPU_KERNELS, "large host buffer: TPU batch path"
        return Backend.CPU_LIBZSTD, "small host buffer: CPU faster than transfer"

    def _avg(self, backend: Backend) -> float:
        h = self._history[backend]
        return sum(h) / len(h) if h else 0.0

    # -- operations -----------------------------------------------------------
    def compress(self, data, result: HybridResult | None = None) -> bytes:
        res = result if result is not None else HybridResult()
        t0 = time.perf_counter()
        loc = detect_location(data)
        raw = _to_bytes(data)
        backend, reason = self.decide_route(len(raw), loc, True)
        t1 = time.perf_counter()
        if backend == Backend.CPU_LIBZSTD:
            out = self._cpu_compress(raw)
        else:
            out = self._tpu_compress(raw)
        t2 = time.perf_counter()
        res.backend, res.routing_reason = backend, reason
        res.transfer_time_s = t1 - t0
        res.compute_time_s = t2 - t1
        res.total_time_s = t2 - t0
        res.input_size, res.output_size = len(raw), len(out)
        if self.config.enable_profiling and res.total_time_s > 0:
            self._history[backend].append(len(raw) / res.total_time_s / 1e6)
        return out

    def decompress(self, data, max_output_size: int | None = None,
                   result: HybridResult | None = None) -> bytes:
        """Routed decompression: on the card, single-block frames through
        the prepared plan (`decompress_batch_to_device`, chunk-parallel for
        decode_accel frames), frames the plan refuses through
        `decompress_batch_tpu`; on the host, the port's decoder. A frame
        whose host parse fails (ValueError, before any launch) takes the
        host decoder."""
        from .manager import _decompress_host

        res = result if result is not None else HybridResult()
        t0 = time.perf_counter()
        loc = detect_location(data)
        raw = _to_bytes(data)
        backend, reason = self.decide_route(len(raw), loc, False, accel=_has_accel_meta(raw))
        out = None
        if backend == Backend.TPU_KERNELS:
            out = self._tpu_decompress(raw)
            if out is None:
                backend, reason = Backend.CPU_LIBZSTD, "TPU decode failed: CPU fallback"
        if out is None:
            out = _decompress_host(raw, max_output_size)
        res.backend, res.routing_reason = backend, reason
        res.total_time_s = res.compute_time_s = time.perf_counter() - t0
        res.input_size, res.output_size = len(raw), len(out)
        if self.config.enable_profiling and res.total_time_s > 0:
            self._history[backend].append(len(out) / res.total_time_s / 1e6)
        return out

    def compress_batch(self, items: list) -> list[bytes]:
        from .manager import compress_items

        raws = [_to_bytes(d) for d in items]
        backend, _ = self.decide_route(sum(map(len, raws)), DataLocation.HOST, True)
        if backend == Backend.TPU_KERNELS:
            return compress_items(raws, self.compression, device=self.device)
        return [self._cpu_compress(r) for r in raws]

    def decompress_batch(self, items: list) -> list[bytes]:
        """Batched routed decompression: on the card one
        `decompress_batch_tpu` of the batch (its host parse failing with a
        ValueError sends the batch to the host decoder), else item by item
        on the host."""
        from .decompress import decode_parsed, parse_batch
        from .manager import _decompress_host

        raws = [_to_bytes(d) for d in items]
        accel = all(_has_accel_meta(r) for r in raws) if raws else False
        backend, _ = self.decide_route(sum(map(len, raws)), DataLocation.HOST, False,
                                       accel=accel)
        if backend == Backend.TPU_KERNELS and raws:
            try:
                parsed = parse_batch(raws)
            except ValueError:
                parsed = None
            if parsed is not None:
                return decode_parsed(parsed, device=self.device)
        return [_decompress_host(r, None) for r in raws]

    def decompress_to_device(self, items: list, max_block: int = 128 * 1024):
        """Decompress a batch into rows on the engine's device ((out,
        lengths), see api/decompress.py `decompress_batch_to_device`).
        Always the card."""
        from .decompress import decompress_batch_to_device

        return decompress_batch_to_device([_to_bytes(d) for d in items], max_block,
                                          device=self.device)

    # -- backends -------------------------------------------------------------
    def _cpu_compress(self, data: bytes) -> bytes:
        """The native engine at the configured level (`host_compress`)."""
        from .manager import host_compress

        return host_compress(data, self.compression)

    def _tpu_compress(self, data: bytes) -> bytes:
        from .manager import compress_items

        return compress_items([data], self.compression, device=self.device)[0]

    def _tpu_decompress(self, raw: bytes) -> bytes | None:
        """The prepared plan where it takes the frame; else
        `decompress_batch_tpu`; None where the host parse of both refuses it
        (a ValueError before any launch)."""
        from .decompress import decode_parsed, parse_batch, prepare_decompress_batch

        try:
            plan = prepare_decompress_batch([raw], device=self.device)
        except ValueError:
            plan = None
        if plan is not None:
            out, lens = plan.execute()
            return bytes(out[0, : int(lens[0])].cpu().numpy())
        try:
            parsed = parse_batch([raw])
        except ValueError:
            return None
        return decode_parsed(parsed, device=self.device)[0]


def _has_accel_meta(frame: bytes) -> bool:
    """True when the frame carries decode-acceleration checkpoints."""
    from ..format.accel import parse_accel_tail

    try:
        return parse_accel_tail(frame)[0] is not None
    except (ValueError, struct.error):  # an unreadable tail carries no checkpoints
        return False


def _to_bytes(data) -> bytes:
    if isinstance(data, bytes):
        return data
    if isinstance(data, (bytearray, memoryview)):
        return bytes(data)
    if isinstance(data, np.ndarray):
        return data.astype(np.uint8, copy=False).tobytes()
    if isinstance(data, torch.Tensor):
        return data.detach().to(device="cpu", dtype=torch.uint8).contiguous().numpy().tobytes()
    raise TypeError(f"unsupported input type {type(data)}")
