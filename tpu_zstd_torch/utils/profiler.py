"""Performance profiler: named stage timers and throughput accounting.

Counterpart of tpu_zstd/utils/profiler.py: a process-wide profiler
(`get_profiler()`), off until `enable()`, that times named stages
(`start` / `stop`, or the `scope` context manager) and reports calls, total
ms and MB/s per stage. CUDA work is asynchronous, so `scope(sync=tree)`
synchronises the device of every CUDA tensor in `tree` (tensors in nested
tuples, lists and dicts) before it stops the timer.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass

import torch


@dataclass
class StageMetrics:
    calls: int = 0
    total_s: float = 0.0
    bytes_processed: int = 0

    @property
    def throughput_mbps(self) -> float:
        return self.bytes_processed / self.total_s / 1e6 if self.total_s else 0.0


def _cuda_devices(tree) -> set:
    """The CUDA devices of the tensors in a tree of tuples, lists and dicts."""
    if torch.is_tensor(tree):
        return {tree.device} if tree.device.type == "cuda" else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return set().union(*(_cuda_devices(t) for t in tree)) if tree else set()
    return set()


class PerformanceProfiler:
    """Process-wide named stage profiler (enable() to activate)."""

    _instance: "PerformanceProfiler | None" = None

    def __init__(self) -> None:
        self.enabled = False
        self.stages: dict[str, StageMetrics] = defaultdict(StageMetrics)
        self._open: dict[str, float] = {}

    @classmethod
    def instance(cls) -> "PerformanceProfiler":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        self.stages.clear()
        self._open.clear()

    def start(self, name: str) -> None:
        if self.enabled:
            self._open[name] = time.perf_counter()

    def stop(self, name: str, nbytes: int = 0) -> float:
        if not self.enabled or name not in self._open:
            return 0.0
        dt = time.perf_counter() - self._open.pop(name)
        m = self.stages[name]
        m.calls += 1
        m.total_s += dt
        m.bytes_processed += nbytes
        return dt

    @contextlib.contextmanager
    def scope(self, name: str, nbytes: int = 0, sync=None):
        """Timed scope; `sync=` a tree of tensors whose CUDA devices are
        synchronised before the timer stops."""
        self.start(name)
        try:
            yield
        finally:
            for dev in _cuda_devices(sync):
                torch.cuda.synchronize(dev)
            self.stop(name, nbytes)

    def report(self) -> dict:
        return {
            name: {
                "calls": m.calls,
                "total_ms": round(m.total_s * 1e3, 3),
                "throughput_MBps": round(m.throughput_mbps, 2),
            }
            for name, m in sorted(self.stages.items())
        }

    def print_summary(self) -> None:
        for name, row in self.report().items():
            print(f"{name:32s} {row['calls']:6d} calls {row['total_ms']:10.2f} ms "
                  f"{row['throughput_MBps']:10.2f} MB/s")

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=2)

    def export_csv(self, path: str) -> None:
        with open(path, "w") as f:
            f.write("stage,calls,total_ms,throughput_MBps\n")
            for name, row in self.report().items():
                f.write(f"{name},{row['calls']},{row['total_ms']},{row['throughput_MBps']}\n")


def get_profiler() -> PerformanceProfiler:
    return PerformanceProfiler.instance()
