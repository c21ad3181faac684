"""Batch sharding over the ranks of a `torch.distributed` group.

Counterpart of tpu_zstd/parallel/sharding.py. Blocks compress
independently, so a (B, N) batch splits into contiguous rows, one share a
rank, each compressed on its rank's own device with `compress_blocks_staged`
and no collective; the variable-length outputs are then gathered in rank
order in two steps, as the reference gathers them across processes: the
per-block lengths and types first (small), then the contents trimmed to the
smallest power-of-two width (at least 64) that covers the longest block,
padded back to N on arrival. Every rank returns the same host arrays.

Without an initialised process group the mesh is this process alone and
nothing is gathered.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops.pipeline import DEFAULT_CONFIG, PipelineConfig, compress_blocks_staged, resolve_device


@dataclass(frozen=True)
class BatchMesh:
    """A 1-D mesh over the ranks of the default process group: the axis
    name, this rank, the number of ranks, this rank's device, and whether
    a process group carries the gather."""

    axis: str
    rank: int
    size: int
    device: torch.device
    distributed: bool


def make_mesh(num_devices: int | None = None, axis: str = "batch", device=None) -> BatchMesh:
    """The mesh over every rank of the default group (one rank without an
    initialised group). `device` is this rank's device: None means CUDA,
    card rank % device_count, and raises without a card. num_devices, where
    given, must equal the group's size."""
    distributed = dist.is_available() and dist.is_initialized()
    size = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    if num_devices is not None and num_devices != size:
        raise ValueError(f"a mesh spans every rank of the group: {num_devices} != {size}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return BatchMesh(axis, rank, size, dev, distributed)


def _gather_rows(t: torch.Tensor, mesh: BatchMesh) -> np.ndarray:
    """The ranks' equal-shaped `t` stacked in rank order along dim 0, on the
    host (NCCL gathers on the card, other backends on the CPU)."""
    on = mesh.device if dist.get_backend() == "nccl" else torch.device("cpu")
    t = t.to(on).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def compress_blocks_sharded(blocks: np.ndarray, lengths: np.ndarray,
                            cfg: PipelineConfig = DEFAULT_CONFIG, mesh: BatchMesh | None = None):
    """Compress a (B, N) uint8 block batch split over the mesh's ranks.

    Every rank passes the same full batch; B is padded to a multiple of the
    mesh size with zero-length rows. Returns host numpy (contents (B, N)
    uint8, content lengths (B,), block types (B,)), the same on every rank."""
    mesh = mesh or make_mesh()
    B, N = blocks.shape
    per = -(-max(B, 1) // mesh.size)
    pad = per * mesh.size - B
    if pad:
        blocks = np.concatenate([blocks, np.zeros((pad, N), blocks.dtype)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    lo = mesh.rank * per
    rows = torch.from_numpy(np.array(blocks[lo : lo + per], np.uint8)).to(mesh.device)
    lens = torch.from_numpy(np.array(lengths[lo : lo + per], np.int32)).to(mesh.device)
    contents, clens, btypes = compress_blocks_staged(rows, lens, cfg)
    if not mesh.distributed:
        return contents.cpu().numpy()[:B], clens.cpu().numpy()[:B], btypes.cpu().numpy()[:B]
    clens_h = _gather_rows(clens, mesh)
    btypes_h = _gather_rows(btypes, mesh)
    mx = int(clens_h[:B].max()) if B else 1
    bucket = 64
    while bucket < mx:
        bucket *= 2
    bucket = min(bucket, N)
    contents_h = _gather_rows(contents[:, :bucket], mesh)
    if bucket < N:
        contents_h = np.concatenate(
            [contents_h, np.zeros((contents_h.shape[0], N - bucket), contents_h.dtype)], axis=1)
    return contents_h[:B], clens_h[:B], btypes_h[:B]
