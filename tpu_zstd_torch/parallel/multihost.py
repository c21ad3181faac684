"""Batch compression across the ranks of a `torch.distributed` group.

Counterpart of tpu_zstd/parallel/multihost.py. `initialize` wraps
`torch.distributed.init_process_group` (NCCL where CUDA is available, else
gloo; nothing to do where a group exists or no init_method is given).
`compress_batch_distributed` splits every item into blocks, compresses the
batch with `compress_blocks_sharded` and joins each item's frame on every
rank, in item order, with the manager's join. At world size 1 it delegates
to the local batch (`compress_items` at level 3 with the config's block
size), exactly where the reference delegates.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..api.config import CompressionConfig
from ..api.manager import _assemble_python, compress_items
from ..ops.pipeline import DEFAULT_CONFIG, PipelineConfig
from .sharding import compress_blocks_sharded, make_mesh


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None) -> None:
    """Join the process group at init_method (e.g. tcp://localhost:<port>)
    as `rank` of `world_size`; a no-op where a group exists or no
    init_method is given."""
    if init_method is None or (dist.is_available() and dist.is_initialized()):
        return
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)


def compress_batch_distributed(items: list[bytes], cfg: PipelineConfig = DEFAULT_CONFIG,
                               checksum: bool = False, device=None) -> list[bytes]:
    """Compress items across every rank of the group; every rank passes the
    same items and returns every frame, in item order. `device` is this
    rank's device (None means CUDA; raises without it)."""
    mesh = make_mesh(device=device)
    ccfg = CompressionConfig.from_level(3)
    ccfg.block_size = cfg.block_size
    if mesh.size == 1:
        return compress_items(items, ccfg, device=mesh.device)

    N = cfg.block_size
    spans = []
    rows = []
    lens = []
    for data in items:
        n = len(data)
        nb = max(1, -(-n // N))
        spans.append((len(rows), nb))
        arr = np.frombuffer(data, np.uint8)
        for b in range(nb):
            chunk = arr[b * N : min((b + 1) * N, n)]
            buf = np.zeros(N, np.uint8)
            buf[: len(chunk)] = chunk
            rows.append(buf)
            lens.append(len(chunk))
    blocks = np.stack(rows) if rows else np.zeros((1, N), np.uint8)
    lengths = np.asarray(lens if lens else [0], np.int32)
    contents, clens, btypes = compress_blocks_sharded(blocks, lengths, cfg, mesh)

    return _assemble_python(items, spans, contents, clens, btypes, lengths, ccfg, checksum)
