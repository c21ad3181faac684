"""K3: exact greedy / 1-step-lazy parse walk per segment (CUDA kernel +
plain PyTorch version).

Counterpart of tpu_zstd/ops/pallas_greedy.py `greedy_segments`; the kernel
is csrc/greedy.cu. Input (S, seg) int32 rows packed as
step | matched << 11 | defer << 12; output (S, seg) uint8 take | is_lit << 1.
"""

from __future__ import annotations

import torch

from . import _kernels


def greedy_segments_plain(packed: torch.Tensor) -> torch.Tensor:
    """The sequential walk of tpu_zstd/ops/lz77_jax.py `greedy_parse`, one
    loop step per segment position, vectorised over segments."""
    S, seg = packed.shape
    x = packed.to(torch.int64).T.contiguous()  # (seg, S): one row per step
    stp = x & (2 * seg - 1)
    m = ((x >> 11) & 1) == 1
    d = ((x >> 12) & 1) == 1
    na = torch.zeros(S, dtype=torch.int64, device=packed.device)
    me = torch.zeros_like(na)
    out = torch.empty((seg, S), dtype=torch.uint8, device=packed.device)
    for p in range(seg):
        is_pp = na == p
        take = is_pp & m[p] & ~d[p]
        adv = torch.where(take, stp[p], 1)
        me = torch.where(take, p + stp[p], me)
        na = torch.where(is_pp, p + adv, na)
        is_lit = me <= p
        out[p] = take.to(torch.uint8) | (is_lit.to(torch.uint8) << 1)
    return out.T.contiguous()


def greedy_segments(packed: torch.Tensor) -> torch.Tensor:
    """Greedy walk over (S, seg) packed segments; requires seg <= 1024 and
    step <= seg. CPU tensors take the plain version."""
    S, seg = packed.shape
    if seg > 1024:
        raise ValueError(f"greedy_segments: seg {seg} > 1024")
    if packed.device.type == "cpu":
        return greedy_segments_plain(packed)
    _kernels.check_cuda(packed, torch.int32, "greedy_segments packed")
    out = torch.empty((S, seg), dtype=torch.uint8, device=packed.device)
    if packed.numel() == 0:
        return out
    _kernels.launch("greedy", "tz_greedy_segments", packed.data_ptr(), out.data_ptr(), S, seg)
    return out
