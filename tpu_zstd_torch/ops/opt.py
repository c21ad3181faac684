"""K10: segment-local optimal parse, the BTOPT-style backward DP (CUDA
kernel + plain PyTorch version).

Counterpart of tpu_zstd/ops/pallas_opt.py `opt_steps`; the kernel is
csrc/opt.cu. For each segment row of `seg` positions, walking backward,

    cost[p] = min( lit + cost[p+1],
                   min_{l in [mm, ml_p]}  mc_p  + MLC[l] + cost[p+l],
                   min_{l in [mm, ml2_p]} mc2_p + MLC[l] + cost[p+l] )

with costs past the segment end 0. Input per position, int32:
ml | ofc << 7 | ml2 << 12 | ofc2 << 19 (ml, ml2 <= 127; ofc <= 31,
ofc2 <= 15); mc = bank[ofc] + ofc * SCALE, MLC[l] = bank[32 + l - mm].
Prices are in SCALE units (1/16 bit). Lengths are tried in increasing
order and only a strictly smaller cost replaces the best, so a literal or a
shorter length wins a tie. Output: the chosen step per position (1 = a
literal, else the match length taken), int32.

Each segment row reads its own row of `lit_bits` and of `cost_bank`, as the
JAX package's CPU twin `_opt_scan` does (its TPU kernel reads one bank row
per 128 segment rows; the two agree where every block has a multiple of 128
segments).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _kernels

LANES = 128
SCALE = 16          # fixed-point cost unit: 1/16 bit
LIT_BITS = 6        # default per-literal price when no bank is supplied
MATCH_BASE = 11     # flat LL+ML+OF symbol price (the default bank)
BIG = 1 << 28


def _mlx(l: int) -> int:
    """Match-length extra bits for length l (RFC 8878 ML code table shape)."""
    if l <= 34:
        return 0
    if l <= 38:
        return 1
    if l <= 46:
        return 2
    if l <= 62:
        return 3
    return 4


def default_cost_bank(mm: int, cap: int) -> np.ndarray:
    """Flat-model bank row (128,) int32: OF-symbol cost at lanes [0, 32) and
    per-length match cost at lanes [32, 32 + cap - mm] (both without the
    offset extra bits, which come per position from the packed ofc)."""
    bank = np.zeros(LANES, np.int32)
    bank[:32] = (MATCH_BASE - 4) * SCALE
    for l in range(mm, cap + 1):
        bank[32 + l - mm] = 4 * SCALE + _mlx(l) * SCALE
    return bank


def _operands(packed, mm: int, cap: int, lit_bits, cost_bank):
    """Per-row literal prices (S,) and banks (S, 128), int32 and contiguous
    on packed's device, with the JAX package's defaults and broadcasts."""
    if packed.dim() != 2:
        raise ValueError(f"opt_steps: packed must be (S, seg), got {tuple(packed.shape)}")
    if not (1 <= mm <= cap <= 127 and 32 + cap - mm < LANES):
        raise ValueError(f"opt_steps: mm {mm} / cap {cap} out of range")
    S = packed.shape[0]
    dev = packed.device
    if lit_bits is None:
        lit_bits = torch.tensor(LIT_BITS * SCALE)
    if cost_bank is None:
        cost_bank = torch.as_tensor(default_cost_bank(mm, cap))
    lit_bits = torch.broadcast_to(lit_bits.to(device=dev, dtype=torch.int32), (S,))
    cost_bank = torch.broadcast_to(cost_bank.to(device=dev, dtype=torch.int32), (S, LANES))
    return lit_bits.contiguous(), cost_bank.contiguous()


def opt_steps_plain(packed: torch.Tensor, mm: int, cap: int,
                    lit_bits: torch.Tensor | None = None,
                    cost_bank: torch.Tensor | None = None) -> torch.Tensor:
    """The DP of `_opt_scan`, one backward step per segment position,
    vectorised over rows and over lengths: a (S, cap + 1) window holds
    cost[p + 1 .. p + 1 + cap], and the first strict minimum over lengths in
    increasing order replaces the literal only when strictly cheaper. Costs
    are int32 and wrap, as `_opt_scan`'s do."""
    lit, bank = _operands(packed, mm, cap, lit_bits, cost_bank)
    S, seg = packed.shape
    dev = packed.device
    x = packed.to(torch.int32).T  # (seg, S)
    ml, ofc = x & 127, (x >> 7) & 31
    ml2, ofc2 = (x >> 12) & 127, (x >> 19) & 15
    mc = bank.gather(1, ofc.T.long()).T + ofc * SCALE
    mc2 = bank.gather(1, ofc2.T.long()).T + ofc2 * SCALE
    L = torch.arange(mm, cap + 1, device=dev)
    mlc = bank[:, 32 + L - mm]  # (S, nl)
    window = torch.zeros((S, cap + 1), dtype=torch.int32, device=dev)
    steps = torch.empty((seg, S), dtype=torch.int32, device=dev)
    for p in range(seg - 1, -1, -1):
        ahead = mlc + window[:, L - 1]
        c = torch.minimum(
            torch.where(ml[p][:, None] >= L, mc[p][:, None] + ahead, BIG),
            torch.where(ml2[p][:, None] >= L, mc2[p][:, None] + ahead, BIG),
        )
        cmin, arg = c.min(dim=1)
        best = lit + window[:, 0]
        take = cmin < best
        steps[p] = torch.where(take, L[arg], 1)
        window = torch.cat([torch.where(take, cmin, best)[:, None], window[:, :-1]], dim=1)
    return steps.T.contiguous()


def opt_steps(packed: torch.Tensor, mm: int, cap: int,
              lit_bits: torch.Tensor | None = None,
              cost_bank: torch.Tensor | None = None,
              stats: torch.Tensor | None = None) -> torch.Tensor:
    """DP over (S, seg) int32 packed segments -> (S, seg) int32 chosen steps.

    lit_bits: per-row literal price in SCALE units (a scalar broadcasts;
    default LIT_BITS * SCALE). cost_bank: per-row (128,) bank (one row
    broadcasts; default `default_cost_bank`). CPU tensors take the plain
    version; CUDA tensors launch the kernel. stats, an (S,) int32 CUDA
    tensor, gets per row 1 where the kernel walked it on its fast path (every
    price of its warp's rows in [0, 2^12), seg <= 1024), else 0.
    """
    if packed.device.type == "cpu":
        if stats is not None:
            raise ValueError("opt_steps: stats are counted by the CUDA kernel only")
        return opt_steps_plain(packed, mm, cap, lit_bits, cost_bank)
    lit_bits, bank = _operands(packed, mm, cap, lit_bits, cost_bank)
    _kernels.check_cuda(packed, torch.int32, "opt_steps packed")
    S, seg = packed.shape
    if stats is not None:
        _kernels.check_cuda(stats, torch.int32, "opt_steps stats")
        if stats.shape != (S,):
            raise ValueError(f"opt_steps: stats {tuple(stats.shape)} for {S} rows")
    out = torch.empty((S, seg), dtype=torch.int32, device=packed.device)
    if packed.numel() == 0:
        return out
    _kernels.launch("opt", "tz_opt_steps", packed.data_ptr(), lit_bits.data_ptr(),
                    bank.data_ptr(), out.data_ptr(),
                    None if stats is None else stats.data_ptr(), S, seg, mm, cap)
    return out
