"""K4: exact repeat-offset (repcode) assignment (CUDA kernel + plain PyTorch
version).

Counterpart of tpu_zstd/ops/pallas_rep.py `rep_codes` (step `_rep_step`,
reference scan `rep_codes_scan`); the kernel is csrc/rep.cu. Input per
sequence row, int32: off | has_lit << 21 | valid << 22. Output: offset-base
value (1..3 for a repcode, off + 3 otherwise), 0 on invalid rows. The
3-entry history starts all zero with every entry unknown: blocks are
compressed independently, so only offsets established inside the block may
be named by repcode.
"""

from __future__ import annotations

import torch

from . import _kernels

M21 = (1 << 21) - 1


def _rep_step(x: torch.Tensor, state: tuple):
    """One encode-offset step on (S,) int64 vectors; state = (v0, v1, v2,
    k0, k1, k2) with bool known-flags. Returns (ob, new_state)."""
    v0, v1, v2, k0, k1, k2 = state
    off = x & M21
    ll = ((x >> 21) & 1) == 1
    live = ((x >> 22) & 1) == 1

    h0 = k0 & (off == v0)
    h1 = k1 & (off == v1)
    h2 = k2 & (off == v2)
    hm1 = k0 & (off == v0 - 1) & (off != 0)  # ll == 0 repcode 3

    ob_ll = torch.where(h0, 1, torch.where(h1, 2, torch.where(h2, 3, off + 3)))
    ob_nl = torch.where(h1, 1, torch.where(h2, 2, torch.where(hm1, 3, off + 3)))
    ob = torch.where(ll, ob_ll, ob_nl)

    # History update, in the host rule's priority order.
    unchanged = ll & h0
    swap = (ll & ~h0 & h1) | (~ll & h1)
    rot = (ll & ~h0 & ~h1 & h2) | (~ll & ~h1 & h2)
    n0 = torch.where(unchanged, v0, torch.where(swap, v1, torch.where(rot, v2, off)))
    nk0 = torch.where(unchanged, k0, torch.where(swap, k1, torch.where(rot, k2, True)))
    n1 = torch.where(unchanged, v1, v0)
    nk1 = torch.where(unchanged, k1, k0)
    n2 = torch.where(unchanged | swap, v2, v1)
    nk2 = torch.where(unchanged | swap, k2, k1)

    ob = torch.where(live, ob, 0)
    new_state = tuple(
        torch.where(live, n, o) for n, o in zip((n0, n1, n2, nk0, nk1, nk2), state)
    )
    return ob, new_state


def rep_codes_plain(packed: torch.Tensor) -> torch.Tensor:
    """Sequential walk of `_rep_step` over the rows of packed (S, rows).
    Rows past the last valid one in every block are no-ops (0 out, state
    kept), so the walk stops there."""
    S, rows = packed.shape
    x = packed.to(torch.int64).T.contiguous()
    z = torch.zeros(S, dtype=torch.int64, device=packed.device)
    f = torch.zeros(S, dtype=torch.bool, device=packed.device)
    state = (z, z, z, f, f, f)
    out = torch.zeros((rows, S), dtype=torch.int32, device=packed.device)
    live_rows = torch.nonzero(((x >> 22) & 1).any(dim=1))
    for t in range(int(live_rows.max()) + 1 if live_rows.numel() else 0):
        ob, state = _rep_step(x[t], state)
        out[t] = ob
    return out.T.contiguous()


def rep_codes(packed: torch.Tensor) -> torch.Tensor:
    """Offset-base values for (S, rows) packed per-block sequence lists.
    CPU tensors take the plain version."""
    if packed.device.type == "cpu":
        return rep_codes_plain(packed)
    _kernels.check_cuda(packed, torch.int32, "rep_codes packed")
    S, rows = packed.shape
    out = torch.empty((S, rows), dtype=torch.int32, device=packed.device)
    if packed.numel() == 0:
        return out
    _kernels.launch("rep", "tz_rep_codes", packed.data_ptr(), out.data_ptr(), S, rows)
    return out
