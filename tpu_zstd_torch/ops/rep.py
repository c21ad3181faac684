"""K4: exact repeat-offset (repcode) assignment (CUDA kernel + plain version).

Counterpart of tpu_zstd/ops/pallas_rep.py `rep_codes` (step `_rep_step`,
reference scan `rep_codes_scan`); the kernel is csrc/rep.cu, the plain
version a host loop over Python integers (a loop of tensor ops took seconds
per 16 KB block on the CPU). The kernel walks chunks of each block's rows in
parallel from an unknown state and fixes them up exactly. Input per sequence
row, int32: off | has_lit << 21 | valid << 22. Output: offset-base value
(1..3 for a repcode, off + 3 otherwise), 0 on invalid rows. The 3-entry
history starts all zero with every entry unknown: blocks are compressed
independently, so only offsets established inside the block may be named by
repcode.
"""

from __future__ import annotations

import torch

from . import _kernels

M21 = (1 << 21) - 1


def rep_codes_plain(packed: torch.Tensor) -> torch.Tensor:
    """Sequential walk of the repcode rule over the rows of packed (S, rows),
    one block at a time on the host (Python integers), returned on packed's
    device. Rows with valid == 0 give 0 and keep the history. The same walk
    as the JAX package's `_rep_step` scan and csrc/rep.cu."""
    S, rows = packed.shape
    out = [[0] * rows for _ in range(S)]
    for s, row in enumerate(packed.cpu().tolist()):
        o = out[s]
        v0 = v1 = v2 = 0
        k0 = k1 = k2 = False
        for t, x in enumerate(row):
            if not (x >> 22) & 1:
                continue
            off = x & M21
            ll = (x >> 21) & 1
            h0 = k0 and off == v0
            h1 = k1 and off == v1
            h2 = k2 and off == v2
            hm1 = k0 and off == v0 - 1 and off != 0  # ll == 0 repcode 3
            if ll:
                o[t] = 1 if h0 else 2 if h1 else 3 if h2 else off + 3
            else:
                o[t] = 1 if h1 else 2 if h2 else 3 if hm1 else off + 3
            # History update, in the host rule's priority order.
            if ll and h0:
                continue
            swap = (not h0 and h1) if ll else h1
            rot = (not h0 and not h1 and h2) if ll else (not h1 and h2)
            n0, nk0 = (v1, k1) if swap else (v2, k2) if rot else (off, True)
            if not swap:
                v2, k2 = v1, k1
            v1, k1 = v0, k0
            v0, k0 = n0, nk0
    return torch.tensor(out, dtype=torch.int32, device=packed.device).reshape(S, rows)


def rep_codes(packed: torch.Tensor, stats: torch.Tensor | None = None) -> torch.Tensor:
    """Offset-base values for (S, rows) packed per-block sequence lists.
    CPU tensors take the plain version. stats, an (S, 5) int32 CUDA tensor,
    takes the kernel's counters per block: chunks, chunks whose re-walk
    reached the chunk's end without meeting its earlier walk, fix-up rounds,
    rows re-walked, tiles finished by one thread after 16 rounds."""
    if packed.device.type == "cpu":
        if stats is not None:
            raise ValueError("rep_codes: stats are counted by the CUDA kernel only")
        return rep_codes_plain(packed)
    _kernels.check_cuda(packed, torch.int32, "rep_codes packed")
    S, rows = packed.shape
    if stats is not None:
        _kernels.check_cuda(stats, torch.int32, "rep_codes stats")
        if stats.shape != (S, 5):
            raise ValueError(f"rep_codes: stats {tuple(stats.shape)} for {S} blocks")
    out = torch.empty((S, rows), dtype=torch.int32, device=packed.device)
    if packed.numel() == 0:
        return out
    _kernels.launch("rep", "tz_rep_codes", packed.data_ptr(), out.data_ptr(),
                    None if stats is None else stats.data_ptr(), S, rows)
    return out
