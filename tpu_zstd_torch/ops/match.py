"""K13: fused window-local match finder (CUDA kernel + plain PyTorch version).

Counterpart of tpu_zstd/ops/pallas_match.py `match_windows`; the kernel is
csrc/match.cu. Per (R, W) window row, with key = hash << log2(W) | pos
(hash == sentinel on dead rows, real hashes below it) and the nwords suffix
words of each position: sort by key, compare each sorted row with its d-th
predecessor for d = 1..depth where both hashes are equal and real, take the
strictly longest match (the smallest offset wins a tie) and return
(ml, off) in position order.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _kernels
from .sort import sort_rows_plain

# The widest window one CTA takes (its keys in registers, 32 a thread over
# 256 threads; the keys and the first two suffix words in 96 KB of shared
# memory).
# Wider windows sort their keys in tiles of that width, merged by merge-path
# passes (csrc/bitonic.cuh) into scratch rows, and a second kernel runs the
# compares.
CTA_WIDTH = 8192


def _word_inc(x: torch.Tensor) -> torch.Tensor:
    """Matched byte count (0..4) from the XOR of two little-endian 4-byte
    words held as int32 (the byte masks read the bits alone)."""
    return torch.where(
        x == 0,
        4,
        ((x & 0xFF) == 0).to(torch.int32)
        + ((x & 0xFFFF) == 0).to(torch.int32)
        + ((x & 0xFFFFFF) == 0).to(torch.int32),
    )


def _check(key: torch.Tensor, depth: int) -> int:
    if key.dim() != 2:
        raise ValueError(f"match_windows: key must be (R, W), got {tuple(key.shape)}")
    W = key.shape[-1]
    if W < 1024 or W & (W - 1):
        raise ValueError(f"match_windows: window width {W} must be a power of two >= 1024")
    if not 0 <= depth < 128:
        raise ValueError(f"match_windows: depth {depth} must be below 128")
    return W.bit_length() - 1


def match_windows_plain(key: torch.Tensor, words: Sequence[torch.Tensor], depth: int,
                        sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The TPU kernel's body in torch: the sort carrying the words, the
    depth compares (the d-th previous sorted row by a roll, masked where the
    row has no d-th predecessor) and the sort back to position order."""
    plog = _check(key, depth)
    W = key.shape[-1]
    sk, *sw = sort_rows_plain(key, *words)
    sh = sk >> plog
    sp = sk & (W - 1)
    my_real = sh < sentinel
    i_flat = torch.arange(W, device=key.device)
    best_ml = torch.zeros_like(sk)
    best_off = torch.zeros_like(sk)
    for d in range(1, depth + 1):
        same = (torch.roll(sh, d, -1) == sh) & my_real & (i_flat >= d)
        pp = torch.roll(sp, d, -1)
        ml = torch.zeros_like(sk)
        alive = same
        for w in sw:
            x = w ^ torch.roll(w, d, -1)
            ml = ml + torch.where(alive, _word_inc(x), 0)
            alive = alive & (x == 0)
        better = ml > best_ml
        best_ml = torch.where(better, ml, best_ml)
        best_off = torch.where(better, sp - pp, best_off)
    _, packed = sort_rows_plain(sp, (best_ml << plog) | best_off)
    return packed >> plog, packed & (W - 1)


def match_windows(key: torch.Tensor, words, depth: int,
                  sentinel: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-position best match over (R, W) int32 windows.

    words: the nwords suffix-word rows, a sequence of (R, W) int32 tensors or
    one (nwords, R, W) tensor. Returns (ml, off), int32 (R, W), position
    order. CPU tensors take the plain version; CUDA tensors launch the
    kernel (one launch a call).
    """
    plog = _check(key, depth)
    if key.device.type == "cpu":
        return match_windows_plain(key, words, depth, sentinel)
    R, W = key.shape
    if not torch.is_tensor(words):
        words = (torch.stack(list(words)) if len(words)
                 else torch.zeros((0, R, W), dtype=torch.int32, device=key.device))
    if words.dim() != 3 or tuple(words.shape[1:]) != (R, W):
        raise ValueError(f"match_windows: words {tuple(words.shape)} do not match key {(R, W)}")
    key = _kernels.aligned(key.to(torch.int32).contiguous())
    words = _kernels.aligned(words.to(torch.int32).contiguous())
    _kernels.check_cuda(key, torch.int32, "match_windows key")
    _kernels.check_cuda(words, torch.int32, "match_windows words")
    ml = torch.empty((R, W), dtype=torch.int32, device=key.device)
    off = torch.empty_like(ml)
    if R:
        # Tiled windows: two key buffers for the merge passes and the first
        # two suffix words in sorted order.
        scratch = (torch.empty((4, R, W), dtype=torch.int32, device=key.device)
                   if W > CTA_WIDTH else None)
        _kernels.launch("match", "tz_match_windows", key.data_ptr(), words.data_ptr(),
                        ml.data_ptr(), off.data_ptr(),
                        None if scratch is None else scratch.data_ptr(), R, plog,
                        words.shape[0], depth, sentinel)
    return ml, off
