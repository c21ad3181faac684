"""K2: per-block concatenation of variable-length window segments (CUDA
kernel + plain PyTorch version).

Counterpart of tpu_zstd/ops/pallas_concat.py `concat_varlen`; the kernel is
csrc/concat.cu. The windowed extraction (ops/lz77.py `parse_block`) leaves,
per window, a compacted run of sequence rows or literal bytes; this joins
them into one dense row per block. `concat_fused` joins several such
operands in one launch, each read as the parse holds it (int64) and written
in the type the parse wants, with the casts done in the kernel;
`concat_varlen` is the int32 function of the JAX package, one operand.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from . import _kernels

MAX_OPS = 4  # operands a launch (csrc/concat.cu CONCAT_MAX_OPS)
MAX_NW = 1024  # windows a row (the kernel keeps 2 * NW + 1 int32 in shared memory)
_SRC = (torch.int32, torch.int64)
_DST = {torch.uint8: 0, torch.int32: 1, torch.int64: 2}
# Descriptor flags (csrc/concat.cu CF_*).
_SRC64, _OFF64, _CNT64, _DST_SHIFT = 1, 2, 4, 4


class Operand(NamedTuple):
    """One operand of `concat_fused`: segment w of row b is
    src[b, w, src_off[b, w] : src_off[b, w] + counts[b, w]] (src (B, NW, W)
    int32 or int64; src_off None means 0), joined into a (B, out_len) row of
    `dtype` (uint8, int32 or int64). Each value is the int32 the JAX kernel
    sees: the element's low 32 bits, plus w << win_shift where win_shift is
    given; the row holds it as `.to(dtype)` of that int32 would."""

    src: torch.Tensor
    src_off: torch.Tensor | None
    counts: torch.Tensor
    out_len: int
    dtype: torch.dtype
    win_shift: int | None = None


def concat_varlen_plain(
    x: torch.Tensor, src_off: torch.Tensor, counts: torch.Tensor, out_len: int
) -> torch.Tensor:
    """x (B, NW, W) int32: out[b] holds the segments x[b, w, off : off + cnt]
    in window order at exclusive-prefix offsets; a count is clamped at what is
    left of out_len, and the tail is zero."""
    B, NW, W = x.shape
    counts = counts.to(torch.int64)
    prefix = torch.cumsum(counts, dim=1) - counts
    start = torch.clamp(prefix, max=out_len)
    cnt = torch.minimum(counts, out_len - start)
    rel = torch.arange(W, device=x.device) - src_off.to(torch.int64)[..., None]
    keep = (rel >= 0) & (rel < cnt[..., None])
    dest = torch.where(keep, start[..., None] + rel, out_len)
    out = torch.zeros((B, out_len + 1), dtype=x.dtype, device=x.device)
    out.scatter_(1, dest.reshape(B, -1), x.reshape(B, -1))
    return out[:, :out_len]


def concat_fused_plain(ops: Sequence[Operand]) -> list[torch.Tensor]:
    """The chain the kernel fuses, per operand: the window base added in
    int64, `.to(torch.int32)`, `concat_varlen_plain`, `.to(dtype)`."""
    outs = []
    for op in ops:
        x = op.src
        if op.win_shift is not None:
            w = torch.arange(x.shape[1], device=x.device, dtype=torch.int64)
            x = x.to(torch.int64) + (w << op.win_shift)[:, None]
        off = op.src_off if op.src_off is not None else torch.zeros_like(op.counts)
        outs.append(concat_varlen_plain(x.to(torch.int32), off, op.counts,
                                        op.out_len).to(op.dtype))
    return outs


def _check(ops: Sequence[Operand]) -> tuple[int, int]:
    """Validate CUDA operands; returns (B, NW)."""
    if not 1 <= len(ops) <= MAX_OPS:
        raise ValueError(f"concat_fused: {len(ops)} operands (1 to {MAX_OPS} a launch)")
    B, NW = ops[0].src.shape[:2]
    dev = ops[0].src.device
    for k, op in enumerate(ops):
        name = f"concat_fused operand {k}"
        if op.src.device != dev or op.src.dim() != 3 or tuple(op.src.shape[:2]) != (B, NW):
            raise ValueError(f"{name}: src {tuple(op.src.shape)} on {op.src.device}; "
                             f"expected (B, NW, W) = ({B}, {NW}, W) on {dev}")
        if op.src.device.type != "cuda":
            raise ValueError(f"{name}: expected a CUDA tensor, got {op.src.device}")
        if op.src.dtype not in _SRC:
            raise TypeError(f"{name}: src dtype {op.src.dtype} not supported")
        if op.src.shape[2] < 1 or op.src.stride(2) != 1 and op.src.shape[2] > 1:
            raise ValueError(f"{name}: src needs windows of at least one element, unit stride")
        for t, what in ((op.src_off, "src_off"), (op.counts, "counts")):
            if t is None and what == "src_off":
                continue
            _kernels.check_cuda(t, None, f"{name} {what}")
            if t.device != dev or tuple(t.shape) != (B, NW) or t.dtype not in _SRC:
                raise ValueError(f"{name}: {what} {tuple(t.shape)} {t.dtype}; "
                                 f"expected ({B}, {NW}) int32 or int64")
        if op.dtype not in _DST:
            raise TypeError(f"{name}: output dtype {op.dtype} not supported")
        if not 0 <= op.out_len < 2**31:
            raise ValueError(f"{name}: out_len {op.out_len}")
        if op.win_shift is not None and not 0 <= op.win_shift < 64:
            raise ValueError(f"{name}: win_shift {op.win_shift}")
    if not 1 <= NW <= MAX_NW:
        raise ValueError(f"concat_fused: {NW} windows a row (1 to {MAX_NW})")
    return B, NW


def descriptors(ops: Sequence[Operand], outs: Sequence[torch.Tensor]) -> ctypes.Array:
    """The kernel's descriptors (csrc/concat.cu `ConcatOp`, ten int64 each)
    for the operands and their outputs."""
    fields = []
    for op, out in zip(ops, outs):
        src = op.src
        flags = ((_SRC64 if src.dtype == torch.int64 else 0)
                 | (_OFF64 if op.src_off is not None and op.src_off.dtype == torch.int64 else 0)
                 | (_CNT64 if op.counts.dtype == torch.int64 else 0)
                 | _DST[op.dtype] << _DST_SHIFT)
        fields += [src.data_ptr(), src.stride(0), src.stride(1), src.shape[2],
                   0 if op.src_off is None else op.src_off.data_ptr(), op.counts.data_ptr(),
                   out.data_ptr(), op.out_len, flags,
                   -1 if op.win_shift is None else op.win_shift]
    return (ctypes.c_int64 * len(fields))(*fields)


def concat_fused(ops: Sequence[Operand]) -> list[torch.Tensor]:
    """Join each operand's window segments into (B, out_len) rows of its
    dtype (see `Operand`), zero past the row's total. Requires src_off >= 0,
    counts >= 0 and src_off + counts <= W. CPU tensors take the plain
    version; CUDA tensors launch the kernel once for all operands (at most
    MAX_OPS, sharing B and NW), or raise."""
    if ops and all(op.src.device.type == "cpu" for op in ops):
        return concat_fused_plain(ops)
    ops = [op._replace(src_off=None if op.src_off is None else op.src_off.contiguous(),
                       counts=op.counts.contiguous()) for op in ops]
    B, NW = _check(ops)
    # The kernel writes every element: no memset.
    outs = [torch.empty((B, op.out_len), dtype=op.dtype, device=op.src.device) for op in ops]
    if B:
        _kernels.launch("concat", "tz_concat_fused", descriptors(ops, outs), len(ops), B, NW)
    return outs


def concat_varlen(
    x: torch.Tensor, src_off: torch.Tensor, counts: torch.Tensor, out_len: int
) -> torch.Tensor:
    """See `concat_varlen_plain`. Requires counts >= 0 and
    src_off + counts <= W. CPU tensors take the plain version; CUDA tensors
    launch the kernel with one operand, or raise."""
    if x.device.type == "cpu":
        return concat_varlen_plain(x, src_off, counts, out_len)
    _kernels.check_cuda(x, torch.int32, "concat_varlen x")
    return concat_fused([Operand(x, src_off, counts, out_len, torch.int32)])[0]
