"""K2: per-block concatenation of variable-length window segments (CUDA
kernel + plain PyTorch version).

Counterpart of tpu_zstd/ops/pallas_concat.py `concat_varlen`; the kernel is
csrc/concat.cu. The windowed extraction (ops/lz77.py `parse_block`) leaves,
per window, a compacted run of sequence rows or literal bytes; this joins
them into one dense row per block.
"""

from __future__ import annotations

import torch

from . import _kernels


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


def concat_varlen(
    x: torch.Tensor, src_off: torch.Tensor, counts: torch.Tensor, out_len: int
) -> torch.Tensor:
    """See `concat_varlen_plain`. Requires counts >= 0 and
    src_off + counts <= W. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return concat_varlen_plain(x, src_off, counts, out_len)
    B, NW, W = x.shape
    _kernels.check_cuda(x, torch.int32, "concat_varlen x")
    src_off = src_off.to(torch.int32).contiguous()
    counts = counts.to(torch.int32).contiguous()
    if src_off.shape != (B, NW) or counts.shape != (B, NW):
        raise ValueError("concat_varlen: src_off / counts must be (B, NW)")
    out = torch.zeros((B, out_len), dtype=torch.int32, device=x.device)
    if B == 0 or NW == 0:
        return out
    _kernels.launch(
        "concat", "tz_concat_varlen",
        x.data_ptr(), src_off.data_ptr(), counts.data_ptr(), out.data_ptr(), B, NW, W, out_len,
    )
    return out
