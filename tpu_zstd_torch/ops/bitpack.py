"""Bit deposit and row placement for batched bitstreams.

Counterpart of tpu_zstd/ops/bitpack.py. Every function works on a leading
batch dimension (one row per block). u32 bit-fields ride in int64 and are
masked to 32 bits: torch on the CPU has no u32 shift, add or compare, and
`>>` of int32 is arithmetic where the JAX package's u32 `>>` is logical.

Rolls by a data-dependent shift go through `dynroll`, which on a CUDA tensor
always launches kernel K1 (ops/roll.py).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .roll import roll_rows

M32 = 0xFFFFFFFF


def _field_mask(lengths: torch.Tensor) -> torch.Tensor:
    """(1 << length) - 1 for lengths in [0, 32], as int64."""
    return (torch.ones_like(lengths) << torch.clamp(lengths, 0, 32)) - 1


def deposit_bits(values: torch.Tensor, lengths: torch.Tensor, num_words: int):
    """Pack bit fields LSB-first at consecutive bit offsets, per row.

    values (B, M): field values (only the low lengths[i] bits are used);
    lengths (B, M): bit widths in [0, 32]. Returns (words (B, num_words)
    int64 holding u32 values, total_bits (B,)). Byte j of a row's stream is
    (words[j // 4] >> (8 * (j % 4))) & 0xFF. Fields past num_words are
    dropped.
    """
    lengths = lengths.to(torch.int64)
    if values.shape[-1] >= 4096:
        # Large deposits: tree concatenation (no scatters).
        return deposit_bits_tree(values, lengths, num_words)
    offs = torch.cumsum(lengths, dim=-1) - lengths
    return deposit_bits_at(values, lengths, offs, num_words), lengths.sum(dim=-1)


def deposit_bits_at(values: torch.Tensor, lengths: torch.Tensor, offsets: torch.Tensor,
                    num_words: int) -> torch.Tensor:
    """Like deposit_bits, with the caller's absolute bit offsets (B, M) per
    field. Field bit ranges must be disjoint (add == or). Returns (B,
    num_words) int64 holding u32 words; parts past num_words are dropped."""
    lengths = lengths.to(torch.int64)
    offsets = offsets.to(torch.int64)
    v = values.to(torch.int64) & _field_mask(torch.clamp(lengths, max=32))
    word = offsets >> 5
    sh = offsets & 31
    lo = (v << sh) & M32
    # High spill into the next word, split in two shifts (defined at sh == 0).
    hi = (v >> 1) >> (31 - sh)
    # Zero-length fields and words outside the buffer go to a discarded slot.
    word = torch.where(lengths > 0, word, num_words)
    slot_lo = torch.where((word >= 0) & (word < num_words), word, num_words)
    slot_hi = torch.where((word + 1 >= 0) & (word + 1 < num_words), word + 1, num_words)
    words = torch.zeros((values.shape[0], num_words + 1), dtype=torch.int64,
                        device=values.device)
    words.scatter_add_(1, slot_lo, lo)
    words.scatter_add_(1, slot_hi, hi)
    return words[:, :num_words] & M32


def deposit_bits_tree(
    values: torch.Tensor, lengths: torch.Tensor, num_words: int, max_field_bits: int = 32
):
    """deposit_bits via pairwise tree concatenation, per row.

    Each field starts as a 1-word segment; adjacent segments merge level by
    level, B bit-shifted after A and word-rolled into place with `dynroll`.
    Level-k segments hold at most 2^k * max_field_bits bits, clamped to the
    output capacity. Returns (words (B, num_words) int64, total_bits (B,)).
    """
    B, M = values.shape
    lengths = lengths.to(torch.int64)
    total_bits = lengths.sum(dim=-1)
    words = (values.to(torch.int64) & _field_mask(lengths))[..., None]  # (B, segs, width)
    lens = lengths
    width = 1
    cap_bits = max_field_bits
    while words.shape[1] > 1:
        if words.shape[1] % 2:
            # Odd segment counts pad one empty segment per level.
            words = F.pad(words, (0, 0, 0, 1))
            lens = F.pad(lens, (0, 1))
        cap_bits = min(2 * cap_bits, num_words * 32)
        new_width = min(-(-cap_bits // 32), num_words)
        A, Bw = words[:, 0::2], words[:, 1::2]
        La, Lb = lens[:, 0::2], lens[:, 1::2]
        s = (La & 31)[..., None]
        ws = La >> 5  # word offset of B within the merged segment
        # Bit-shift B left by s across words (little-endian).
        Bprev = F.pad(Bw, (1, 0))[..., :-1]
        Bs = ((Bw << s) & M32) | ((Bprev >> 1) >> (31 - s))
        spill = (Bw[..., -1:] >> 1) >> (31 - s)  # top-word overflow
        Bs = torch.cat([Bs, spill], dim=-1)
        words = (_fit(A, new_width) + dynroll(_fit(Bs, new_width), ws)) & M32
        lens = La + Lb
        width = new_width
    out = words[:, 0]
    if out.shape[-1] < num_words:
        out = F.pad(out, (0, num_words - out.shape[-1]))
    return out, total_bits


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    """Zero-extend or trim the last axis to n."""
    if x.shape[-1] < n:
        return F.pad(x, (0, n - x.shape[-1]))
    return x[..., :n]


def shift_words(words: torch.Tensor, bit_offset: torch.Tensor, out_words: int) -> torch.Tensor:
    """Place u32 word bitstreams (B, W) at per-row absolute bit offsets (B,)
    in (B, out_words) buffers; the caller guarantees the content fits."""
    bit_offset = torch.as_tensor(bit_offset, dtype=torch.int64, device=words.device)
    s = (bit_offset & 31)[..., None]
    ws = bit_offset >> 5
    w = words.to(torch.int64)
    prev = F.pad(w, (1, 0))[..., :-1]
    shifted = ((w << s) & M32) | ((prev >> 1) >> (31 - s))
    spill = (w[..., -1:] >> 1) >> (31 - s)
    shifted = torch.cat([shifted, spill], dim=-1)
    return dynroll(_fit(shifted, out_words), ws)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """u32 word streams (..., W) -> little-endian byte streams (..., 4W) uint8."""
    shifts = torch.arange(4, device=words.device, dtype=torch.int64) * 8
    b = (words.to(torch.int64)[..., None] >> shifts) & 0xFF
    return b.reshape(*words.shape[:-1], -1).to(torch.uint8)


def dynroll(x: torch.Tensor, shift) -> torch.Tensor:
    """Right-roll the last axis of x by a per-row shift (broadcast to
    x.shape[:-1]), modulo the row width. One K1 launch on a CUDA tensor."""
    W = x.shape[-1]
    rows = x.shape[:-1]
    shift = torch.as_tensor(shift, dtype=torch.int64, device=x.device)
    shift = torch.broadcast_to(shift, rows).reshape(-1)
    return roll_rows(x.reshape(-1, W).contiguous(), shift.contiguous()).reshape(x.shape)


def dynroll_left(x: torch.Tensor, shift) -> torch.Tensor:
    """Left-roll the last axis by a per-row shift in [0, W]."""
    n = x.shape[-1]
    shift = torch.as_tensor(shift, dtype=torch.int64, device=x.device)
    return dynroll(x, (n - shift) % n)


def place(x: torch.Tensor, length, offset, out_len: int) -> torch.Tensor:
    """Mask x beyond `length`, zero-extend/trim to out_len, roll right by
    `offset` (per row). Sum of disjoint `place` results == sequential buffer
    writes. An offset of the Python int 0 needs no roll."""
    n = x.shape[-1]
    idx = torch.arange(n, device=x.device)
    length = torch.as_tensor(length, device=x.device)
    xm = torch.where(idx < length[..., None], x, torch.zeros((), dtype=x.dtype, device=x.device))
    xm = _fit(xm, out_len)
    if isinstance(offset, int) and offset == 0:
        return xm
    return dynroll(xm, offset)
