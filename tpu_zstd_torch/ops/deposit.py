"""K11: bit deposit at caller-given offsets (CUDA kernel + plain PyTorch
version).

Counterpart of tpu_zstd/ops/pallas_deposit.py `deposit_bits_pallas`; the
kernel is csrc/deposit.cu. Per row, field f puts the low lengths[f] bits of
values[f] at bit offsets[f], LSB first, into u32 words. Offsets must be
monotone along each row, field bit ranges disjoint, and zero-length pad
fields must repeat the last real offset (the caller's rule, as in the JAX
package): the TPU kernel places each chunk of 128 fields in a 512-word
window based at its first field's offset, and the CUDA kernel keeps that
window rule. The output is (B, nw) int64 holding u32 words (the port's bit
layout, as ops/bitpack.py), nw = ceil(max(num_words, 512) / 128) * 128 +
512.
"""

from __future__ import annotations

import torch

from . import _kernels
from .bitpack import deposit_bits_at

CHUNK_F = 128  # fields a chunk
W_LOC = 512    # words of a chunk's window


def padded_words(num_words: int) -> int:
    """The output width nw for num_words."""
    return -(-max(num_words, W_LOC) // 128) * 128 + W_LOC


def _check(values, lengths, offsets) -> None:
    if values.dim() != 2 or lengths.shape != values.shape or offsets.shape != values.shape:
        raise ValueError("deposit_bits_pallas: values, lengths and offsets must be (B, M) alike, "
                         f"got {tuple(values.shape)}, {tuple(lengths.shape)}, "
                         f"{tuple(offsets.shape)}")
    if values.shape[1] % CHUNK_F:
        raise ValueError(f"deposit_bits_pallas: M = {values.shape[1]} is not a multiple of "
                         f"{CHUNK_F}")


def deposit_bits_pallas_plain(values: torch.Tensor, lengths: torch.Tensor,
                              offsets: torch.Tensor, num_words: int) -> torch.Tensor:
    """`deposit_bits_at` over the padded width: equal to the TPU kernel
    wherever its window precondition holds (every chunk's fields fall in its
    512-word window, as with offsets that are an exclusive cumsum of the
    lengths)."""
    _check(values, lengths, offsets)
    return deposit_bits_at(values, lengths, offsets, padded_words(num_words))


def deposit_bits_pallas(values: torch.Tensor, lengths: torch.Tensor, offsets: torch.Tensor,
                        num_words: int) -> torch.Tensor:
    """Batched bit deposit: (B, M) values (u32 in int64, or int32), lengths
    and offsets -> (B, padded_words(num_words)) int64 words. M must be a
    multiple of 128. CPU tensors take the plain version; CUDA tensors launch
    the kernel (one launch a call)."""
    _check(values, lengths, offsets)
    if values.device.type == "cpu":
        return deposit_bits_pallas_plain(values, lengths, offsets, num_words)
    B, M = values.shape
    nw = padded_words(num_words)
    vals = values.to(torch.int64).contiguous()
    lens = lengths.to(torch.int32).contiguous()
    offs = offsets.to(torch.int32).contiguous()
    for t, dt, name in ((vals, torch.int64, "values"), (lens, torch.int32, "lengths"),
                        (offs, torch.int32, "offsets")):
        _kernels.check_cuda(t, dt, f"deposit_bits_pallas {name}")
    out = torch.zeros((B, nw), dtype=torch.int64, device=values.device)
    if B and M:
        _kernels.launch("deposit", "tz_deposit_bits", vals.data_ptr(), lens.data_ptr(),
                        offs.data_ptr(), out.data_ptr(), B, M, nw)
    return out
