"""K1: per-row circular right roll (CUDA kernel + plain PyTorch version).

Counterpart of tpu_zstd/ops/pallas_roll.py `roll_rows`. The pipeline builds
variable-length sections by rolling fixed-capacity rows to data-dependent
offsets (ops/bitpack.py `dynroll` / `place`); every such roll of a CUDA
tensor launches the kernel in csrc/roll.cu.
"""

from __future__ import annotations

import torch

from . import _kernels


def roll_rows_plain(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """out[r, (j + shift[r]) mod W] = x[r, j] for x (R, W), shift (R,)."""
    W = x.shape[-1]
    j = torch.arange(W, device=x.device)
    src = (j[None, :] - shift.to(torch.int64)[:, None]) % W
    return torch.gather(x, 1, src)


def roll_rows(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Right-roll each row of x (R, W) by shift[r] (mod W): 1-, 4- or 8-byte
    elements. CPU tensors take the plain version."""
    if x.device.type == "cpu":
        return roll_rows_plain(x, shift)
    if x.dim() != 2 or shift.shape != x.shape[:1]:
        raise ValueError(f"roll_rows: x {tuple(x.shape)} / shift {tuple(shift.shape)}")
    _kernels.check_cuda(x, None, "roll_rows x")
    if x.element_size() not in (1, 4, 8):
        raise TypeError(f"roll_rows: element size {x.element_size()} not supported")
    shift = shift.to(device=x.device, dtype=torch.int64).contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    _kernels.launch(
        "roll", "tz_roll_rows",
        x.data_ptr(), out.data_ptr(), shift.data_ptr(), x.shape[0], x.shape[1], x.element_size(),
    )
    return out
