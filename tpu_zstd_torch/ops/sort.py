"""K12: ascending sort of each row by a unique int32 key, carrying payloads
(CUDA kernel + plain PyTorch version).

Counterpart of tpu_zstd/ops/pallas_sort.py `sort_rows`; the kernel is
csrc/sort.cu, whose bitonic network (csrc/bitonic.cuh) also sorts inside K13
(ops/match.py). Operands are int32 (..., W) with W a power of two >= 1024
(the kernel takes widths up to 2^30); leading axes flatten into rows, as
the JAX package's custom vmap does. Keys must be unique within a row (ties
would route payloads in an order the network does not define) and compare
as signed int32.
"""

from __future__ import annotations

import torch

from . import _kernels

# The widest row one CTA sorts (its key and slot in registers, 16 a thread
# over 512 threads). Wider rows sort in tiles of that width, which merge-path
# passes then merge (csrc/bitonic.cuh).
CTA_WIDTH = 8192
# Payloads a launch takes (csrc/bitonic.cuh MAX_PAY).
MAX_PAY = 32


def sortable(width: int) -> bool:
    """Whether sort_rows supports this row width."""
    return width >= 1024 and width & (width - 1) == 0


def _check_width(W: int) -> None:
    if not sortable(W):
        raise ValueError(f"sort_rows: row width {W} must be a power of two >= 1024")


def sort_rows_plain(*ops: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """`torch.sort` of the key along the last axis, then `torch.gather` of
    each payload by the sorted order."""
    _check_width(ops[0].shape[-1])
    key, order = torch.sort(ops[0].to(torch.int32), dim=-1)
    return (key, *(torch.gather(p.to(torch.int32), -1, order) for p in ops[1:]))


def sort_rows(*ops: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Sort each row of the int32 operands ascending by ops[0]; returns the
    reordered operands, int32, in the operands' shape. CPU tensors take the
    plain version; CUDA tensors launch the kernel (one launch a call of up to
    MAX_PAY payloads, one more for each MAX_PAY beyond)."""
    shape = ops[0].shape
    W = shape[-1]
    _check_width(W)
    if any(o.shape != shape for o in ops):
        raise ValueError(f"sort_rows: operand shapes differ: {[tuple(o.shape) for o in ops]}")
    if ops[0].device.type == "cpu":
        return sort_rows_plain(*ops)
    flat = [_kernels.aligned(o.reshape(-1, W).to(torch.int32).contiguous()) for o in ops]
    for k, o in enumerate(flat):
        _kernels.check_cuda(o, torch.int32, f"sort_rows operand {k}")
    R = flat[0].shape[0]
    outs = [torch.empty_like(o) for o in flat]
    if R:
        # Tiled rows: one more key buffer and two slot buffers.
        scratch = (torch.empty((3, R, W), dtype=torch.int32, device=flat[0].device)
                   if W > CTA_WIDTH else None)
        # The payload pointers go to the kernel by value, MAX_PAY a launch;
        # more payloads take more launches, each sorting the key again.
        for g in range(0, max(len(flat) - 1, 1), MAX_PAY):
            pin, pout = flat[1 + g:1 + g + MAX_PAY], outs[1 + g:1 + g + MAX_PAY]
            _kernels.launch("sort", "tz_sort_rows", flat[0].data_ptr(), outs[0].data_ptr(),
                            _kernels.pointers(pin), _kernels.pointers(pout),
                            None if scratch is None else scratch.data_ptr(), len(pin), R,
                            W.bit_length() - 1)
    return tuple(o.reshape(shape) for o in outs)


def sort_1d(*ops: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """sort_rows over 1-D operands (one row)."""
    return tuple(o[0] for o in sort_rows(*(o[None] for o in ops)))
