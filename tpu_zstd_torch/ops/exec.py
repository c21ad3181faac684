"""K8 / K9: sequence execution (CUDA kernel + its plain PyTorch version).

Counterpart of tpu_zstd/ops/pallas_exec.py `execute_sequences_pallas` (K8)
and `execute_sequences_pallas_mb` (K9, the same executor with G blocks per
TPU grid step); one CUDA kernel, csrc/exec.cu, computes both (one CTA per
block: a scan of the sequences, then tiles of the output resolved by pointer
doubling in shared memory). CPU tensors take the plain version, ops/decode.py
`execute_sequences_device`; CUDA tensors launch the kernel, or raise.
"""

from __future__ import annotations

import torch

from . import _kernels
from .decode import execute_sequences_device


def execute_sequences(lits, nlit, ll, ml, off, nseq, window, out_size: int, win_size: int,
                      lit_src=None, stats=None):
    """Regenerate block contents from resolved sequences.

    lits (B, L) uint8 front-compacted literals, nlit (B,), ll/ml/off (B, MS)
    int32, nseq (B,), window (B, win_size) uint8 history right-aligned
    before each block; lit_src = (syms (B * 4, SEGC) uint8, regen (B,))
    reads the literals straight from K6's stream rows instead (lits is then
    ignored). Returns (out (B, out_size) uint8, out_len (B,) int32); bytes
    past out_len are unspecified. stats, a (B, 3) int32 CUDA tensor, takes
    the kernel's counters per block: output tiles, pointer-doubling rounds
    summed over the tiles, the most rounds of one tile.
    """
    if ll.device.type == "cpu":
        if stats is not None:
            raise ValueError("execute_sequences: stats are counted by the CUDA kernel only")
        out, out_len = execute_sequences_device(lits, nlit, ll, ml, off, nseq, window,
                                                out_size, win_size, lit_src)
        return out, out_len.to(torch.int32)
    B, MS = ll.shape
    dev = ll.device
    if ml.shape != (B, MS) or off.shape != (B, MS) or window.shape != (B, win_size):
        raise ValueError(f"execute_sequences: ll {tuple(ll.shape)}, ml {tuple(ml.shape)}, "
                         f"off {tuple(off.shape)}, window {tuple(window.shape)}")

    def i32(x, name):
        x = x.to(torch.int32).contiguous()
        _kernels.check_cuda(x, torch.int32, f"execute_sequences {name}")
        return x

    def u8(x, name):
        x = x.contiguous()
        _kernels.check_cuda(x, torch.uint8, f"execute_sequences {name}")
        return x

    ll, ml, off, nseq, nlit = (i32(x, n) for x, n in (
        (ll, "ll"), (ml, "ml"), (off, "off"), (nseq, "nseq"), (nlit, "nlit")))
    window = u8(window, "window")
    if lit_src is not None:
        syms, regen = u8(lit_src[0], "syms"), i32(lit_src[1], "regen")
        if syms.shape[0] != 4 * B:
            raise ValueError(f"execute_sequences: syms {tuple(syms.shape)} for {B} blocks")
        lits_ptr, L, syms_ptr, SEGC, regen_ptr = 0, 0, syms.data_ptr(), syms.shape[1], \
            regen.data_ptr()
    else:
        lits = u8(lits, "lits")
        lits_ptr, L, syms_ptr, SEGC, regen_ptr = lits.data_ptr(), lits.shape[1], None, 0, None
    if stats is not None:
        _kernels.check_cuda(stats, torch.int32, "execute_sequences stats")
        if stats.shape != (B, 3):
            raise ValueError(f"execute_sequences: stats {tuple(stats.shape)} for {B} blocks")
    out = torch.empty((B, out_size), dtype=torch.uint8, device=dev)
    out_len = torch.empty((B,), dtype=torch.int32, device=dev)
    if B:
        # The kernel's sequence table: output, match and literal start and
        # the clamped offset of each sequence, one more entry for the tail.
        table = torch.empty((B, MS + 1, 4), dtype=torch.int32, device=dev)
        _kernels.launch(
            "exec", "tz_exec_sequences",
            lits_ptr or None, syms_ptr, regen_ptr, nlit.data_ptr(), ll.data_ptr(),
            ml.data_ptr(), off.data_ptr(), nseq.data_ptr(), window.data_ptr(), out.data_ptr(),
            out_len.data_ptr(), table.data_ptr(), None if stats is None else stats.data_ptr(),
            B, L, SEGC, max(MS, 1), win_size, out_size,
        )
    return out, out_len
