"""K6 and K7: chunk-parallel Huffman literal and FSE sequence decode
(CUDA kernels + their plain PyTorch versions).

Counterparts of tpu_zstd/ops/pallas_decode.py `decode_huffman_lanes` (K6,
kernel csrc/decode_huf.cu) and `decode_sequences_lanes` (K7, kernel
csrc/decode_seq.cu). The TPU kernels put one checkpointed chunk per lane
and stage per-chunk word slices of the stream, taking the next record as a
chunk's end bound (forward-filled records made that bound wrong for about
0.3 % of blocks). Here no record is ever a chunk's end: K7 runs one thread
a chunk that reads its stream's own bytes in device memory by cursor; K6
runs one warp a chunk that stages the chunk's stream words in shared memory
and splits the chunk into self-synchronising sub-spans with an exact fix-up
(the end record only places the lanes' starts).

CPU tensors take the plain versions in ops/decode.py; CUDA tensors launch
the kernels, or raise.
"""

from __future__ import annotations

import torch

from . import _kernels
from .decode import SeqTables, TSIZE_MAX, decode_huffman_device, decode_sequences_chunks

MAX_THREADS = 256  # K7's threads per CTA; a CTA loops when a block has more rows
HUF_STATS = 6  # K6's counters per chunk


def _i32(x: torch.Tensor, name: str) -> torch.Tensor:
    x = x.to(torch.int32).contiguous()
    _kernels.check_cuda(x, torch.int32, name)
    return x


def decode_huffman_lanes(streams, total_bits, dtable, table_log, nsym, stride: int,
                         num_chunks: int, ck_bits, stats: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """4-stream Huffman literal decode, `stride` symbols per chunk (K6).

    Arguments and result as ops/decode.py `decode_huffman_device`: streams
    (B * 4, SW) uint8, total_bits / nsym (B * 4,), dtable (B, 2048) packed
    symbol << 4 | nb_bits, table_log (B,) <= 11 (the kernel clamps it
    there), ck_bits (B * 4, K).
    Returns (B * 4, num_chunks * stride) uint8, zero past nsym.
    stats, a (B * 4 * num_chunks, 6) int32 CUDA tensor (row-major over
    (stream, chunk)), receives per chunk: lanes whose true walk met their
    speculative walk, the symbols those lanes re-walked before meeting,
    lanes that never met, fix-up rounds, symbols re-walked in all rounds,
    symbols decoded in series past the last lane.
    """
    if streams.device.type == "cpu":
        if stats is not None:
            raise ValueError("decode_huffman_lanes: stats are counted by the CUDA kernel only")
        return decode_huffman_device(streams, total_bits, dtable, table_log, nsym, stride,
                                     num_chunks, ck_bits)
    R0, SW = streams.shape
    B = dtable.shape[0]
    if R0 != 4 * B or dtable.shape[1] != 2048 or stride <= 0 or num_chunks <= 0:
        raise ValueError(f"decode_huffman_lanes: streams {tuple(streams.shape)}, dtable "
                         f"{tuple(dtable.shape)}, stride {stride}, chunks {num_chunks}")
    streams = streams.contiguous()
    _kernels.check_cuda(streams, torch.uint8, "decode_huffman_lanes streams")
    ck = ck_bits if ck_bits.shape[1] else torch.zeros((R0, 1), dtype=torch.int32,
                                                      device=streams.device)
    args = [_i32(x, f"decode_huffman_lanes {n}") for x, n in (
        (total_bits, "total_bits"), (dtable, "dtable"), (table_log, "table_log"),
        (nsym, "nsym"), (ck, "ck_bits"))]
    if stats is not None:
        _kernels.check_cuda(stats, torch.int32, "decode_huffman_lanes stats")
        if stats.shape != (R0 * num_chunks, HUF_STATS):
            raise ValueError(f"decode_huffman_lanes: stats {tuple(stats.shape)} for "
                             f"{R0 * num_chunks} chunks")
    # The kernel writes every byte: symbols, then zeros past nsym.
    out = torch.empty((R0, num_chunks * stride), dtype=torch.uint8, device=streams.device)
    if B:
        _kernels.launch(
            "decode_huf", "tz_decode_huffman",
            streams.data_ptr(), *(a.data_ptr() for a in args), out.data_ptr(),
            None if stats is None else stats.data_ptr(), B, SW, ck.shape[1], stride, num_chunks,
        )
    return out


def decode_sequences_lanes(streams, total_bits, tables: SeqTables, nseq, rep0, ck_bits,
                           ck_states, ck_rep, stride: int, num_chunks: int, max_seqs: int):
    """FSE sequence decode, `stride` sequences per chunk, one chunk per
    thread (K7); num_chunks = 1 (one thread per block, stride >= max nseq)
    is the serial decode of frames without checkpoints.

    Arguments as ops/decode.py `decode_sequences_chunks` (ck_* may have zero
    columns when num_chunks = 1). Returns (ll, ml, off) (B, max_seqs) int32,
    sequence j at column j, zero past nseq.
    """
    if streams.device.type == "cpu":
        return decode_sequences_chunks(streams, total_bits, tables, nseq, rep0, ck_bits,
                                       ck_states, ck_rep, stride, num_chunks, max_seqs)[:3]
    B, S = streams.shape
    dev = streams.device
    if tables.symbol.shape != (B, 3, TSIZE_MAX) or stride <= 0 or num_chunks <= 0:
        raise ValueError(f"decode_sequences_lanes: tables {tuple(tables.symbol.shape)} for "
                         f"{B} blocks, stride {stride}, chunks {num_chunks}")
    streams = streams.contiguous()
    _kernels.check_cuda(streams, torch.uint8, "decode_sequences_lanes streams")
    packed = (tables.symbol.to(torch.int32) | (tables.nb_bits.to(torch.int32) << 8)
              | (tables.new_state.to(torch.int32) << 16))
    K = ck_bits.shape[1] if ck_bits is not None and ck_bits.dim() == 2 else 0
    if K == 0:
        ck_bits = ck_states = torch.zeros((B, 1), dtype=torch.int32, device=dev)
        ck_rep = torch.ones((B, 1, 3), dtype=torch.int32, device=dev)
    args = [_i32(x, f"decode_sequences_lanes {n}") for x, n in (
        (total_bits, "total_bits"), (packed, "tables"), (tables.table_log, "table_log"),
        (nseq, "nseq"), (rep0, "rep0"), (ck_bits, "ck_bits"), (ck_states, "ck_states"),
        (ck_rep, "ck_rep"))]
    outs = [torch.zeros((B, max_seqs), dtype=torch.int32, device=dev) for _ in range(3)]
    if B:
        _kernels.launch(
            "decode_seq", "tz_decode_sequences",
            streams.data_ptr(), *(a.data_ptr() for a in args), *(o.data_ptr() for o in outs),
            B, S, max(K, 1), stride, num_chunks, max_seqs, min(num_chunks, MAX_THREADS),
        )
    return tuple(outs)
