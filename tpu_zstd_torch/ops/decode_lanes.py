"""K6 and K7: chunk-parallel Huffman literal and FSE sequence decode
(CUDA kernels + their plain PyTorch versions).

Counterparts of tpu_zstd/ops/pallas_decode.py `decode_huffman_lanes` (K6,
kernel csrc/decode_huf.cu) and `decode_sequences_lanes` (K7, kernel
csrc/decode_seq.cu). The TPU kernels put one checkpointed chunk per lane
and stage per-chunk word slices of the stream, taking the next record as a
chunk's end bound (forward-filled records made that bound wrong for about
0.3 % of blocks). Here no record is ever a chunk's end: K7 runs one thread
a chunk, 32 chunks a CTA, reading the stream words its CTA staged in shared
memory (device memory outside them); K6 runs one warp a chunk that stages
the chunk's stream words in shared memory and splits the chunk into
self-synchronising sub-spans with an exact fix-up (the end record only
places the lanes' starts).

CPU tensors take the plain versions in ops/decode.py; CUDA tensors launch
the kernels, or raise.
"""

from __future__ import annotations

import torch

from . import _kernels
from .decode import (
    PackedSeqTables,
    SeqTables,
    TSIZE_MAX,
    decode_huffman_device,
    decode_sequences_chunks,
    final_rep,
    pack_seq_tables,
)

HUF_STATS = 6  # K6's counters per chunk
SEQ_CPC = 32  # K7's chunks (threads that decode) a CTA
SEQ_STAGE_WORDS = 16384  # K7's staged stream words a CTA (64 KB)
SEQ_STATS = 2  # K7's counters per chunk


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


def decode_sequences_lanes(streams, total_bits, tables: SeqTables | PackedSeqTables, nseq, rep0,
                           ck_bits, ck_states, ck_rep, stride: int, num_chunks: int,
                           max_seqs: int, *, rep_fin: bool = False,
                           stats: torch.Tensor | None = None):
    """FSE sequence decode, `stride` sequences per chunk, one thread a chunk
    and SEQ_CPC chunks a CTA (K7); num_chunks = 1 (stride >= max nseq) is
    the serial decode of frames without checkpoints.

    Arguments as ops/decode.py `decode_sequences_chunks` (ck_* may have zero
    columns); tables packed once by the caller (`pack_seq_tables`) saves the
    packing on every call. Returns (ll, ml, off) (B, max_seqs) int32,
    sequence j at column j, zero past nseq, and with rep_fin also each
    block's rep triple after its last sequence (B, 3) int32, as
    `decode.final_rep` takes it from the plain version's rows.
    stats, a (B * num_chunks, 2) int32 CUDA tensor (row-major over (block,
    chunk)), receives per chunk the stream words its reads took from outside
    the CTA's staged words and the sequences it decoded.
    """
    if streams.device.type == "cpu":
        if stats is not None:
            raise ValueError("decode_sequences_lanes: stats are counted by the CUDA kernel only")
        ll, ml, off, rows = decode_sequences_chunks(streams, total_bits, tables, nseq, rep0,
                                                    ck_bits, ck_states, ck_rep, stride,
                                                    num_chunks, max_seqs)
        return (ll, ml, off, final_rep(rows, nseq, stride, num_chunks)) if rep_fin else (
            ll, ml, off)
    B, S = streams.shape
    dev = streams.device
    if not isinstance(tables, PackedSeqTables):
        tables = pack_seq_tables(tables)
    if tables.packed.shape != (B, 3, TSIZE_MAX) or stride <= 0 or num_chunks <= 0 or (
            max_seqs <= 0):
        raise ValueError(f"decode_sequences_lanes: tables {tuple(tables.packed.shape)} for "
                         f"{B} blocks, stride {stride}, chunks {num_chunks}, max_seqs {max_seqs}")
    streams = streams.contiguous()
    _kernels.check_cuda(streams, torch.uint8, "decode_sequences_lanes streams")
    if S % 16:  # the kernel stages 16-byte units; bytes past a row read as zeros
        streams = torch.nn.functional.pad(streams, (0, -S % 16))
        S = streams.shape[1]
    args = [_i32(x, f"decode_sequences_lanes {n}") for x, n in (
        (total_bits, "total_bits"), (tables.packed, "tables"), (tables.table_log, "table_log"),
        (nseq, "nseq"), (rep0, "rep0"))]
    K = ck_bits.shape[1] if ck_bits is not None and ck_bits.dim() == 2 else 0
    if K:
        recs = [_i32(x, f"decode_sequences_lanes {n}") for x, n in (
            (ck_bits, "ck_bits"), (ck_states, "ck_states"), (ck_rep, "ck_rep"))]
        if recs[1].shape != (B, K) or recs[2].shape != (B, K, 3):
            raise ValueError(f"decode_sequences_lanes: records {[tuple(r.shape) for r in recs]}")
    else:  # no records: the kernel reads none
        recs = args[:1] * 3
    outs = [torch.empty((B, max_seqs), dtype=torch.int32, device=dev) for _ in range(3)]
    fin = torch.empty((B, 3), dtype=torch.int32, device=dev) if rep_fin else None
    if stats is not None:
        _kernels.check_cuda(stats, torch.int32, "decode_sequences_lanes stats")
        if stats.shape != (B * num_chunks, SEQ_STATS):
            raise ValueError(f"decode_sequences_lanes: stats {tuple(stats.shape)} for "
                             f"{B * num_chunks} chunks")
    if B:
        _kernels.launch(
            "decode_seq", "tz_decode_sequences",
            streams.data_ptr(), *(a.data_ptr() for a in args), *(r.data_ptr() for r in recs),
            *(o.data_ptr() for o in outs), None if fin is None else fin.data_ptr(),
            None if stats is None else stats.data_ptr(), B, S, K, stride, num_chunks, max_seqs,
            min(num_chunks, SEQ_CPC), min(S // 4, SEQ_STAGE_WORDS),
        )
    return (*outs, fin) if rep_fin else tuple(outs)
