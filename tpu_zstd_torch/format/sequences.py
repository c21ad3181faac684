"""Sequence-section codec and sequence execution, RFC 8878 §3.1.1.3.2 (host).

The port's copy of tpu_zstd/format/sequences.py: the nbSeq varint, repeat
offsets (`resolve_offset`, `encode_offset`), the predefined and custom
encode tables and the interleaved 3-state FSE encode of the host
compressor, one decode table per compression mode (predefined, RLE, FSE
with an NCount header, repeat) and the three tables a block hands to the
next for Repeat mode, and the host decoder's `decode_sequences_section` and
`execute_sequences`. The device decoder parses only the tables here and
decodes the bitstream on the card (ops/decode.py, ops/decode_lanes.py).

A sequence is (literal_length, match_length, offset). On the wire, offsets
are "offset base" values: actual_offset + 3, or repcode indicators 1..3
resolved against a rolling 3-entry repeat-offset history (initial {1, 4, 8}).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    LL_BASELINE,
    LL_BITS,
    LL_DEFAULT_LOG,
    LL_DEFAULT_NORM,
    ML_BASELINE,
    ML_BITS,
    ML_DEFAULT_LOG,
    ML_DEFAULT_NORM,
    OF_DEFAULT_LOG,
    OF_DEFAULT_NORM,
    REPCODE_INIT,
    SEQ_FSE,
    SEQ_PREDEFINED,
    SEQ_REPEAT,
    SEQ_RLE,
    ll_code,
    ml_code,
    of_code,
)
from .bitstream import BackwardBitReader, BackwardBitWriter
from .fse import (
    CTable,
    DTable,
    DecState,
    EncState,
    build_ctable,
    build_dtable,
    normalize_counts,
    optimal_table_log,
    read_ncount,
    write_ncount,
)


@dataclass
class Sequences:
    """Columnar sequence storage (lit lengths, match lengths, offset bases)."""

    lit_lengths: np.ndarray   # u32[n]
    match_lengths: np.ndarray  # u32[n] (actual lengths, >= 3)
    off_bases: np.ndarray     # u32[n] (offset+3 or repcode value 1..3)
    last_literals: int        # literals after the final sequence

    def __len__(self) -> int:
        return len(self.lit_lengths)


# --- Repcode resolution ----------------------------------------------------------


def resolve_offset(off_value: int, ll: int, rep: list[int]) -> tuple[int, list[int]]:
    """Decode an offset-base value into an actual offset + updated rep history."""
    if off_value > 3:
        off = off_value - 3
        return off, [off, rep[0], rep[1]]
    idx = off_value - 1 + (1 if ll == 0 else 0)
    if idx == 0:
        return rep[0], rep
    if idx == 1:
        return rep[1], [rep[1], rep[0], rep[2]]
    if idx == 2:
        return rep[2], [rep[2], rep[0], rep[1]]
    off = rep[0] - 1
    if off == 0:
        raise ValueError("corrupt: repcode 3 with rep[0] == 1 and ll == 0")
    return off, [off, rep[0], rep[1]]


def encode_offset(offset: int, ll: int, rep: list[int]) -> tuple[int, list[int]]:
    """Encode an actual offset as an offset-base value, preferring repcodes."""
    if ll != 0:
        if offset == rep[0]:
            return 1, rep
        if offset == rep[1]:
            return 2, [rep[1], rep[0], rep[2]]
        if offset == rep[2]:
            return 3, [rep[2], rep[0], rep[1]]
    else:
        if offset == rep[1]:
            return 1, [rep[1], rep[0], rep[2]]
        if offset == rep[2]:
            return 2, [rep[2], rep[0], rep[1]]
        if offset == rep[0] - 1 and offset != 0:
            return 3, [offset, rep[0], rep[1]]
    return offset + 3, [offset, rep[0], rep[1]]


def offsets_to_offbases(
    offsets: np.ndarray, lit_lengths: np.ndarray, rep_init: tuple[int, ...] = REPCODE_INIT
) -> tuple[np.ndarray, list[int]]:
    """Convert actual offsets to wire offset-base values with repcode tracking."""
    rep = list(rep_init)
    out = np.zeros(len(offsets), dtype=np.uint32)
    for i in range(len(offsets)):
        ob, rep = encode_offset(int(offsets[i]), int(lit_lengths[i]), rep)
        out[i] = ob
    return out, rep


# --- Predefined tables (built once) ----------------------------------------------

_PREDEF_CT: dict[str, CTable] = {}
_PREDEF_DT: dict[str, DTable] = {}


def predefined_ctables() -> tuple[CTable, CTable, CTable]:
    if not _PREDEF_CT:
        _PREDEF_CT["ll"] = build_ctable(LL_DEFAULT_NORM, LL_DEFAULT_LOG)
        _PREDEF_CT["of"] = build_ctable(OF_DEFAULT_NORM, OF_DEFAULT_LOG)
        _PREDEF_CT["ml"] = build_ctable(ML_DEFAULT_NORM, ML_DEFAULT_LOG)
    return _PREDEF_CT["ll"], _PREDEF_CT["of"], _PREDEF_CT["ml"]


def predefined_dtables() -> tuple[DTable, DTable, DTable]:
    if not _PREDEF_DT:
        _PREDEF_DT["ll"] = build_dtable(LL_DEFAULT_NORM, LL_DEFAULT_LOG)
        _PREDEF_DT["of"] = build_dtable(OF_DEFAULT_NORM, OF_DEFAULT_LOG)
        _PREDEF_DT["ml"] = build_dtable(ML_DEFAULT_NORM, ML_DEFAULT_LOG)
    return _PREDEF_DT["ll"], _PREDEF_DT["of"], _PREDEF_DT["ml"]


def rle_dtable(symbol: int) -> DTable:
    """Single-state table for RLE symbol mode (accuracy log 0)."""
    norm = np.zeros(symbol + 1, dtype=np.int32)
    norm[symbol] = 1
    return build_dtable(norm, 0)


# --- nbSeq varint -----------------------------------------------------------------


def write_nbseq(n: int) -> bytes:
    if n < 128:
        return bytes([n])
    if n < 0x7F00:
        return bytes([(n >> 8) + 0x80, n & 0xFF])
    return bytes([0xFF, (n - 0x7F00) & 0xFF, ((n - 0x7F00) >> 8) & 0xFF])


def read_nbseq(data: bytes) -> tuple[int, int]:
    b0 = data[0]
    if b0 < 128:
        return b0, 1
    if b0 < 255:
        return ((b0 - 0x80) << 8) + data[1], 2
    return data[1] + (data[2] << 8) + 0x7F00, 3


# --- Sequence bitstream encode ----------------------------------------------------


def encode_sequences_bitstream(
    seqs: Sequences, ct_ll: CTable, ct_of: CTable, ct_ml: CTable
) -> bytes:
    """Interleaved 3-state FSE encode of the sequence list (backward order).

    Mirrors the RFC encoding order (state init from the last sequence; per
    iteration encode OF, ML, LL state bits then LL, ML, OF extra bits; final
    flush ML, OF, LL).
    """
    n = len(seqs)
    assert n > 0
    ll = seqs.lit_lengths
    ml = seqs.match_lengths
    ob = seqs.off_bases
    llc = ll_code(ll)
    mlc = ml_code(ml)
    ofc = of_code(ob)

    w = BackwardBitWriter()
    st_ml = EncState(ct_ml)
    st_of = EncState(ct_of)
    st_ll = EncState(ct_ll)
    last = n - 1
    st_ml.init(int(mlc[last]))
    st_of.init(int(ofc[last]))
    st_ll.init(int(llc[last]))
    w.add_bits(int(ll[last]), int(LL_BITS[llc[last]]))
    w.add_bits(int(ml[last]) - 3, int(ML_BITS[mlc[last]]))
    w.add_bits(int(ob[last]), int(ofc[last]))
    w.flush()
    for i in range(n - 2, -1, -1):
        st_of.encode(int(ofc[i]), w)
        st_ml.encode(int(mlc[i]), w)
        st_ll.encode(int(llc[i]), w)
        w.flush()
        w.add_bits(int(ll[i]), int(LL_BITS[llc[i]]))
        w.add_bits(int(ml[i]) - 3, int(ML_BITS[mlc[i]]))
        w.flush()
        w.add_bits(int(ob[i]), int(ofc[i]))
        w.flush()
    st_ml.flush(w)
    st_of.flush(w)
    st_ll.flush(w)
    return w.close()


def encode_sequences_section(seqs: Sequences) -> bytes:
    """Full Sequences_Section with predefined FSE tables (mode byte 0)."""
    n = len(seqs)
    if n == 0:
        return b"\x00"
    ct_ll, ct_of, ct_ml = predefined_ctables()
    header = write_nbseq(n)
    modes = (SEQ_PREDEFINED << 6) | (SEQ_PREDEFINED << 4) | (SEQ_PREDEFINED << 2)
    payload = encode_sequences_bitstream(seqs, ct_ll, ct_of, ct_ml)
    return header + bytes([modes]) + payload


def build_fse_ctable_for_codes(
    codes: np.ndarray, max_symbol: int, max_log: int, default_norm: np.ndarray
) -> tuple[CTable, bytes] | None:
    """Build a custom FSE table + NCount header for a code stream.

    Returns None when a custom table is not worthwhile (caller falls back to
    predefined / RLE modes).
    """
    n = len(codes)
    if n < 2:
        return None
    counts = np.bincount(codes, minlength=max_symbol + 1).astype(np.int64)
    if (counts > 0).sum() < 2:
        return None
    table_log = optimal_table_log(max_log, n, int(np.max(np.nonzero(counts)[0])))
    counts = counts[: int(np.max(np.nonzero(counts)[0])) + 1]
    norm = normalize_counts(counts, table_log, n)
    header = write_ncount(norm, table_log)
    return build_ctable(norm, table_log), header


# --- Sequence bitstream decode -----------------------------------------------------


@dataclass
class SeqDecodeTables:
    """The three decode tables persisted across blocks (Repeat mode)."""

    ll: DTable
    of: DTable
    ml: DTable


def read_sequence_table(
    data: bytes, mode: int, prev: DTable | None, default_norm: np.ndarray, default_log: int,
    max_symbol: int,
) -> tuple[DTable, int]:
    """Parse one symbol table per its compression mode. Returns (dtable, consumed)."""
    if mode == SEQ_PREDEFINED:
        return build_dtable(default_norm, default_log), 0
    if mode == SEQ_RLE:
        return rle_dtable(data[0]), 1
    if mode == SEQ_FSE:
        norm, table_log, consumed = read_ncount(data, max_symbol=max_symbol)
        return build_dtable(norm, table_log), consumed
    if mode == SEQ_REPEAT:
        if prev is None:
            raise ValueError("Repeat mode without previous table")
        return prev, 0
    raise ValueError(f"bad sequence table mode {mode}")


def decode_sequences_section(
    data: bytes, prev: SeqDecodeTables | None
) -> tuple[Sequences | None, SeqDecodeTables | None, int]:
    """Decode a Sequences_Section (without executing it).

    Returns (sequences-with-offbases, tables-for-repeat, bytes_consumed).
    Offsets in the result are raw off_base values; repcode resolution happens
    during execution (it needs literal lengths, which we have here, so we
    resolve in execute_sequences).
    """
    nbseq, pos = read_nbseq(data)
    if nbseq == 0:
        return None, prev, pos
    modes = data[pos]
    pos += 1
    ll_mode = (modes >> 6) & 3
    of_mode = (modes >> 4) & 3
    ml_mode = (modes >> 2) & 3
    dt_ll, c = read_sequence_table(
        data[pos:], ll_mode, prev.ll if prev else None, LL_DEFAULT_NORM, LL_DEFAULT_LOG, 35
    )
    pos += c
    dt_of, c = read_sequence_table(
        data[pos:], of_mode, prev.of if prev else None, OF_DEFAULT_NORM, OF_DEFAULT_LOG, 31
    )
    pos += c
    dt_ml, c = read_sequence_table(
        data[pos:], ml_mode, prev.ml if prev else None, ML_DEFAULT_NORM, ML_DEFAULT_LOG, 52
    )
    pos += c

    reader = BackwardBitReader(data[pos:])
    st_ll = DecState(dt_ll, reader)
    st_of = DecState(dt_of, reader)
    st_ml = DecState(dt_ml, reader)

    lls = np.zeros(nbseq, dtype=np.uint32)
    mls = np.zeros(nbseq, dtype=np.uint32)
    obs = np.zeros(nbseq, dtype=np.uint32)
    for i in range(nbseq):
        ofc = st_of.peek_symbol()
        mlc = st_ml.peek_symbol()
        llc = st_ll.peek_symbol()
        off_value = (1 << ofc) + reader.read(ofc) if ofc > 0 else 1
        ml = int(ML_BASELINE[mlc]) + reader.read(int(ML_BITS[mlc]))
        ll = int(LL_BASELINE[llc]) + reader.read(int(LL_BITS[llc]))
        lls[i] = ll
        mls[i] = ml
        obs[i] = off_value
        if i != nbseq - 1:
            st_ll.update(reader)
            st_ml.update(reader)
            st_of.update(reader)
    if not reader.bits_consumed_ok():
        raise ValueError(f"sequence bitstream not fully consumed: {reader.bits_left} bits left")
    seqs = Sequences(lls, mls, obs, last_literals=0)
    return seqs, SeqDecodeTables(dt_ll, dt_of, dt_ml), pos + len(data[pos:])


# --- Sequence execution -------------------------------------------------------------


def execute_sequences(
    literals: bytes, seqs: Sequences | None, rep: list[int], window: bytes = b""
) -> tuple[bytes, list[int]]:
    """Regenerate block content from literals + sequences (RFC 8878 §3.1.1.4).

    `window` is previously-decoded history for cross-block matches.
    Returns (decoded_bytes, updated_rep).
    """
    if seqs is None or len(seqs) == 0:
        return literals, rep
    out = bytearray(window)
    wlen = len(window)
    lit_pos = 0
    for i in range(len(seqs)):
        ll = int(seqs.lit_lengths[i])
        ml = int(seqs.match_lengths[i])
        ob = int(seqs.off_bases[i])
        out += literals[lit_pos : lit_pos + ll]
        lit_pos += ll
        off, rep = resolve_offset(ob, ll, rep)
        if off > len(out):
            raise ValueError(f"corrupt: offset {off} exceeds window {len(out)}")
        start = len(out) - off
        if off >= ml:
            out += out[start : start + ml]
        else:
            for k in range(ml):  # overlapping copy
                out.append(out[start + k])
    out += literals[lit_pos:]
    return bytes(out[wlen:]), rep
