"""Sequence-section headers and decode tables, RFC 8878 §3.1.1.3.2 (host).

The port's copy of the decode-table half of tpu_zstd/format/sequences.py:
the nbSeq varint, one symbol table per compression mode (predefined, RLE,
FSE with an NCount header, repeat), and the three tables a block hands to
the next for Repeat mode. The bitstream itself is decoded on the device
(ops/decode.py, ops/decode_lanes.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    LL_DEFAULT_LOG,
    LL_DEFAULT_NORM,
    ML_DEFAULT_LOG,
    ML_DEFAULT_NORM,
    OF_DEFAULT_LOG,
    OF_DEFAULT_NORM,
    SEQ_FSE,
    SEQ_PREDEFINED,
    SEQ_REPEAT,
    SEQ_RLE,
)
from .fse import DTable, build_dtable, read_ncount

_PREDEF_DT: dict[str, DTable] = {}


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


def read_nbseq(data: bytes) -> tuple[int, int]:
    b0 = data[0]
    if b0 < 128:
        return b0, 1
    if b0 < 255:
        return ((b0 - 0x80) << 8) + data[1], 2
    return data[1] + (data[2] << 8) + 0x7F00, 3


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
    """Parse one symbol table per its compression mode. Returns (dtable,
    bytes consumed)."""
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
