"""FSE (tANS) tables, RFC 8878 §4.1 (numpy, host side).

The port's copy of what it needs from tpu_zstd/format/fse.py: the encode
table (`spread_symbols`, `build_ctable`; they feed the predefined sequence
encode tables, ops/fse.py `EncTables`) and the decode side (`DTable`,
`build_dtable`, `DecState`, `read_ncount`, `fse_decompress_weights`; the
decoder's sequence tables and Huffman weights).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import FSE_MAX_TABLELOG, FSE_MIN_TABLELOG
from .bitstream import BackwardBitReader, ForwardBitReader


def _highbit(v: int) -> int:
    return int(v).bit_length() - 1


def spread_symbols(norm: np.ndarray, table_log: int) -> np.ndarray:
    """Assign a symbol to each of the 2**table_log states (RFC 8878 §4.1.1)."""
    table_size = 1 << table_log
    table = np.zeros(table_size, dtype=np.int32)
    high_threshold = table_size - 1
    # Low-probability (-1) symbols occupy the top states.
    for s, n in enumerate(norm):
        if n == -1:
            table[high_threshold] = s
            high_threshold -= 1
    step = (table_size >> 1) + (table_size >> 3) + 3
    mask = table_size - 1
    position = 0
    for s, n in enumerate(norm):
        for _ in range(max(int(n), 0)):
            table[position] = s
            position = (position + step) & mask
            while position > high_threshold:
                position = (position + step) & mask
    if position != 0:
        raise ValueError("symbol spread must cycle back to 0")
    return table


@dataclass
class CTable:
    """FSE encode table: Zstd-style symbol transform + next-state table."""

    table_log: int
    state_table: np.ndarray      # u16[table_size]: next state (value = table_size + u)
    delta_nb_bits: np.ndarray    # u32[num_symbols]
    delta_find_state: np.ndarray  # i32[num_symbols]


def build_ctable(norm: np.ndarray, table_log: int) -> CTable:
    table_size = 1 << table_log
    num_symbols = len(norm)
    spread = spread_symbols(norm, table_log)

    cumul = np.zeros(num_symbols + 1, dtype=np.int64)
    for s in range(num_symbols):
        cumul[s + 1] = cumul[s] + (1 if norm[s] == -1 else max(int(norm[s]), 0))

    state_table = np.zeros(table_size, dtype=np.uint16)
    fill = cumul[:num_symbols].copy()
    for u in range(table_size):
        s = spread[u]
        state_table[fill[s]] = table_size + u
        fill[s] += 1

    delta_nb_bits = np.zeros(num_symbols, dtype=np.uint32)
    delta_find_state = np.zeros(num_symbols, dtype=np.int32)
    total = 0
    for s in range(num_symbols):
        n = int(norm[s])
        if n == 0:
            # Unused symbol; fill with an impossible-but-safe value.
            delta_nb_bits[s] = ((table_log + 1) << 16) - table_size
            delta_find_state[s] = 0
        elif n in (-1, 1):
            delta_nb_bits[s] = (table_log << 16) - table_size
            delta_find_state[s] = total - 1
            total += 1
        else:
            max_bits_out = table_log - _highbit(n - 1)
            min_state_plus = n << max_bits_out
            delta_nb_bits[s] = (max_bits_out << 16) - min_state_plus
            delta_find_state[s] = total - n
            total += n
    return CTable(table_log, state_table, delta_nb_bits, delta_find_state)


@dataclass
class DTable:
    """FSE decode table: per state (symbol, nb_bits, new_state base)."""

    table_log: int
    symbol: np.ndarray     # i32[table_size]
    nb_bits: np.ndarray    # i32[table_size]
    new_state: np.ndarray  # i32[table_size] (base; add the bits read)

    @property
    def table_size(self) -> int:
        return 1 << self.table_log


def build_dtable(norm: np.ndarray, table_log: int) -> DTable:
    table_size = 1 << table_log
    spread = spread_symbols(norm, table_log)
    symbol_next = np.array([1 if n == -1 else max(int(n), 0) for n in norm], dtype=np.int64)
    symbol = np.zeros(table_size, dtype=np.int32)
    nb_bits = np.zeros(table_size, dtype=np.int32)
    new_state = np.zeros(table_size, dtype=np.int32)
    for u in range(table_size):
        s = spread[u]
        next_state = int(symbol_next[s])
        symbol_next[s] += 1
        bits = table_log - _highbit(next_state)
        symbol[u] = s
        nb_bits[u] = bits
        new_state[u] = (next_state << bits) - table_size
    return DTable(table_log, symbol, nb_bits, new_state)


class DecState:
    """One tANS decoder state stream over a DTable."""

    def __init__(self, dtable: DTable, reader: BackwardBitReader):
        self.dt = dtable
        self.state = reader.read(dtable.table_log)

    def peek_symbol(self) -> int:
        return int(self.dt.symbol[self.state])

    def update(self, reader: BackwardBitReader) -> int:
        """Return the current symbol and advance the state."""
        s = int(self.dt.symbol[self.state])
        bits = int(self.dt.nb_bits[self.state])
        self.state = int(self.dt.new_state[self.state]) + reader.read(bits)
        return s


def read_ncount(data: bytes, max_symbol: int = 255) -> tuple[np.ndarray, int, int]:
    """Parse an NCount header. Returns (norm, table_log, bytes_consumed)."""
    br = ForwardBitReader(data)
    table_log = br.read(4) + FSE_MIN_TABLELOG
    if table_log > FSE_MAX_TABLELOG:
        raise ValueError(f"FSE table log {table_log} too large")
    table_size = 1 << table_log
    remaining = table_size + 1
    threshold = table_size
    nb_bits = table_log + 1
    counts: list[int] = []
    previous0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if previous0:
            # Zero-run encoding.
            while br.peek(16) == 0xFFFF:
                br.skip(16)
                counts.extend([0] * 24)
            while br.peek(2) == 3:
                br.skip(2)
                counts.extend([0] * 3)
            counts.extend([0] * br.read(2))
            previous0 = False
            if len(counts) > max_symbol:
                break
        max_v = (2 * threshold - 1) - remaining
        low = br.peek(nb_bits - 1) & (threshold - 1)
        if low < max_v:
            count = low
            br.skip(nb_bits - 1)
        else:
            count = br.peek(nb_bits) & (2 * threshold - 1)
            if count >= threshold:
                count -= max_v
            br.skip(nb_bits)
        count -= 1  # back to -1..
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        while remaining < threshold and remaining > 1:
            nb_bits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError("corrupt NCount header: counts do not sum to table size")
    return np.array(counts, dtype=np.int32), table_log, br.bytes_consumed


def fse_decompress_weights(data: bytes, max_weights: int = 255) -> np.ndarray:
    """Decompress an FSE-compressed Huffman weight stream.

    Termination mirrors libzstd FSE_decompress_usingDTable: decode
    alternating states until the bitstream overdraws (permissive reader),
    then emit one final symbol from the other state.
    """
    norm, table_log, consumed = read_ncount(data, max_symbol=12)
    dt = build_dtable(norm, table_log)
    reader = BackwardBitReader(data[consumed:], permissive=True)
    s1 = DecState(dt, reader)
    s2 = DecState(dt, reader)
    out: list[int] = []
    while len(out) <= max_weights:
        out.append(s1.update(reader))
        if reader.overflowed:
            out.append(s2.peek_symbol())
            break
        out.append(s2.update(reader))
        if reader.overflowed:
            out.append(s1.peek_symbol())
            break
    if len(out) > max_weights:
        raise ValueError("too many Huffman weights")
    return np.array(out, dtype=np.int32)
