"""FSE (tANS) tables, RFC 8878 §4.1 (numpy, host side).

The port's copy of what it needs from tpu_zstd/format/fse.py: the encode
table (`spread_symbols`, `build_ctable`; they feed the predefined sequence
encode tables, ops/fse.py `EncTables`, and the host encoder), the host
encoder's `EncState`, `write_ncount`, `optimal_table_log`,
`normalize_counts` and `fse_compress_weights`, and the decode side
(`DTable`, `build_dtable`, `DecState`, `read_ncount`,
`fse_decompress_weights`; the decoder's sequence tables and Huffman
weights).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import (
    FSE_DEFAULT_TABLELOG,
    FSE_MAX_TABLELOG,
    FSE_MIN_TABLELOG,
    HUF_WEIGHT_FSE_LOG_MAX,
)
from .bitstream import BackwardBitReader, BackwardBitWriter, ForwardBitReader


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


class EncState:
    """One tANS encoder state stream over a CTable."""

    def __init__(self, ctable: CTable):
        self.ct = ctable
        self.value = 0

    def init(self, symbol: int) -> None:
        nb_bits_out = (int(self.ct.delta_nb_bits[symbol]) + (1 << 15)) >> 16
        v = (nb_bits_out << 16) - int(self.ct.delta_nb_bits[symbol])
        idx = (v >> nb_bits_out) + int(self.ct.delta_find_state[symbol])
        self.value = int(self.ct.state_table[idx])

    def encode(self, symbol: int, writer: BackwardBitWriter) -> None:
        nb_bits_out = (self.value + int(self.ct.delta_nb_bits[symbol])) >> 16
        writer.add_bits(self.value, nb_bits_out)
        idx = (self.value >> nb_bits_out) + int(self.ct.delta_find_state[symbol])
        self.value = int(self.ct.state_table[idx])

    def flush(self, writer: BackwardBitWriter) -> None:
        writer.add_bits(self.value, self.ct.table_log)


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


def write_ncount(norm: np.ndarray, table_log: int) -> bytes:
    """Serialize a normalized-count FSE table description."""
    table_size = 1 << table_log
    bit_stream = 0
    bit_count = 0
    out = bytearray()

    def emit(value: int, nbits: int) -> None:
        nonlocal bit_stream, bit_count
        bit_stream |= value << bit_count
        bit_count += nbits
        while bit_count >= 16:
            out.append(bit_stream & 0xFF)
            out.append((bit_stream >> 8) & 0xFF)
            bit_stream >>= 16
            bit_count -= 16

    emit(table_log - FSE_MIN_TABLELOG, 4)
    remaining = table_size + 1
    threshold = table_size
    nb_bits = table_log + 1
    symbol = 0
    previous0 = False
    while remaining > 1:
        if previous0:
            start = symbol
            while symbol < len(norm) and norm[symbol] == 0:
                symbol += 1
            while symbol >= start + 24:
                emit(0xFFFF, 16)
                start += 24
            while symbol >= start + 3:
                emit(3, 2)
                start += 3
            emit(symbol - start, 2)
            previous0 = False
        if symbol >= len(norm):
            raise ValueError("normalized counts do not sum to table size")
        count = int(norm[symbol])
        symbol += 1
        max_v = (2 * threshold - 1) - remaining
        remaining -= abs(count)
        count += 1  # +1 so that -1 ("less than 1") encodes as 0
        if count >= threshold:
            count += max_v
        emit(count, nb_bits - 1 if count < max_v else nb_bits)
        previous0 = count == 1
        while remaining < threshold:
            nb_bits -= 1
            threshold >>= 1
    while bit_count > 0:  # flush the rest, padded to a byte
        out.append(bit_stream & 0xFF)
        bit_stream >>= 8
        bit_count -= 8
    return bytes(out)


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


def optimal_table_log(max_table_log: int, src_size: int, max_symbol: int) -> int:
    if max_table_log == 0:
        max_table_log = FSE_DEFAULT_TABLELOG
    table_log = max_table_log
    max_bits_src = _highbit(max(src_size - 1, 1)) - 2
    if max_bits_src < table_log:
        table_log = max_bits_src
    min_bits_src = _highbit(max(src_size - 1, 1)) + 1
    min_bits_symbols = _highbit(max(max_symbol, 1)) + 2
    min_bits = min(min_bits_src, min_bits_symbols)
    if min_bits > table_log:
        table_log = min_bits
    return int(np.clip(table_log, FSE_MIN_TABLELOG, FSE_MAX_TABLELOG))


def normalize_counts(counts: np.ndarray, table_log: int, total: int) -> np.ndarray:
    """Normalize frequencies to sum to 2**table_log; -1 marks low-probability
    symbols. Largest remainder with a low-probability floor: every present
    symbol gets a nonzero normalized count."""
    counts = np.asarray(counts, dtype=np.int64)
    table_size = 1 << table_log
    assert total == int(counts.sum()) and total > 0
    present = counts > 0
    low_threshold = total >> table_log

    norm = np.zeros(len(counts), dtype=np.int32)
    lowprob = present & (counts <= low_threshold)  # weight-1 states
    norm[lowprob] = -1
    distributable = table_size - int(lowprob.sum())
    rest = present & ~lowprob
    rest_total = int(counts[rest].sum())
    if rest_total > 0 and distributable > 0:
        scaled = counts[rest].astype(np.float64) * distributable / rest_total
        base = np.floor(scaled).astype(np.int64)
        base = np.maximum(base, 1)
        remainder = scaled - base
        deficit = distributable - int(base.sum())
        idx = np.argsort(-remainder, kind="stable")
        if deficit > 0:
            base[idx[:deficit]] += 1
        elif deficit < 0:
            # Take from the symbols with the most slack (largest base first).
            order = np.argsort(-base, kind="stable")
            k = 0
            while deficit < 0:
                j = order[k % len(order)]
                if base[j] > 1:
                    base[j] -= 1
                    deficit += 1
                k += 1
                if k > 10 * len(order) + 16:
                    raise ValueError("normalization failed")
        norm[np.nonzero(rest)[0]] = base.astype(np.int32)
    elif distributable > 0:
        # Everything was low probability: promote the most frequent symbols.
        order = np.argsort(-counts, kind="stable")
        promoted = 0
        for j in order:
            if norm[j] == -1 and promoted < distributable:
                norm[j] = 2  # one extra state over the -1 floor
                promoted += 1
        s = int(np.where(norm == -1, 1, norm).sum())  # -1 counts as 1
        norm[order[0]] += table_size - s
    s = int(np.where(norm == -1, 1, norm).sum())
    if s != table_size:  # final fix-up on the largest symbol
        j = int(np.argmax(np.where(norm > 0, norm, 0)))
        norm[j] += table_size - s
        if norm[j] <= 0:
            raise ValueError("normalization failed: cannot fix up")
    return norm


def fse_compress_weights(weights: np.ndarray) -> bytes | None:
    """Compress a Huffman weight stream with interleaved 2-state FSE; None
    when it is degenerate or not smaller (the caller writes the direct 4-bit
    form)."""
    weights = np.asarray(weights, dtype=np.int64)
    n = len(weights)
    if n <= 1:
        return None
    max_symbol = int(weights.max())
    counts = np.bincount(weights, minlength=max_symbol + 1).astype(np.int64)
    if (counts > 0).sum() < 2:
        return None  # RLE-degenerate; the direct form handles it
    table_log = optimal_table_log(HUF_WEIGHT_FSE_LOG_MAX, n, max_symbol)
    norm = normalize_counts(counts, table_log, n)
    header = write_ncount(norm, table_log)
    ct = build_ctable(norm, table_log)
    w = BackwardBitWriter()
    # Interleaved 2-state encoding, backward over the weights, in libzstd's
    # FSE_compress_usingCTable order: an odd count inits s1 with the last
    # symbol, an even one s2; the loop encodes s2 then s1; s2 is flushed
    # first, so the decoder reads s1's state first.
    s1 = EncState(ct)
    s2 = EncState(ct)
    i = n
    if i & 1:
        s1.init(int(weights[i - 1]))
        s2.init(int(weights[i - 2]))
        s1.encode(int(weights[i - 3]), w)
        i -= 3
    else:
        s2.init(int(weights[i - 1]))
        s1.init(int(weights[i - 2]))
        i -= 2
    while i > 0:
        s2.encode(int(weights[i - 1]), w)
        s1.encode(int(weights[i - 2]), w)
        i -= 2
    s2.flush(w)
    s1.flush(w)
    payload = header + w.close()
    if len(payload) >= (n + 1) // 2:  # not smaller than the direct form
        return None
    return payload


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
