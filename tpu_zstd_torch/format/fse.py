"""FSE (tANS) encode-table construction, RFC 8878 §4.1 (numpy, host side).

The port's copy of `spread_symbols` and `build_ctable` from
tpu_zstd/format/fse.py; they feed the predefined sequence encode tables
(ops/fse.py `EncTables`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
