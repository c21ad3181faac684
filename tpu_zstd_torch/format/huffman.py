"""Huffman literal decoding, RFC 8878 §4.2 (numpy, host side).

The port's copy of the decode side of tpu_zstd/format/huffman.py: weight
headers (direct 4-bit or FSE-compressed), the implied last weight, the
decode table, and the 1- and 4-stream literal decoders. Streams are read
backward; a decode step peeks table_log bits (zero-filled past the stream
start, as libzstd does), looks up (symbol, nb_bits) and consumes nb_bits.

`decode_stream` reads a few bytes at the cursor per symbol instead of
shifting one big integer of the whole stream, so it runs in time linear in
the stream; its results and errors are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import HUF_MAX_BITS, highbit32
from .fse import fse_decompress_weights


def weights_to_lengths(weights: np.ndarray) -> tuple[np.ndarray, int]:
    """Weights (implied last one included) -> code lengths and table_log;
    checks the Kraft equality the format implies."""
    weights = np.asarray(weights, dtype=np.int64)
    if (weights < 0).any() or len(weights) == 0:
        raise ValueError("bad Huffman weights")
    total = int(np.sum(np.where(weights > 0, 1 << np.maximum(weights - 1, 0), 0)))
    if total == 0 or (total & (total - 1)) != 0:
        raise ValueError("Huffman weights do not sum to a power of two")
    table_log = highbit32(total)
    if table_log > HUF_MAX_BITS + 1:
        raise ValueError("Huffman table log too large")
    lengths = np.where(weights > 0, table_log + 1 - weights, 0).astype(np.int32)
    return lengths, table_log


def complete_implied_weight(explicit: np.ndarray) -> np.ndarray:
    """Append the implied last weight (RFC 8878 §4.2.1.3)."""
    explicit = np.asarray(explicit, dtype=np.int64)
    total = int(np.sum(np.where(explicit > 0, 1 << np.maximum(explicit - 1, 0), 0)))
    if total == 0:
        raise ValueError("all-zero Huffman weights")
    rest = (1 << (highbit32(total) + 1)) - total
    if rest <= 0 or (rest & (rest - 1)) != 0:
        raise ValueError("corrupt Huffman weights (implied weight not a power of 2)")
    return np.concatenate([explicit, [highbit32(rest) + 1]]).astype(np.int32)


@dataclass
class HufDTable:
    table_log: int
    symbol: np.ndarray   # per table entry
    nb_bits: np.ndarray


def parse_weights(data: bytes) -> tuple[np.ndarray, int]:
    """Parse a weight header. Returns (full weights incl. the implied one,
    bytes consumed)."""
    hdr = data[0]
    if hdr < 128:  # FSE-compressed weights
        explicit = fse_decompress_weights(data[1 : 1 + hdr])
        consumed = 1 + hdr
    else:
        num = hdr - 127
        explicit = np.zeros(num, dtype=np.int32)
        for i in range(num):
            b = data[1 + i // 2]
            explicit[i] = (b >> 4) if i % 2 == 0 else (b & 0xF)
        consumed = 1 + (num + 1) // 2
    return complete_implied_weight(explicit), consumed


def build_dtable(weights: np.ndarray) -> HufDTable:
    """Decode table: index = next table_log bits of the stream -> (symbol,
    nb_bits). Symbols are laid out by weight, longest codes at the low
    indices, natural order within a weight (the canonical assignment)."""
    lengths, table_log = weights_to_lengths(weights)
    size = 1 << table_log
    symbol = np.zeros(size, dtype=np.int32)
    nb_bits = np.zeros(size, dtype=np.int32)
    rank_count = np.bincount(weights, minlength=table_log + 2)
    rank_start = np.zeros(table_log + 2, dtype=np.int64)
    next_start = 0
    for w in range(1, table_log + 1):
        rank_start[w] = next_start
        next_start += int(rank_count[w]) << (w - 1)
    if next_start != size:
        raise ValueError("corrupt Huffman weights (table underfilled)")
    fill = rank_start.copy()
    for s in range(len(weights)):
        w = int(weights[s])
        if w == 0:
            continue
        span = 1 << (w - 1)
        symbol[fill[w] : fill[w] + span] = s
        nb_bits[fill[w] : fill[w] + span] = table_log + 1 - w
        fill[w] += span
    return HufDTable(table_log, symbol, nb_bits)


def decode_stream(data: bytes, dt: HufDTable, out_len: int) -> bytes:
    """Decode one backward Huffman bitstream into out_len symbols."""
    if len(data) == 0:
        raise ValueError("empty bitstream")
    if data[-1] == 0:
        raise ValueError("corrupt bitstream: zero padding byte")
    bits_left = (len(data) - 1) * 8 + data[-1].bit_length() - 1
    tl = dt.table_log
    mask = (1 << tl) - 1
    entry = [(int(s), int(n)) for s, n in zip(dt.symbol, dt.nb_bits)]
    buf = bytes(data) + b"\x00\x00\x00"
    out = bytearray(out_len)
    for i in range(out_len):
        lo = bits_left - tl
        if lo >= 0:
            b = lo >> 3
            idx = (int.from_bytes(buf[b : b + 3], "little") >> (lo & 7)) & mask
        elif bits_left > 0:
            idx = (int.from_bytes(buf[:3], "little") & ((1 << bits_left) - 1)) << -lo
        else:
            idx = 0
        out[i], nb = entry[idx]
        bits_left -= nb
        if bits_left < -8:
            raise ValueError("Huffman stream overrun")
    if bits_left != 0:
        raise ValueError("Huffman stream not fully consumed")
    return bytes(out)


def decode_literals_4stream(data: bytes, dt: HufDTable, regen_size: int) -> bytes:
    if len(data) < 6:
        raise ValueError("4-stream literals too short")
    s1 = int.from_bytes(data[0:2], "little")
    s2 = int.from_bytes(data[2:4], "little")
    s3 = int.from_bytes(data[4:6], "little")
    body = data[6:]
    if s1 + s2 + s3 > len(body):
        raise ValueError("corrupt jump table")
    seg = (regen_size + 3) // 4
    sizes_out = [seg, seg, seg, regen_size - 3 * seg]
    if sizes_out[3] <= 0:
        raise ValueError("corrupt 4-stream regenerated size")
    chunks = [body[:s1], body[s1 : s1 + s2], body[s1 + s2 : s1 + s2 + s3], body[s1 + s2 + s3 :]]
    return b"".join(decode_stream(c, dt, m) for c, m in zip(chunks, sizes_out))
