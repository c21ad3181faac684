"""Huffman literals codec, RFC 8878 §4.2 (numpy, host side).

The port's copy of tpu_zstd/format/huffman.py. Encode side, for the host
compressor: length-limited code lengths (package-merge), weights and their
header (FSE-compressed or direct 4-bit), canonical codes, the 1- and
4-stream encoders and `compress_literals`. Decode side: weight headers, the
implied last weight, the decode table, and the 1- and 4-stream literal
decoders. Streams are written in reverse position order and read
backward; a decode step peeks table_log bits (zero-filled past the stream
start, as libzstd does), looks up (symbol, nb_bits) and consumes nb_bits.

`decode_stream` hands streams of more than 256 symbols to the native
decoder (utils/native.py `huf_decode_stream`), as the reference does; the
Python chain decodes short streams and any stream the native decoder finds
malformed, so errors keep their Python diagnostics. The chain reads a few
bytes at the cursor per symbol instead of shifting one big integer of the
whole stream, so it runs in time linear in the stream; its results and
errors are the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..constants import HUF_MAX_BITS, highbit32
from .bitstream import BackwardBitWriter
from .fse import fse_compress_weights, fse_decompress_weights


def package_merge_lengths(freqs: np.ndarray, max_bits: int) -> np.ndarray:
    """Optimal length-limited code lengths via package-merge.

    freqs: int64[num_symbols], zeros allowed. Returns lengths (0 for absent).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    present = np.nonzero(freqs > 0)[0]
    n = len(present)
    lengths = np.zeros(len(freqs), dtype=np.int32)
    if n == 0:
        return lengths
    if n == 1:
        lengths[present[0]] = 1
        return lengths
    if (1 << max_bits) < n:
        raise ValueError("max_bits too small for alphabet")
    # Package-merge: maintain a list of (weight, symbol-multiset-as-counts).
    # Track per-item symbol counts as arrays over `present` indices.
    base = [(int(freqs[s]), i) for i, s in enumerate(present)]
    base.sort()
    packages: list[tuple[int, np.ndarray]] = []
    for level in range(max_bits):
        items: list[tuple[int, np.ndarray]] = []
        for w, i in base:
            v = np.zeros(n, dtype=np.int32)
            v[i] = 1
            items.append((w, v))
        items.extend(packages)
        items.sort(key=lambda t: t[0])
        # Pair up adjacent items into packages for the next level.
        packages = []
        for k in range(0, len(items) - 1, 2):
            packages.append((items[k][0] + items[k + 1][0], items[k][1] + items[k + 1][1]))
    # Take the first n-1 packages; each symbol's length = times it appears.
    counts = np.zeros(n, dtype=np.int32)
    for w, v in packages[: n - 1]:
        counts += v
    lengths[present] = counts
    return lengths


def lengths_to_weights(lengths: np.ndarray) -> tuple[np.ndarray, int]:
    """Code lengths -> zstd weights. Returns (weights, table_log)."""
    lengths = np.asarray(lengths, dtype=np.int32)
    table_log = int(lengths.max())
    weights = np.where(lengths > 0, table_log + 1 - lengths, 0).astype(np.int32)
    return weights, table_log




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


def assign_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical code values: longest codes smallest, natural order within length."""
    lengths = np.asarray(lengths, dtype=np.int32)
    max_bits = int(lengths.max())
    nb_per_rank = np.bincount(lengths, minlength=max_bits + 2)
    val_per_rank = np.zeros(max_bits + 2, dtype=np.int64)
    min_v = 0
    for nbits in range(max_bits, 0, -1):
        val_per_rank[nbits] = min_v
        min_v += int(nb_per_rank[nbits])
        min_v >>= 1
    codes = np.zeros(len(lengths), dtype=np.int64)
    counters = val_per_rank.copy()
    for s in range(len(lengths)):
        if lengths[s] > 0:
            codes[s] = counters[lengths[s]]
            counters[lengths[s]] += 1
    return codes


@dataclass
class HufCTable:
    lengths: np.ndarray  # i32[256]
    codes: np.ndarray    # i64[256]
    table_log: int
    header: bytes        # serialized weights (tree description)


@dataclass
class HufDTable:
    table_log: int
    symbol: np.ndarray   # per table entry
    nb_bits: np.ndarray


def build_ctable(freqs: np.ndarray, max_bits: int = HUF_MAX_BITS) -> HufCTable | None:
    """Build encode table + serialized tree. None if <2 symbols present."""
    freqs = np.asarray(freqs, dtype=np.int64)
    if (freqs > 0).sum() < 2:
        return None
    # Cap table log like zstd: at most log2(#symbols rounded up) + 1 budget.
    lengths = package_merge_lengths(freqs, max_bits)
    weights, table_log = lengths_to_weights(lengths)
    header = serialize_weights(weights)
    if header is None:
        return None
    codes = assign_codes(lengths)
    return HufCTable(lengths, codes, table_log, header)


def serialize_weights(weights: np.ndarray) -> bytes | None:
    """Weight table header: FSE-compressed if smaller, else direct 4-bit.

    Returns None when the table is not serializable (>128 explicit weights
    and FSE did not help); callers fall back to Raw/RLE literals.
    """
    weights = np.asarray(weights, dtype=np.int32)
    last = int(np.max(np.nonzero(weights > 0)[0]))
    explicit = weights[:last]  # last present symbol's weight is implied
    num = len(explicit)
    fse = fse_compress_weights(explicit) if num >= 2 else None
    if fse is not None and len(fse) < 128 and (num > 128 or len(fse) < (num + 1) // 2 + 1):
        return bytes([len(fse)]) + fse
    if num > 128:
        return None
    out = bytearray([127 + num])
    for i in range(0, num, 2):
        hi = int(explicit[i]) & 0xF
        lo = int(explicit[i + 1]) & 0xF if i + 1 < num else 0
        out.append((hi << 4) | lo)
    return bytes(out)


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


def encode_stream(data: bytes, ct: HufCTable) -> bytes:
    """Encode one literal stream (symbols emitted in reverse position order)."""
    w = BackwardBitWriter()
    codes = ct.codes
    lengths = ct.lengths
    arr = np.frombuffer(data, dtype=np.uint8)
    for i in range(len(arr) - 1, -1, -1):
        s = arr[i]
        w.add_bits(int(codes[s]), int(lengths[s]))
        w.flush()
    return w.close()


def decode_stream(data: bytes, dt: HufDTable, out_len: int) -> bytes:
    """Decode one backward Huffman bitstream into out_len symbols (natively
    past 256 symbols where the stream is well formed)."""
    if out_len > 256:
        from ..utils.native import huf_decode_stream

        packed = (dt.symbol.astype(np.int32) << 8) | dt.nb_bits.astype(np.int32)
        fast = huf_decode_stream(data, packed, dt.table_log, out_len)
        if fast is not None:
            return fast
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


def encode_literals_4stream(data: bytes, ct: HufCTable) -> bytes | None:
    """4-stream Huffman payload: 6-byte jump table + 4 streams (RFC §3.1.1.3.1.6)."""
    n = len(data)
    if n < 4:
        return None
    seg = (n + 3) // 4
    parts = [data[i * seg : min((i + 1) * seg, n)] for i in range(4)]
    if any(len(p) == 0 for p in parts):
        return None
    streams = [encode_stream(p, ct) for p in parts]
    if any(len(s) > 0xFFFF for s in streams):
        return None
    jump = b"".join(len(s).to_bytes(2, "little") for s in streams[:3])
    return jump + b"".join(streams)


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


def compress_literals(
    data: bytes, prefer_4stream: bool = True
) -> tuple[bytes, bool, HufCTable] | None:
    """Huffman-compress a literal payload.

    Returns (tree_description + streams, used_4stream, ctable), or None when
    incompressible / degenerate (caller emits Raw/RLE literals instead).
    """
    freqs = np.bincount(np.frombuffer(data, dtype=np.uint8), minlength=256).astype(np.int64)
    ct = build_ctable(freqs)
    if ct is None:
        return None
    use4 = prefer_4stream and len(data) >= 256
    payload = encode_literals_4stream(data, ct) if use4 else None
    if payload is None:
        payload = encode_stream(data, ct)
        use4 = False
    total = len(ct.header) + len(payload)
    if total >= len(data):
        return None
    return ct.header + payload, use4, ct
