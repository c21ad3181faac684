"""Decode-acceleration metadata: a skippable frame of FSE decoder
checkpoints, appended to a zstd frame.

The port's copy of tpu_zstd/format/accel.py (`write_accel_frame`,
`parse_accel_tail`, byte for byte the same format). Stock libzstd stops at
the end of the real frame and skips the trailing skippable frame, so the
frames stay interoperable; the port's decoder (api/decompress.py) reads the
checkpoints to decode each block in independent chunks:

Payload layout (little-endian), version 4:
  u32 tag 'TZCK' (0x4B435A54), u8 version = 4, u8 flags (0),
  u16 stride (sequences per chunk), u16 lit_stride (literal symbols per
  chunk), u16 nblocks;
  per block:
    u32 nseq, u16 nchunks (checkpoint records; chunk 0 has none),
    u8 blk_flags (bit0: reps are u32, set only when a rep >= 2^24),
    nchunks x u32 states (ll | of<<10 | ml<<20),
    u32 bits[0], then (nchunks-1) x u16 deltas bits[c-1] - bits[c]
        (unread-bit cursors before the chunk's first sequence),
    nchunks x 3 x u24 reps (u32 with blk_flags bit0): the decoder's repeat
        offset triple before the chunk's first sequence (RFC 8878 §3.1.1.5),
    u16 nck_lit (Huffman-literal checkpoint records per stream; 0 when the
        block's literals are not 4-stream Huffman),
    4 x { u32 cursor[0], (nck_lit-1) x u16 deltas }: per stream, the
        unread-bit cursor before forward symbol c * lit_stride;
  u32 total accel-frame size (the metadata is parsed from the end).

The writer forward-fills zero literal records so the deltas stay below
2^16; a filled record belongs to a chunk with no symbols, which the
decoder never starts (ops/decode_lanes.py reads each stream by cursor and
never uses a record as a chunk's end bound).
"""

from __future__ import annotations

import struct

import numpy as np

SKIPPABLE_MAGIC = 0x184D2A50
ACCEL_TAG = 0x4B435A54  # 'TZCK'
ACCEL_VERSION = 4

_EMPTY_LIT = np.zeros((4, 0), np.uint32)


class AccelMetadata:
    __slots__ = ("stride", "lit_stride", "flags", "blocks")

    def __init__(self, stride: int, lit_stride: int, flags: int, blocks: list):
        self.stride = stride
        self.lit_stride = lit_stride
        self.flags = flags
        # blocks: list of (nseq, bits u32[nck], states u32[nck],
        #                  rep u32[nck,3], lit_ck u32[4, nck_lit])
        self.blocks = blocks


def _u16_deltas(pos: np.ndarray, what: str) -> np.ndarray:
    """Bit-position deltas between neighbouring checkpoints as u16; raises
    ValueError where one does not fit (a stride too long for its chunk)."""
    d = pos[:-1].astype(np.int64) - pos[1:].astype(np.int64)
    bad = d[(d < 0) | (d > 0xFFFF)]
    if bad.size:
        raise ValueError(f"{what} checkpoint delta {int(bad[0])} does not fit in 16 bits "
                         "(checkpoint stride too long)")
    return d.astype(np.uint16)


def write_accel_frame(
    stride: int,
    blocks: list,
    flags: int = 0,
    lit_stride: int = 512,
) -> bytes:
    """Serialize checkpoints for one frame's blocks as a skippable frame.

    blocks: per block (nseq, ck_bits, ck_states, ck_rep[, lit_ck]) —
    bits/states shaped (nck,), ck_rep shaped (nck, 3), lit_ck shaped
    (4, nck_lit); all trimmed to the chunk count for that block (may be
    empty for Raw/RLE/no-seq blocks).
    """
    parts = [
        struct.pack(
            "<IBBHHH", ACCEL_TAG, ACCEL_VERSION, flags, stride, lit_stride, len(blocks)
        )
    ]
    for blk in blocks:
        nseq, bits, states, reps = blk[:4]
        lit_ck = blk[4] if len(blk) > 4 else _EMPTY_LIT
        nck = len(bits)
        reps = np.asarray(reps, np.uint32).reshape(nck, 3)
        wide = bool(nck) and bool((reps >= (1 << 24)).any())
        parts.append(struct.pack("<IHB", nseq, nck, 1 if wide else 0))
        if nck:
            bits = np.asarray(bits, np.uint32)
            parts.append(states.astype(np.uint32).tobytes())
            deltas = _u16_deltas(bits, "sequence")
            parts.append(struct.pack("<I", int(bits[0])) + deltas.tobytes())
            if wide:
                parts.append(np.ascontiguousarray(reps).tobytes())
            else:
                r24 = np.ascontiguousarray(reps).view(np.uint8).reshape(-1, 4)
                parts.append(np.ascontiguousarray(r24[:, :3]).tobytes())
        lit_ck = np.asarray(lit_ck, np.uint32).reshape(4, -1)
        nl = lit_ck.shape[1]
        parts.append(struct.pack("<H", nl))
        if nl:
            for s4 in range(4):
                row = lit_ck[s4].copy()
                # Invalid-chunk tails are zero; forward-fill so deltas stay
                # within a chunk's bit span (< 2^16). Tail chunks decode
                # garbage the decoder masks past nsym either way.
                for i in range(1, nl):
                    if row[i] == 0:
                        row[i] = row[i - 1]
                parts.append(struct.pack("<I", int(row[0])))
                parts.append(_u16_deltas(row, "literal").tobytes())
    body = b"".join(parts)
    total = 8 + len(body) + 4
    return struct.pack("<II", SKIPPABLE_MAGIC, len(body) + 4) + body + struct.pack("<I", total)


def parse_accel_tail(data: bytes) -> tuple[AccelMetadata | None, int]:
    """Parse a TRAILING accel skippable frame.

    Returns (metadata, frame_end) where data[:frame_end] is the original zstd
    frame; (None, len(data)) when no valid metadata trailer is present.
    """
    n = len(data)
    if n < 22:
        return None, n
    (total,) = struct.unpack_from("<I", data, n - 4)
    if total < 22 or total > n:
        return None, n
    start = n - total
    magic, size = struct.unpack_from("<II", data, start)
    if not (0x184D2A50 <= magic <= 0x184D2A5F) or size != total - 8:
        return None, n
    payload = data[start + 8 : n - 4]
    if len(payload) < 12:
        return None, n
    tag, version, flags, stride, lit_stride, nblocks = struct.unpack_from(
        "<IBBHHH", payload, 0
    )
    if tag != ACCEL_TAG or version != ACCEL_VERSION:
        return None, n
    pos = 12
    blocks = []
    for _ in range(nblocks):
        if pos + 7 > len(payload):
            return None, n
        nseq, nck, bflags = struct.unpack_from("<IHB", payload, pos)
        pos += 7
        wide = bflags & 1
        rep_w = 4 if wide else 3
        need = nck * 4 + (4 + 2 * (nck - 1) if nck else 0) + 3 * rep_w * nck
        if pos + need + 2 > len(payload):
            return None, n
        if nck:
            states = np.frombuffer(payload, np.uint32, nck, pos).copy()
            pos += 4 * nck
            (b0,) = struct.unpack_from("<I", payload, pos)
            deltas = np.frombuffer(payload, np.uint16, nck - 1, pos + 4)
            bits = np.empty(nck, np.uint32)
            bits[0] = b0
            if nck > 1:
                bits[1:] = b0 - np.cumsum(deltas.astype(np.uint32))
            pos += 4 + 2 * (nck - 1)
            if wide:
                reps = np.frombuffer(payload, np.uint32, 3 * nck, pos).reshape(nck, 3).copy()
            else:
                r8 = np.frombuffer(payload, np.uint8, 9 * nck, pos).reshape(nck, 3, 3)
                reps = (
                    r8[..., 0].astype(np.uint32)
                    | (r8[..., 1].astype(np.uint32) << 8)
                    | (r8[..., 2].astype(np.uint32) << 16)
                )
            pos += 3 * rep_w * nck
        else:
            states = np.empty(0, np.uint32)
            bits = np.empty(0, np.uint32)
            reps = np.zeros((0, 3), np.uint32)
        (nck_lit,) = struct.unpack_from("<H", payload, pos)
        pos += 2
        lit_bytes = 4 * (4 + 2 * (nck_lit - 1)) if nck_lit else 0
        if pos + lit_bytes > len(payload):
            return None, n
        if nck_lit:
            lit_ck = np.empty((4, nck_lit), np.uint32)
            for s4 in range(4):
                (c0,) = struct.unpack_from("<I", payload, pos)
                d = np.frombuffer(payload, np.uint16, nck_lit - 1, pos + 4)
                lit_ck[s4, 0] = c0
                if nck_lit > 1:
                    lit_ck[s4, 1:] = c0 - np.cumsum(d.astype(np.uint32))
                pos += 4 + 2 * (nck_lit - 1)
        else:
            lit_ck = _EMPTY_LIT
        blocks.append((nseq, bits, states, reps, lit_ck))
    return AccelMetadata(stride, lit_stride, flags, blocks), start
