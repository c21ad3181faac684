"""Zstandard frame headers and the literals section, RFC 8878 §3.1.1 (host).

The port's copy from tpu_zstd/format/frame.py of `write_frame_header`
(less the dictionary ID, which no caller of the port sets),
`parse_frame_header` and `decode_literals_section` with their records.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import BLOCK_SIZE_MAX, LIT_COMPRESSED, LIT_RAW, LIT_RLE, ZSTD_MAGIC
from . import huffman


@dataclass
class FrameHeader:
    content_size: int | None = None
    window_size: int | None = None
    single_segment: bool = False
    has_checksum: bool = False
    dict_id: int = 0
    header_size: int = 0


def write_frame_header(
    content_size: int | None, checksum: bool = False, window_log: int | None = None
) -> bytes:
    """Frame_Header per RFC 8878 §3.1.1.1 (no dictionary ID; single segment
    up to 1 MiB of content unless an explicit window_log is given)."""
    out = bytearray(ZSTD_MAGIC.to_bytes(4, "little"))
    single_segment = (
        content_size is not None and content_size <= (1 << 20) and window_log is None
    )
    if content_size is None:
        fcs_flag = 0
        fcs_bytes = b""
    elif content_size <= 255 and single_segment:
        fcs_flag = 0
        fcs_bytes = content_size.to_bytes(1, "little")
    elif 256 <= content_size <= 65535 + 256:
        fcs_flag = 1
        fcs_bytes = (content_size - 256).to_bytes(2, "little")
    elif content_size <= 0xFFFFFFFF:
        fcs_flag = 2
        fcs_bytes = content_size.to_bytes(4, "little")
    else:
        fcs_flag = 3
        fcs_bytes = content_size.to_bytes(8, "little")
    fhd = (fcs_flag << 6) | (int(single_segment) << 5) | (int(checksum) << 2)
    out.append(fhd)
    if not single_segment:
        if window_log is None:
            cs = content_size if content_size else BLOCK_SIZE_MAX * 8
            window_log = max(10, min(31, int(cs - 1).bit_length()))
        out.append((window_log - 10) << 3)  # mantissa 0
    out += fcs_bytes
    return bytes(out)


def parse_frame_header(data: bytes) -> FrameHeader:
    if len(data) < 5:
        raise ValueError("truncated frame header")
    magic = int.from_bytes(data[:4], "little")
    if magic != ZSTD_MAGIC:
        raise ValueError(f"bad magic 0x{magic:08X}")
    fhd = data[4]
    fcs_flag = fhd >> 6
    single_segment = bool((fhd >> 5) & 1)
    if (fhd >> 3) & 1:
        raise ValueError("reserved FHD bit set")
    has_checksum = bool((fhd >> 2) & 1)
    did_flag = fhd & 3
    pos = 5
    window_size = None
    if not single_segment:
        wd = data[pos]
        pos += 1
        base = 1 << (10 + (wd >> 3))
        window_size = base + (base // 8) * (wd & 7)
    dict_id = 0
    did_len = (0, 1, 2, 4)[did_flag]
    if did_len:
        dict_id = int.from_bytes(data[pos : pos + did_len], "little")
        pos += did_len
    fcs_len = (0, 2, 4, 8)[fcs_flag]
    if fcs_flag == 0 and single_segment:
        fcs_len = 1
    content_size = None
    if fcs_len:
        content_size = int.from_bytes(data[pos : pos + fcs_len], "little")
        if fcs_len == 2:
            content_size += 256
        pos += fcs_len
    if single_segment:
        window_size = content_size
    return FrameHeader(content_size, window_size, single_segment, has_checksum, dict_id, pos)


@dataclass
class LiteralsOut:
    data: bytes
    consumed: int
    huff_table: huffman.HufDTable | None  # table used (kept for treeless blocks)


def decode_literals_section(data: bytes, prev_table: huffman.HufDTable | None) -> LiteralsOut:
    b0 = data[0]
    lit_type = b0 & 3
    size_format = (b0 >> 2) & 3
    if lit_type in (LIT_RAW, LIT_RLE):
        if size_format in (0, 2):
            regen, pos = b0 >> 3, 1
        elif size_format == 1:
            regen, pos = int.from_bytes(data[:2], "little") >> 4, 2
        else:
            regen, pos = int.from_bytes(data[:3], "little") >> 4, 3
        if lit_type == LIT_RAW:
            return LiteralsOut(bytes(data[pos : pos + regen]), pos + regen, prev_table)
        return LiteralsOut(bytes([data[pos]]) * regen, pos + 1, prev_table)
    # Compressed / treeless
    if size_format in (0, 1):
        v = int.from_bytes(data[:3], "little")
        regen, comp, pos = (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 3
    elif size_format == 2:
        v = int.from_bytes(data[:4], "little")
        regen, comp, pos = (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4
    else:
        v = int.from_bytes(data[:5], "little")
        regen, comp, pos = (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 5
    streams = 1 if size_format == 0 else 4
    payload = data[pos : pos + comp]
    if lit_type == LIT_COMPRESSED:
        weights, consumed = huffman.parse_weights(payload)
        table = huffman.build_dtable(weights)
        payload = payload[consumed:]
    else:  # treeless: reuse the previous table
        if prev_table is None:
            raise ValueError("treeless literals without previous Huffman table")
        table = prev_table
    if streams == 1:
        lit = huffman.decode_stream(payload, table, regen)
    else:
        lit = huffman.decode_literals_4stream(payload, table, regen)
    return LiteralsOut(lit, pos + comp, table)
