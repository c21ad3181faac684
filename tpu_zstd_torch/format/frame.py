"""Zstandard frames, RFC 8878 §3.1 (host side): headers, the literals
section, and the host codec.

The port's copy of tpu_zstd/format/frame.py: `write_frame_header`, `parse_frame_header`,
the literals section's writers and `decode_literals_section`, the host
compressor (`compress`: the hash-chain parse of format/lz77.py, Huffman or
raw literals, predefined-table sequences) and the host decoder
(`decompress`, concatenated and skippable frames included). Both are pure
Python: a few hundred KB a second.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..constants import (
    BLOCK_COMPRESSED,
    BLOCK_RAW,
    BLOCK_RLE,
    BLOCK_SIZE_MAX,
    LIT_COMPRESSED,
    LIT_RAW,
    LIT_RLE,
    REPCODE_INIT,
    SKIPPABLE_MAGIC_MAX,
    SKIPPABLE_MAGIC_MIN,
    ZSTD_MAGIC,
)
from . import huffman
from .lz77 import parse_block
from .sequences import (
    SeqDecodeTables,
    decode_sequences_section,
    encode_sequences_section,
    execute_sequences,
)
from .xxhash import content_checksum


@dataclass
class FrameHeader:
    content_size: int | None = None
    window_size: int | None = None
    single_segment: bool = False
    has_checksum: bool = False
    dict_id: int = 0
    header_size: int = 0


def write_frame_header(
    content_size: int | None,
    checksum: bool = False,
    dict_id: int = 0,
    window_log: int | None = None,
) -> bytes:
    """Frame_Header per RFC 8878 §3.1.1.1 (single segment up to 1 MiB of
    content unless an explicit window_log is given; a dictionary ID of 1,
    2 or 4 bytes unless dict_id is 0)."""
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
    if dict_id == 0:
        did_flag, did_bytes = 0, b""
    elif dict_id <= 0xFF:
        did_flag, did_bytes = 1, dict_id.to_bytes(1, "little")
    elif dict_id <= 0xFFFF:
        did_flag, did_bytes = 2, dict_id.to_bytes(2, "little")
    else:
        did_flag, did_bytes = 3, dict_id.to_bytes(4, "little")
    fhd = (fcs_flag << 6) | (int(single_segment) << 5) | (int(checksum) << 2) | did_flag
    out.append(fhd)
    if not single_segment:
        if window_log is None:
            cs = content_size if content_size else BLOCK_SIZE_MAX * 8
            window_log = max(10, min(31, int(cs - 1).bit_length()))
        out.append((window_log - 10) << 3)  # mantissa 0
    out += did_bytes
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


def write_literals_raw(literals: bytes) -> bytes:
    n = len(literals)
    if n < 32:
        hdr = bytes([(n << 3) | LIT_RAW])
    elif n < 4096:
        v = (n << 4) | (1 << 2) | LIT_RAW
        hdr = v.to_bytes(2, "little")
    else:
        v = (n << 4) | (3 << 2) | LIT_RAW
        hdr = v.to_bytes(3, "little")
    return hdr + literals


def write_literals_rle(byte: int, n: int) -> bytes:
    if n < 32:
        hdr = bytes([(n << 3) | LIT_RLE])
    elif n < 4096:
        hdr = ((n << 4) | (1 << 2) | LIT_RLE).to_bytes(2, "little")
    else:
        hdr = ((n << 4) | (3 << 2) | LIT_RLE).to_bytes(3, "little")
    return hdr + bytes([byte])


def write_literals_compressed(regen: int, payload: bytes, four_stream: bool) -> bytes:
    """Header for Compressed_Literals_Block (sizes include tree description)."""
    comp = len(payload)
    if not four_stream:
        size_format = 0
        assert regen < 1024 and comp < 1024
        v = LIT_COMPRESSED | (size_format << 2) | (regen << 4) | (comp << 14)
        hdr = v.to_bytes(3, "little")
    elif regen < 1024 and comp < 1024:
        v = LIT_COMPRESSED | (1 << 2) | (regen << 4) | (comp << 14)
        hdr = v.to_bytes(3, "little")
    elif regen < 16384 and comp < 16384:
        v = LIT_COMPRESSED | (2 << 2) | (regen << 4) | (comp << 18)
        hdr = v.to_bytes(4, "little")
    else:
        v = LIT_COMPRESSED | (3 << 2) | (regen << 4) | (comp << 22)
        hdr = v.to_bytes(5, "little")
    return hdr + payload


def compress_literals_section(literals: bytes, enable_huffman: bool) -> bytes:
    """Pick the best literals representation (Raw / RLE / Huffman-compressed)."""
    n = len(literals)
    if n == 0:
        return write_literals_raw(b"")
    if n >= 2 and literals.count(literals[0]) == n:
        return write_literals_rle(literals[0], n)
    if enable_huffman and n >= 64:
        result = huffman.compress_literals(literals)
        if result is not None:
            payload, four, _ct = result
            hdr_cost = 5 if n >= 16384 else 4
            if len(payload) + hdr_cost < n + (1 if n < 32 else 2 if n < 4096 else 3):
                if four or (n < 1024 and len(payload) < 1024):
                    return write_literals_compressed(n, payload, four)
    return write_literals_raw(literals)


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


@dataclass
class CompressParams:
    level: int = 3
    hash_log: int = 16
    search_depth: int = 8
    min_match: int = 4
    lazy: bool = False
    enable_huffman: bool = True
    block_size: int = BLOCK_SIZE_MAX
    checksum: bool = False
    window_log: int | None = None


def compress_block_body(
    block: bytes, rep: list[int], params: CompressParams
) -> tuple[bytes | None, list[int]]:
    """Compressed_Block body (literals + sequences) or None if not smaller."""
    seqs, rep_out = parse_block(
        block,
        rep,
        hash_log=params.hash_log,
        search_depth=params.search_depth,
        min_match=params.min_match,
        lazy=params.lazy,
    )
    if seqs is None:
        literals = block
        body = compress_literals_section(literals, params.enable_huffman) + b"\x00"
        if len(body) >= len(block):
            return None, rep
        return body, rep
    # Literals = bytes not covered by matches.
    lit_parts = []
    pos = 0
    for i in range(len(seqs)):
        ll = int(seqs.lit_lengths[i])
        lit_parts.append(block[pos : pos + ll])
        pos += ll + int(seqs.match_lengths[i])
    lit_parts.append(block[pos:])
    literals = b"".join(lit_parts)
    body = compress_literals_section(literals, params.enable_huffman)
    body += encode_sequences_section(seqs)
    if len(body) >= len(block):
        return None, rep
    return body, rep_out


def compress(data: bytes, params: CompressParams | None = None) -> bytes:
    """Single-shot host-reference compression. Output decodable by libzstd."""
    params = params or CompressParams()
    out = bytearray(
        write_frame_header(len(data), checksum=params.checksum, window_log=params.window_log)
    )
    n = len(data)
    bs = params.block_size
    nblocks = max(1, (n + bs - 1) // bs)
    rep = list(REPCODE_INIT)
    for b in range(nblocks):
        block = data[b * bs : min((b + 1) * bs, n)]
        last = 1 if b == nblocks - 1 else 0
        if len(block) >= 2 and block.count(block[0]) == len(block):
            hdr = (len(block) << 3) | (BLOCK_RLE << 1) | last
            out += hdr.to_bytes(3, "little")
            out.append(block[0])
            continue
        body, rep = compress_block_body(block, rep, params)
        if body is None:
            hdr = (len(block) << 3) | (BLOCK_RAW << 1) | last
            out += hdr.to_bytes(3, "little")
            out += block
        else:
            hdr = (len(body) << 3) | (BLOCK_COMPRESSED << 1) | last
            out += hdr.to_bytes(3, "little")
            out += body
    if params.checksum:
        out += content_checksum(data).to_bytes(4, "little")
    return bytes(out)


def decompress(data: bytes, verify_checksum: bool = True) -> bytes:
    """Host-reference decoder for (concatenated) zstd frames."""
    out_all = bytearray()
    pos = 0
    while pos < len(data):
        magic = int.from_bytes(data[pos : pos + 4], "little")
        if SKIPPABLE_MAGIC_MIN <= magic <= SKIPPABLE_MAGIC_MAX:
            size = int.from_bytes(data[pos + 4 : pos + 8], "little")
            pos += 8 + size
            continue
        frame_out, consumed = decompress_frame(data[pos:], verify_checksum)
        out_all += frame_out
        pos += consumed
    return bytes(out_all)


def decompress_frame_with_window(
    data: bytes, window: bytes, verify_checksum: bool = True
) -> bytes:
    """Decode one frame with pre-existing window history (dictionary mode)."""
    return _decompress_frame_impl(data, window, verify_checksum)[0]


def decompress_frame(data: bytes, verify_checksum: bool = True) -> tuple[bytes, int]:
    return _decompress_frame_impl(data, b"", verify_checksum)


def _decompress_frame_impl(
    data: bytes, window: bytes, verify_checksum: bool
) -> tuple[bytes, int]:
    hdr = parse_frame_header(data)
    pos = hdr.header_size
    out = bytearray()
    rep = list(REPCODE_INIT)
    seq_tables: SeqDecodeTables | None = None
    huff_table: huffman.HufDTable | None = None
    while True:
        if pos + 3 > len(data):
            raise ValueError("truncated frame: missing block header")
        bh = int.from_bytes(data[pos : pos + 3], "little")
        pos += 3
        last = bh & 1
        btype = (bh >> 1) & 3
        bsize = bh >> 3
        if pos + (1 if btype == BLOCK_RLE else bsize) > len(data):
            raise ValueError("truncated frame: block body exceeds input")
        if btype == BLOCK_RAW:
            out += data[pos : pos + bsize]
            pos += bsize
        elif btype == BLOCK_RLE:
            out += bytes([data[pos]]) * bsize
            pos += 1
        elif btype == BLOCK_COMPRESSED:
            body = data[pos : pos + bsize]
            pos += bsize
            lit = decode_literals_section(body, huff_table)
            huff_table = lit.huff_table
            seqs, seq_tables_new, _ = decode_sequences_section(body[lit.consumed :], seq_tables)
            if seqs is not None:
                seq_tables = seq_tables_new
            decoded, rep = execute_sequences(lit.data, seqs, rep, window=window + bytes(out))
            out += decoded
        else:
            raise ValueError("reserved block type")
        if last:
            break
    if hdr.has_checksum:
        stored = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        if verify_checksum and stored != content_checksum(bytes(out)):
            raise ValueError("content checksum mismatch")
    if hdr.content_size is not None and len(out) != hdr.content_size:
        raise ValueError(f"content size mismatch: {len(out)} != {hdr.content_size}")
    return bytes(out), pos
