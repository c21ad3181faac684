"""Zstandard frame header writer, RFC 8878 §3.1.1.1 (host side).

The port's copy of `write_frame_header` from tpu_zstd/format/frame.py, less
the dictionary ID, which no caller of the port sets.
"""

from __future__ import annotations

from ..constants import BLOCK_SIZE_MAX, ZSTD_MAGIC


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
