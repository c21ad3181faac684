"""Zstandard bitstream writer and readers, RFC 8878 §4.1 (host side).

The port's copy of `BackwardBitWriter`, `BackwardBitReader` and
`ForwardBitReader` from tpu_zstd/format/bitstream.py. Entropy payloads are
written forward, LSB-first, and read backward: the last byte carries a
sentinel 1-bit above the last data bit, and fields come out
most-recently-written first. FSE table headers (NCount) are read forward.
"""

from __future__ import annotations


class BackwardBitWriter:
    """Accumulates LSB-first bits; decoders read the byte stream backward."""

    def __init__(self) -> None:
        self._container = 0
        self._nbits = 0
        self._bytes = bytearray()

    def add_bits(self, value: int, nbits: int) -> None:
        if nbits == 0:
            return
        assert nbits <= 56, "flush before exceeding container"
        self._container |= (value & ((1 << nbits) - 1)) << self._nbits
        self._nbits += nbits
        if self._nbits >= 56:
            self.flush()

    def flush(self) -> None:
        """Flush whole bytes out of the container."""
        nbytes = self._nbits >> 3
        for _ in range(nbytes):
            self._bytes.append(self._container & 0xFF)
            self._container >>= 8
        self._nbits -= nbytes * 8

    def close(self) -> bytes:
        """Write the sentinel 1-bit and pad to a byte boundary."""
        self.add_bits(1, 1)
        self.flush()
        if self._nbits > 0:
            self._bytes.append(self._container & 0xFF)
            self._container = 0
            self._nbits = 0
        return bytes(self._bytes)

    def bit_position(self) -> int:
        return len(self._bytes) * 8 + self._nbits


class BackwardBitReader:
    """Reads a backward bitstream; `read(n)` returns bits in the order the
    decoder consumes them (most-recently-written first)."""

    def __init__(self, data: bytes, permissive: bool = False) -> None:
        if len(data) == 0:
            raise ValueError("empty bitstream")
        last = data[-1]
        if last == 0:
            raise ValueError("corrupt bitstream: zero padding byte")
        sentinel_pos = last.bit_length() - 1
        self._bits_left = (len(data) - 1) * 8 + sentinel_pos
        self._value = int.from_bytes(data, "little") & ((1 << self._bits_left) - 1)
        # Permissive mode mirrors libzstd's BIT_DStream: reads past the start
        # return zero-filled bits and set the overflow flag instead of raising.
        self._permissive = permissive
        self.overflowed = False

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        if nbits > self._bits_left:
            if not self._permissive:
                raise ValueError("bitstream overrun")
            # Zero-fill the missing low bits (the stream start is the low end).
            have = max(self._bits_left, 0)
            v = (self._value & ((1 << have) - 1)) << (nbits - have) if have > 0 else 0
            self._bits_left -= nbits
            self.overflowed = True
            return v
        self._bits_left -= nbits
        return (self._value >> self._bits_left) & ((1 << nbits) - 1)

    def peek_padded(self, nbits: int) -> int:
        """The next nbits without consuming them, zero-filled past the start
        (libzstd's shifted-container lookup near the stream end)."""
        have = max(self._bits_left, 0)
        if have >= nbits:
            return (self._value >> (self._bits_left - nbits)) & ((1 << nbits) - 1)
        if have == 0:
            return 0
        return (self._value & ((1 << have) - 1)) << (nbits - have)

    def skip(self, nbits: int) -> None:
        self._bits_left -= nbits
        if self._bits_left < 0:
            self.overflowed = True

    def bits_consumed_ok(self) -> bool:
        return self._bits_left == 0

    @property
    def bits_left(self) -> int:
        return self._bits_left


class ForwardBitReader:
    """LSB-first forward bitstream reader (FSE table headers, RFC 8878
    §4.1.1)."""

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._bitpos = 0

    def read(self, nbits: int) -> int:
        if nbits == 0:
            return 0
        start_byte = self._bitpos >> 3
        end_byte = (self._bitpos + nbits + 7) >> 3
        if end_byte > len(self._data):
            # Reads slightly past the declared end see zeros.
            chunk = self._data[start_byte:] + b"\x00" * (end_byte - len(self._data))
        else:
            chunk = self._data[start_byte:end_byte]
        v = int.from_bytes(chunk, "little") >> (self._bitpos & 7)
        self._bitpos += nbits
        return v & ((1 << nbits) - 1)

    def peek(self, nbits: int) -> int:
        pos = self._bitpos
        v = self.read(nbits)
        self._bitpos = pos
        return v

    def skip(self, nbits: int) -> None:
        self._bitpos += nbits

    @property
    def bytes_consumed(self) -> int:
        return (self._bitpos + 7) >> 3
