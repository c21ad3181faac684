"""XXH64, streaming XXH64, XXH32 and the frame content checksum (RFC 8878
§3.1.1: low 32 bits of XXH64(content, seed=0)), host side.

The port's copy of `xxh32`, `xxh64`, `XXH64State` and `content_checksum`
from tpu_zstd/format/xxhash.py. `content_checksum` runs the native XXH64
(utils/native.py) as the reference's does; the pure-Python functions are
its fallback where no C++ compiler exists, and take seconds over a few MB.
"""

from __future__ import annotations

import numpy as np

_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1

P64_1 = 0x9E3779B185EBCA87
P64_2 = 0xC2B2AE3D27D4EB4F
P64_3 = 0x165667B19E3779F9
P64_4 = 0x85EBCA77C2B2AE63
P64_5 = 0x27D4EB2F165667C5

P32_1 = 0x9E3779B1
P32_2 = 0x85EBCA77
P32_3 = 0xC2B2AE3D
P32_4 = 0x27D4EB2F
P32_5 = 0x165667B1


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def _round64(acc: int, inp: int) -> int:
    acc = (acc + inp * P64_2) & _M64
    acc = _rotl64(acc, 31)
    return (acc * P64_1) & _M64


def _merge_round64(acc: int, val: int) -> int:
    val = _round64(0, val)
    acc ^= val
    return (acc * P64_1 + P64_4) & _M64


def xxh64(data: bytes | bytearray | memoryview | np.ndarray, seed: int = 0) -> int:
    if isinstance(data, np.ndarray):
        data = data.astype(np.uint8).tobytes()
    data = bytes(data)
    n = len(data)
    pos = 0
    if n >= 32:
        v1 = (seed + P64_1 + P64_2) & _M64
        v2 = (seed + P64_2) & _M64
        v3 = seed & _M64
        v4 = (seed - P64_1) & _M64
        nstripes = n // 32
        # Vectorized lane processing: numpy object-free path using python ints
        # per stripe (lanes are a strict sequential chain; see header docstring).
        words = np.frombuffer(data[: nstripes * 32], dtype="<u8").reshape(nstripes, 4)
        for k in range(nstripes):
            w = words[k]
            v1 = _round64(v1, int(w[0]))
            v2 = _round64(v2, int(w[1]))
            v3 = _round64(v3, int(w[2]))
            v4 = _round64(v4, int(w[3]))
        pos = nstripes * 32
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)) & _M64
        h = _merge_round64(h, v1)
        h = _merge_round64(h, v2)
        h = _merge_round64(h, v3)
        h = _merge_round64(h, v4)
    else:
        h = (seed + P64_5) & _M64
    h = (h + n) & _M64
    while pos + 8 <= n:
        k1 = _round64(0, int.from_bytes(data[pos : pos + 8], "little"))
        h ^= k1
        h = (_rotl64(h, 27) * P64_1 + P64_4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= (int.from_bytes(data[pos : pos + 4], "little") * P64_1) & _M64
        h = (_rotl64(h, 23) * P64_2 + P64_3) & _M64
        pos += 4
    while pos < n:
        h ^= (data[pos] * P64_5) & _M64
        h = (_rotl64(h, 11) * P64_1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * P64_2) & _M64
    h ^= h >> 29
    h = (h * P64_3) & _M64
    h ^= h >> 32
    return h


def xxh32(data: bytes | bytearray | memoryview | np.ndarray, seed: int = 0) -> int:
    if isinstance(data, np.ndarray):
        data = data.astype(np.uint8).tobytes()
    data = bytes(data)
    n = len(data)
    pos = 0
    if n >= 16:
        v1 = (seed + P32_1 + P32_2) & _M32
        v2 = (seed + P32_2) & _M32
        v3 = seed & _M32
        v4 = (seed - P32_1) & _M32
        nstripes = n // 16
        words = np.frombuffer(data[: nstripes * 16], dtype="<u4").reshape(nstripes, 4)
        for k in range(nstripes):
            w = words[k]
            v1 = (_rotl32((v1 + int(w[0]) * P32_2) & _M32, 13) * P32_1) & _M32
            v2 = (_rotl32((v2 + int(w[1]) * P32_2) & _M32, 13) * P32_1) & _M32
            v3 = (_rotl32((v3 + int(w[2]) * P32_2) & _M32, 13) * P32_1) & _M32
            v4 = (_rotl32((v4 + int(w[3]) * P32_2) & _M32, 13) * P32_1) & _M32
        pos = nstripes * 16
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & _M32
    else:
        h = (seed + P32_5) & _M32
    h = (h + n) & _M32
    while pos + 4 <= n:
        h = (h + int.from_bytes(data[pos : pos + 4], "little") * P32_3) & _M32
        h = (_rotl32(h, 17) * P32_4) & _M32
        pos += 4
    while pos < n:
        h = (h + data[pos] * P32_5) & _M32
        h = (_rotl32(h, 11) * P32_1) & _M32
        pos += 1
    h ^= h >> 15
    h = (h * P32_2) & _M32
    h ^= h >> 13
    h = (h * P32_3) & _M32
    h ^= h >> 16
    return h


class XXH64State:
    """Streaming XXH64: accumulate arbitrary chunks, digest at any point.
    Matches xxh64() bit for bit."""

    __slots__ = ("_v", "_buf", "_total", "_seed")

    def __init__(self, seed: int = 0) -> None:
        self.reset(seed)

    def reset(self, seed: int = 0) -> None:
        self._seed = seed & _M64
        self._v = [
            (seed + P64_1 + P64_2) & _M64,
            (seed + P64_2) & _M64,
            seed & _M64,
            (seed - P64_1) & _M64,
        ]
        self._buf = b""
        self._total = 0

    def update(self, data: bytes | bytearray | memoryview | np.ndarray) -> None:
        if isinstance(data, np.ndarray):
            data = data.astype(np.uint8).tobytes()
        data = self._buf + bytes(data)
        self._total += len(data) - len(self._buf)
        nstripes = len(data) // 32
        if nstripes:
            v1, v2, v3, v4 = self._v
            words = np.frombuffer(data[: nstripes * 32], dtype="<u8").reshape(-1, 4)
            for k in range(nstripes):
                w = words[k]
                v1 = _round64(v1, int(w[0]))
                v2 = _round64(v2, int(w[1]))
                v3 = _round64(v3, int(w[2]))
                v4 = _round64(v4, int(w[3]))
            self._v = [v1, v2, v3, v4]
        self._buf = data[nstripes * 32 :]

    def digest(self) -> int:
        v1, v2, v3, v4 = self._v
        if self._total >= 32:
            h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)) & _M64
            h = _merge_round64(h, v1)
            h = _merge_round64(h, v2)
            h = _merge_round64(h, v3)
            h = _merge_round64(h, v4)
        else:
            h = (self._seed + P64_5) & _M64
        h = (h + self._total) & _M64
        data, n, pos = self._buf, len(self._buf), 0
        while pos + 8 <= n:
            k1 = _round64(0, int.from_bytes(data[pos : pos + 8], "little"))
            h ^= k1
            h = (_rotl64(h, 27) * P64_1 + P64_4) & _M64
            pos += 8
        if pos + 4 <= n:
            h ^= (int.from_bytes(data[pos : pos + 4], "little") * P64_1) & _M64
            h = (_rotl64(h, 23) * P64_2 + P64_3) & _M64
            pos += 4
        while pos < n:
            h ^= (data[pos] * P64_5) & _M64
            h = (_rotl64(h, 11) * P64_1) & _M64
            pos += 1
        h ^= h >> 33
        h = (h * P64_2) & _M64
        h ^= h >> 29
        h = (h * P64_3) & _M64
        h ^= h >> 32
        return h


def content_checksum(data: bytes) -> int:
    """Frame content checksum: low 32 bits of XXH64(content, 0)."""
    from ..utils.native import xxh64 as native_xxh64

    return native_xxh64(data, 0) & 0xFFFFFFFF
