"""Host-side LZ77 match finding (hash-chain greedy / lazy parse).

The port's copy of tpu_zstd/format/lz77.py, the parse of the host
compressor (`format/frame.py compress`): a classic sequential hash chain,
where the device pipeline (ops/lz77.py) finds matches with sorts.
"""

from __future__ import annotations

import numpy as np

from .sequences import Sequences, offsets_to_offbases

HASH_PRIME = 2654435761


def hash4(v: int, hash_log: int) -> int:
    """Fibonacci hash of a 4-byte little-endian word."""
    return ((v * HASH_PRIME) & 0xFFFFFFFF) >> (32 - hash_log)


def _match_length(data: bytes, a: int, b: int, limit: int) -> int:
    """Length of common prefix of data[a:] and data[b:], capped at limit."""
    n = 0
    while n < limit and data[a + n] == data[b + n]:
        n += 1
    return n


def find_sequences_greedy(
    data: bytes,
    hash_log: int = 16,
    search_depth: int = 8,
    min_match: int = 4,
    lazy: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Greedy (optionally 1-step lazy) parse of one block.

    Returns (lit_lengths, match_lengths, offsets, last_literals); offsets are
    actual distances (repcode conversion happens at encode time).
    """
    n = len(data)
    words = np.zeros(n, dtype=np.uint32)
    if n >= 4:
        arr = np.frombuffer(data, dtype=np.uint8).astype(np.uint32)
        words[: n - 3] = arr[: n - 3] | (arr[1 : n - 2] << 8) | (arr[2 : n - 1] << 16) | (arr[3:] << 24)
    hashes = ((words * np.uint32(HASH_PRIME)) >> np.uint32(32 - hash_log)).astype(np.int64)

    head = {}  # hash -> most recent position
    prev = np.full(n, -1, dtype=np.int64)  # chain links

    lls: list[int] = []
    mls: list[int] = []
    offs: list[int] = []

    def best_match(i: int) -> tuple[int, int]:
        limit = n - i
        h = int(hashes[i])
        j = head.get(h, -1)
        depth = search_depth
        bl, bo = 0, 0
        while j >= 0 and depth > 0:
            if data[j] == data[i]:
                length = _match_length(data, j, i, limit)
                if length > bl:
                    bl, bo = length, i - j
            j = int(prev[j])
            depth -= 1
        return bl, bo

    def insert(i: int) -> None:
        h = int(hashes[i])
        prev[i] = head.get(h, -1)
        head[h] = i

    i = 0
    anchor = 0
    while i + min_match <= n:
        blen, boff = best_match(i)
        insert(i)
        if blen < min_match:
            i += 1
            continue
        if lazy and i + 1 + min_match <= n:
            blen2, boff2 = best_match(i + 1)
            if blen2 > blen + 1:
                i += 1
                insert(i)
                blen, boff = blen2, boff2
        lls.append(i - anchor)
        mls.append(blen)
        offs.append(boff)
        # Sparse insertion inside the match (2 interior probes keep chains useful).
        end = i + blen
        for p in (i + 1, end - 2):
            if i < p < end and p + min_match <= n:
                insert(p)
        i = end
        anchor = end
    return (
        np.array(lls, dtype=np.uint32),
        np.array(mls, dtype=np.uint32),
        np.array(offs, dtype=np.uint32),
        n - anchor,
    )


def parse_block(data: bytes, rep: list[int], **kw) -> tuple[Sequences | None, list[int]]:
    """Parse one block into Sequences with repcode-converted offsets."""
    lls, mls, offs, last = find_sequences_greedy(data, **kw)
    if len(lls) == 0:
        return None, rep
    obs, rep = offsets_to_offbases(offs, lls, tuple(rep))
    return Sequences(lls, mls, obs, last), rep
