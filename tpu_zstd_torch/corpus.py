"""Deterministic mixed benchmark corpus.

The port's copy of `make_corpus` from the repo's bench.py (a Silesia-like
mix of text, structured records, binary numeric data, random bytes and a
repetitive part); a test holds the two byte-equal.
"""

from __future__ import annotations

import numpy as np


def make_corpus(total_bytes: int) -> bytes:
    """Deterministic mixed corpus with Silesia-like composition.

    Parts are generated long enough to fill total_bytes WITHOUT wholesale
    self-duplication (an earlier `blob += blob` fill made the corpus one
    giant self-copy at ~total/2 distance — unrepresentative of Silesia and
    measuring window reach instead of matching quality)."""
    rng = np.random.default_rng(0x51E51A)
    parts: list[bytes] = []
    # english-ish markov text (dickens/webster stand-in)
    words = (
        b"the of and to a in that it is was for on are with as his they be at "
        b"one have this from or had by hot word but what some we can out other "
        b"were all there when up use your how said an each she which do their "
        b"time if will way about many then them write would like so these her "
        b"long make thing see him two has look more day could go come did number"
    ).split()
    state = 7
    text = []
    for _ in range(total_bytes // 4 // 6 + total_bytes // 16):
        state = (state * 1103515245 + 12345) & 0x7FFFFFFF
        text.append(words[state % len(words)])
    parts.append(b" ".join(text))
    # structured records (xml/database stand-in)
    rec = b'<row id="%06d" val="%08x" flag="true"><name>item-%04d</name></row>\n'
    parts.append(b"".join(rec % (i, i * 2654435761 % (1 << 32), i % 3000)
                          for i in range(total_bytes // 4 // 64 + total_bytes // 1024)))
    # binary numeric data (mr/sao stand-in: correlated doubles)
    walk = np.cumsum(rng.normal(0, 1, total_bytes // 8 // 4 + total_bytes // 64)).astype(np.float32)
    parts.append(walk.tobytes())
    # hard-to-compress (x-ray stand-in)
    parts.append(rng.integers(0, 256, total_bytes // 8, dtype=np.uint8).tobytes())
    # repetitive (nci stand-in)
    parts.append((b"c1ccccc1 CC(=O)Nc1ccc(O)cc1 " * (total_bytes // 8 // 28 + 1)))
    blob = b"".join(parts)
    if len(blob) < total_bytes:  # safety fill: unique random, never a self-copy
        blob += rng.integers(0, 256, total_bytes - len(blob), dtype=np.uint8).tobytes()
    return blob[:total_bytes]
