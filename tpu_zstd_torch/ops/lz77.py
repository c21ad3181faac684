"""Batched LZ77 match finding and greedy / lazy parse.

Counterpart of tpu_zstd/ops/lz77_jax.py on the path the port supports: the
windowed match finder (`mf_win_log` > 0, one packed sort key), the
non-optimal parse with lazy defer and the offset-cost gate, windowed
extraction, the same-offset merge and repcodes. Every array carries a leading
batch dimension (one row per block) where the JAX package vmaps per block.

The design is the JAX package's: previous-occurrence search as a sort of
(hash, pos) keys that carries the suffix words, depth-D candidates as the D
preceding sorted rows, a restore sort back to position order, and compaction
by sort. Sort keys are unique, so `torch.sort` on an int64 key plus a gather
of each payload gives the same order as the JAX package's unstable sorts.
Three Pallas TPU kernels on this path are CUDA kernels here: the greedy walk
(K3, ops/greedy.py), the segment concatenation (K2, ops/concat.py) and the
repcode walk (K4, ops/rep.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .concat import concat_varlen
from .fse import highbit32
from .greedy import greedy_segments
from .rep import rep_codes

HASH_PRIME = 2654435761
SEG_LOG = 10
M32 = 0xFFFFFFFF


class BlockSequences(NamedTuple):
    """Fixed-capacity per-block parse result (entries >= nseq are zero)."""

    ll: torch.Tensor      # (B, MS) int32 literal lengths
    ml: torch.Tensor      # (B, MS) int32 match lengths (>= min_match)
    ob: torch.Tensor      # (B, MS) int32 offset-base values (off+3 or repcode 1..3)
    off: torch.Tensor     # (B, MS) int32 resolved offsets
    starts: torch.Tensor  # (B, MS) int32 match start positions
    nseq: torch.Tensor    # (B,) int64
    lits: torch.Tensor    # (B, N) uint8 literal bytes, compacted to the front
    nlit: torch.Tensor    # (B,) int64 total literal count (== n - sum(ml))


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for a in [0, 2^32), in int64 without overflow: the
    product is split at 16 bits so each partial product stays below 2^48."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & M32


def _hash_words(block: torch.Tensor, hash_log: int):
    """4-byte little-endian words (u32 in int64) and Fibonacci hashes of the
    whole word (min_match 4) per position, for blocks (B, N); words wrap
    around each block's end."""
    b = block.to(torch.int64)
    w = (
        b
        | (torch.roll(b, -1, -1) << 8)
        | (torch.roll(b, -2, -1) << 16)
        | (torch.roll(b, -3, -1) << 24)
    )
    h = _mul32(w, HASH_PRIME) >> (32 - hash_log)
    return w, h


def _word_inc(x: torch.Tensor) -> torch.Tensor:
    """Matched byte count (0..4) from the XOR of two 4-byte LE words."""
    return torch.where(
        x == 0,
        4,
        ((x & 0xFF) == 0).to(torch.int64)
        + ((x & 0xFFFF) == 0).to(torch.int64)
        + ((x & 0xFFFFFF) == 0).to(torch.int64),
    )


def _sort_unique(key: torch.Tensor, *pays: torch.Tensor):
    """Ascending sort along the last axis by a UNIQUE key, carrying payloads."""
    skey, order = torch.sort(key, dim=-1)
    return (skey, *(torch.gather(p, -1, order) for p in pays))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _is_windowed(N: int, mf_win_log: int) -> bool:
    return 0 < mf_win_log < max(1, (N - 1).bit_length()) and N % (1 << mf_win_log) == 0


def find_matches(
    block: torch.Tensor,
    n: torch.Tensor,
    *,
    hash_log: int,
    depth: int,
    cap: int,
    mf_win_log: int,
    min_match: int = 4,
):
    """Best (capped) match per position within 2^mf_win_log windows.

    block (B, N) uint8, n (B,) payload lengths. Returns (best_ml, best_off),
    each (B, N) int64 in position order. Ties prefer the smallest offset.
    Candidate search is window-local; match content extends past window
    ends (words are formed on the whole block).
    """
    B, N = block.shape
    if not _is_windowed(N, mf_win_log) or hash_log + 1 + mf_win_log > 32:
        raise NotImplementedError("only the windowed, packed-key match finder is ported")
    dev = block.device
    nwords = cap // 4
    pos = torch.arange(N, device=dev)
    n = n.to(torch.int64)
    w, h = _hash_words(block, hash_log)
    live = pos < n[:, None] - (min_match - 1)
    W = 1 << mf_win_log
    nwin = N // W
    shape = (B, nwin, W)
    words = [torch.roll(w, -4 * k, -1).reshape(shape) for k in range(nwords)]
    h = h.reshape(shape)
    live = live.reshape(shape)
    lpos = torch.arange(W, device=dev)

    # Sort positions by (hash, pos) in one packed key; dead rows get the
    # sentinel hash 2^hash_log and keep their position order.
    key = (torch.where(live, h, 1 << hash_log) << mf_win_log) | lpos
    skey, *sw = _sort_unique(key, *words)
    sk = skey >> mf_win_log
    sp = skey & (W - 1)

    def _prev(x, d, fill):
        return torch.where(lpos < d, fill, torch.roll(x, d, -1))

    best_ml = torch.zeros(shape, dtype=torch.int64, device=dev)
    best_off = torch.zeros_like(best_ml)
    for d in range(1, depth + 1):
        same = _prev(sk, d, -1) == sk
        pp = _prev(sp, d, 0)
        ml = torch.zeros_like(best_ml)
        alive = same
        for k in range(nwords):
            x = sw[k] ^ _prev(sw[k], d, 0)
            ml = ml + torch.where(alive, _word_inc(x), 0)
            alive = alive & (x == 0)
        better = ml > best_ml
        best_ml = torch.where(better, ml, best_ml)
        best_off = torch.where(better, sp - pp, best_off)

    # Clamp to block end (also cancels false matches into rolled-around words).
    gsp = sp + (torch.arange(nwin, device=dev) << mf_win_log)[:, None]
    best_ml = torch.minimum(best_ml, torch.clamp(n[:, None, None] - gsp, min=0))

    # Back to position order: sp | ml | off pack into one unique int64 key
    # (the JAX package sorts a payload beside sp where this passes 31 bits;
    # the order is the same, sp being unique within a window).
    mlb = max(4, cap.bit_length())
    low_bits = mf_win_log + mlb
    key2 = (sp << low_bits) | (best_ml << mf_win_log) | best_off
    opk = torch.sort(key2, dim=-1).values.reshape(B, N)
    return (opk >> mf_win_log) & ((1 << mlb) - 1), opk & (W - 1)


def greedy_parse(step: torch.Tensor, matched: torch.Tensor, defer, seg: int):
    """Exact greedy (optionally 1-step lazy) parse of (B, N) positions in
    independent `seg`-byte segments (kernel K3). step[i] never crosses a
    segment boundary. Returns (is_seq, is_lit), each (B, N) bool."""
    B, N = step.shape
    d = torch.zeros_like(matched) if defer is None else defer
    packed = step.to(torch.int64) | (matched.to(torch.int64) << 11) | (d.to(torch.int64) << 12)
    out = greedy_segments(packed.to(torch.int32).reshape(B * (N // seg), seg)).reshape(B, N)
    return (out & 1) == 1, (out & 2) == 2


def parse_block(
    block: torch.Tensor,
    n: torch.Tensor,
    *,
    max_seqs: int,
    hash_log: int = 16,
    depth: int = 2,
    cap: int = 32,
    min_match: int = 4,
    lazy: bool = False,
    seg_log: int = SEG_LOG,
    of_gate: tuple[int, int] = (99, 99),
    mf_win_log: int,
) -> BlockSequences:
    """Greedy-parse blocks (B, N) uint8 with payload lengths n (B,) into
    sequences (the non-optimal, no-dictionary branch of the JAX parse)."""
    if min_match != 4:
        raise NotImplementedError("only min_match 4 is ported")
    B, N = block.shape
    dev = block.device
    n = n.to(torch.int64)
    pos = torch.arange(N, device=dev)
    in_block = pos < n[:, None]

    bml, boff = find_matches(
        block, n, hash_log=hash_log, depth=depth, cap=cap, mf_win_log=mf_win_log,
        min_match=min_match,
    )

    # Truncate matches at segment boundaries so segments parse independently;
    # the merge pass below re-joins same-offset continuations.
    seg = 1 << seg_log
    room = seg - (pos & (seg - 1))
    ml_t = torch.minimum(bml, room)
    matched = (ml_t >= min_match) & (boff > 0) & in_block
    if tuple(of_gate) != (99, 99):
        # Offset-cost gate: short matches at large offsets stay literals;
        # same-offset continuity is exempt.
        g4, g5 = of_gate
        ofc = highbit32(torch.clamp(boff, min=1))
        gate = (
            (ml_t >= 6)
            | ((ml_t == 4) & (ofc <= g4))
            | ((ml_t == 5) & (ofc <= g5))
            | (boff == torch.roll(boff, 1, -1))
        )
        matched = matched & gate
    step = torch.where(matched, ml_t, 1)
    defer = None
    if lazy:
        next_ml = torch.roll(ml_t, -1, -1)
        next_ml[:, -1] = 0
        next_matched = torch.roll(matched, -1, -1)
        next_matched[:, -1] = False
        defer = matched & next_matched & (next_ml > ml_t + 1)

    is_seq, is_lit = greedy_parse(step, matched, defer, seg)
    is_seq = is_seq & in_block
    is_lit = is_lit & in_block
    nseq = is_seq.sum(-1)
    nlit = is_lit.sum(-1)

    # Windowed extraction: per 2^ew_log window, one compaction sort puts
    # sequence rows first, then literal bytes; K2 joins the windows.
    pk = torch.where(is_seq, (ml_t << 21) | boff, block.to(torch.int64))
    ew_log = min(mf_win_log, 11)
    if not ((1 << ew_log) < N and N % (1 << ew_log) == 0):
        raise NotImplementedError("only windowed extraction is ported")
    W = 1 << ew_log
    nwin = N // W
    # Sequence starts per window are >= min_match apart: at most SC of them.
    SC = min(_ceil_div(_ceil_div(W, min_match), 128) * 128, W)
    lpos = torch.arange(W, device=dev)
    isq = is_seq.reshape(B, nwin, W)
    isl = is_lit.reshape(B, nwin, W)
    selk = torch.where(isq, lpos, torch.where(isl, W + lpos, 2 * W + lpos))
    e_key_w, e_pk_w = _sort_unique(selk, pk.reshape(B, nwin, W))
    nseq_w = isq.sum(-1)
    nlit_w = isl.sum(-1)
    startsw = e_key_w[..., :SC] + (torch.arange(nwin, device=dev) << ew_log)[:, None]
    pkw = e_pk_w[..., :SC]
    zero_w = torch.zeros_like(nseq_w)
    lits = concat_varlen((e_pk_w & 0xFF).to(torch.int32), nseq_w, nlit_w, N).to(torch.uint8)
    starts = concat_varlen(startsw.to(torch.int32), zero_w, nseq_w, max_seqs).to(torch.int64)
    pk_acc = concat_varlen(pkw.to(torch.int32), zero_w, nseq_w, max_seqs).to(torch.int64)
    mls = pk_acc >> 21
    offs = pk_acc & ((1 << 21) - 1)

    k = torch.arange(max_seqs, device=dev)
    valid = k < nseq[:, None]
    starts = torch.where(valid, starts, 0)
    mls = torch.where(valid, mls, 0)
    offs = torch.where(valid, offs, 0)

    ends = starts + mls
    prev_end = torch.roll(ends, 1, -1)
    prev_end[:, 0] = 0
    lls = torch.where(valid, starts - prev_end, 0)

    # Merge contiguous same-offset sequences: a head's merged length ends
    # where the next head's literal run begins; the last head ends at the
    # last valid row's match end.
    prev_off = torch.roll(offs, 1, -1)
    prev_off[:, 0] = 0
    cont = valid & (k > 0) & (lls == 0) & (offs == prev_off) & (offs > 0)
    head = valid & ~cont
    nseq2 = head.sum(-1)
    end_last = torch.where(valid, starts + mls, 0).amax(-1)
    mkey = torch.where(head, k, max_seqs + k)
    _, m_ll, m_off, m_start = _sort_unique(mkey, lls, offs, starts)
    valid2 = k < nseq2[:, None]
    next_begin = torch.where(
        k == nseq2[:, None] - 1,
        end_last[:, None],
        torch.roll(m_start, -1, -1) - torch.roll(m_ll, -1, -1),
    )
    ll2 = torch.where(valid2, m_ll, 0)
    off2 = torch.where(valid2, m_off, 0)
    starts2 = torch.where(valid2, m_start, 0)
    ml2 = torch.where(valid2, next_begin - m_start, 0)

    # Offset-base values with full repcode use (kernel K4).
    packed_rep = torch.where(valid2, off2 | ((ll2 > 0).to(torch.int64) << 21) | (1 << 22), 0)
    ob = rep_codes(packed_rep.to(torch.int32))

    i32 = torch.int32
    return BlockSequences(
        ll2.to(i32), ml2.to(i32), ob, off2.to(i32), starts2.to(i32), nseq2, lits, nlit
    )
