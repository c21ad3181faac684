"""Batched LZ77 match finding and greedy / lazy / optimal parse.

Counterpart of tpu_zstd/ops/lz77_jax.py: the match finder over
2^mf_win_log windows or the whole block (min_match 3 or 4, the near-offset
second band, sampled positions with their left extension, a window prefix
of match sources before the payload), the sampled long-range pass (LDM),
the greedy parse with lazy defer, the offset-cost gate and the decode-tuned
minimum length, the optimal parse (a pass-1 greedy walk prices every
decision, then the segment DP chooses), extraction, the same-offset merge,
repcodes and the min_match-3 overflow poison. Every array carries a leading
batch dimension (one row per block) where the JAX package vmaps per block.

The design is the JAX package's: previous-occurrence search as a sort of
(hash, pos) keys that carries the suffix words, depth-D candidates as the D
preceding sorted rows, back to position order, and compaction by sort. Sort
keys are unique, so `torch.sort` on one int64 key plus a gather of each
payload gives the same order as the JAX package's unstable one- or two-key
sorts; the restore to position order is a scatter by the sorted positions.
Four Pallas TPU kernels on this path are CUDA kernels here: the greedy walk
(K3, ops/greedy.py), the segment concatenation (K2, ops/concat.py), the
repcode walk (K4, ops/rep.py) and the segment DP (K10, ops/opt.py); a fifth,
the fused match finder (K13, ops/match.py), serves `find_matches` when asked
for (`use_pallas_match`), as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import ML_BASELINE, ML_BITS
from .bitpack import dynroll_left
from .concat import Operand, concat_fused
from .fse import highbit32, ml_code
from .greedy import greedy_segments
from .match import match_windows
from .opt import SCALE, opt_steps
from .rep import rep_codes

HASH_PRIME = 2654435761
LDM_PRIME = 0x85EBCA77
LDM_MIN = 16  # long-range matches must cover the 16-byte verification span
SEG_LOG = 10
LL_AMORT = 3 * SCALE  # one LL symbol per match, ~3 bits on mixed data
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


def _words(block: torch.Tensor) -> torch.Tensor:
    """4-byte little-endian words (u32 in int64) per position of blocks
    (B, N); words wrap around each block's end."""
    b = block.to(torch.int64)
    return (
        b
        | (torch.roll(b, -1, -1) << 8)
        | (torch.roll(b, -2, -1) << 16)
        | (torch.roll(b, -3, -1) << 24)
    )


def _hash_words(block: torch.Tensor, hash_log: int, min_match: int = 4):
    """Words and Fibonacci hashes per position; min_match 3 hashes only the
    low 3 bytes, so chain candidates agree on 3 bytes."""
    w = _words(block)
    hw = w & 0xFFFFFF if min_match == 3 else w
    return w, _mul32(hw, HASH_PRIME) >> (32 - hash_log)


def _as_i32(w: torch.Tensor) -> torch.Tensor:
    """u32 values held in int64 -> the same 32 bits as int32 (XOR, == 0 and
    the byte masks of `_word_inc` read the bits alone)."""
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _word_inc(x: torch.Tensor) -> torch.Tensor:
    """Matched byte count (0..4) from the XOR of two 4-byte LE words."""
    return torch.where(
        x == 0,
        4,
        ((x & 0xFF) == 0).to(torch.int64)
        + ((x & 0xFFFF) == 0).to(torch.int64)
        + ((x & 0xFFFFFF) == 0).to(torch.int64),
    )


def _scatter_back(sp: torch.Tensor, *vals: torch.Tensor):
    """Values in sorted-row order back to position order: sp holds each
    row's position (a permutation along the last axis)."""
    return tuple(torch.empty_like(v).scatter_(-1, sp, v) for v in vals)


def _chain_lengths(sk, sp, sw, d: int, lpos):
    """Match length of every sorted row against the row d above it (0 where
    the hashes differ), the position of that row and whether the hashes
    agree."""
    def _prev(x, fill):
        return torch.where(lpos < d, fill, torch.roll(x, d, -1))

    same = _prev(sk, -1) == sk
    pp = _prev(sp, 0)
    ml = torch.zeros(sk.shape, dtype=torch.int64, device=sk.device)
    alive = same
    for x_k in sw:
        x = x_k ^ _prev(x_k, 0)
        ml = ml + torch.where(alive, _word_inc(x), 0)
        alive = alive & (x == 0)
    return ml, pp, same


def _sort_unique(key: torch.Tensor, *pays: torch.Tensor):
    """Ascending sort along the last axis by a UNIQUE key, carrying payloads."""
    skey, order = torch.sort(key, dim=-1)
    return (skey, *(torch.gather(p, -1, order) for p in pays))


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _col(x, dev):
    """An int as it is, a (B,) tensor as a (B, 1) int64 column."""
    return x.to(device=dev, dtype=torch.int64)[:, None] if torch.is_tensor(x) else x


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
    two_band: bool = False,
    use_pallas_match: bool = False,
    win_start=0,
    sample_log: int = 0,
):
    """Best (capped) match per position: returns (best_ml, best_off), each
    (B, N) int64 in position order, and with two_band also (ml2, off2), the
    best candidate at an offset below 512.

    block (B, N) uint8, n (B,) payload lengths. Positions in [win_start, n)
    take part (win_start, an int or (B,), marks a window prefix: bytes
    before it are padding and never referenced). Ties prefer the smallest
    offset. With 0 < mf_win_log < log2(N) and N a multiple of the window,
    the candidate search is local to 2^mf_win_log windows, else it spans the
    whole block; match content extends past window ends (words are formed
    on the whole block).

    sample_log > 0 (windowed search only): only every 2^sample_log-th
    position takes part; a candidate whose preceding bytes also match
    extends its match one byte left to the unsampled position before it.

    The search over the whole block returns offsets in a 20-bit field, as
    the JAX package packs them: a best offset of 2^20 or more (a window
    prefix of 1 MiB) leaves the position without a match, where the JAX
    package keeps the offset's low 20 bits (a wrong offset).

    use_pallas_match asks for the fused route (kernel K13, one launch over
    every window of the batch), taken where the JAX package takes its fused
    Pallas route: windowed search, mf_win_log >= 10, the key hash << plog |
    pos within 31 bits, and `block` on the card (on the CPU the sort route
    runs, as the JAX package's does off the TPU). The fused route gives 0 at
    dead positions, where the sort route's clamp leaves lengths under
    min_match. Like the JAX package's, it returns one band, (best_ml,
    best_off), even when two_band asks for two, and ignores sample_log;
    where it does not apply, two_band takes the sort route's four outputs.
    """
    B, N = block.shape
    dev = block.device
    if use_pallas_match and dev.type == "cuda" and fused_route_ok(N, hash_log, mf_win_log):
        return find_matches_fused(block, n, hash_log=hash_log, depth=depth, cap=cap,
                                  mf_win_log=mf_win_log, min_match=min_match,
                                  win_start=win_start)
    nwords = cap // 4
    pos = torch.arange(N, device=dev)
    n = n.to(torch.int64)
    w, h = _hash_words(block, hash_log, min_match)
    live = (pos < n[:, None] - (min_match - 1)) & (pos >= _col(win_start, dev))
    windowed = _is_windowed(N, mf_win_log)
    SS = 1 << sample_log if sample_log > 0 and windowed else 1
    if two_band and SS > 1:
        raise ValueError("two_band requires an unsampled search")
    if windowed:
        W, plog = 1 << mf_win_log, mf_win_log - (sample_log if SS > 1 else 0)
    else:
        W, plog = N, max(1, (N - 1).bit_length())
    nwin = N // W
    shape = (B, nwin, W // SS)

    def sampled(x):
        return x.reshape(B, nwin, W)[..., ::SS]

    words = [sampled(_as_i32(torch.roll(w, -4 * k, -1))) for k in range(nwords)]
    del w
    extra = []
    if SS > 1:
        # Left-extension operand: the byte before each sampled position
        # (256 before position 0).
        pb = torch.roll(block.to(torch.int64), 1, -1)
        pb[:, 0] = 256
        extra = [sampled(pb)]
    lpos = torch.arange(W // SS, device=dev)

    # Sort positions by (hash, pos) as one int64 key, which orders as the
    # JAX package's packed u32 key or its two-key sort; dead rows get the
    # sentinel hash 2^hash_log and keep their position order.
    key = (torch.where(sampled(live), sampled(h), 1 << hash_log) << plog) | lpos
    skey, *sw = _sort_unique(key, *words, *extra)
    del key, words
    spb = sw.pop() if SS > 1 else None
    sk = skey >> plog
    sp = skey & ((1 << plog) - 1)

    best_ml = torch.zeros(shape, dtype=torch.int64, device=dev)
    best_off = torch.zeros_like(best_ml)
    best_ext = torch.zeros(shape, dtype=torch.bool, device=dev) if SS > 1 else None
    if two_band:
        best_ml2 = torch.zeros_like(best_ml)
        best_off2 = torch.zeros_like(best_ml)
    for d in range(1, depth + 1):
        ml, pp, same = _chain_lengths(sk, sp, sw, d, lpos)
        off = sp - pp
        better = ml > best_ml
        best_ml = torch.where(better, ml, best_ml)
        best_off = torch.where(better, off, best_off)
        if two_band:
            better2 = (off < 512) & (ml > best_ml2)
            best_ml2 = torch.where(better2, ml, best_ml2)
            best_off2 = torch.where(better2, off, best_off2)
        if best_ext is not None:
            prev_pb = torch.where(lpos < d, -2, torch.roll(spb, d, -1))
            best_ext = torch.where(better, same & (spb == prev_pb), best_ext)
        del ml, pp, off, better, same

    # Clamp to block end (also cancels false matches into rolled-around words).
    gsp = sp * SS + (torch.arange(nwin, device=dev) * W)[:, None]
    room = torch.clamp(n[:, None, None] - gsp, min=0)
    best_ml = torch.minimum(best_ml, room)
    best_off = best_off * SS
    mlb = max(4, cap.bit_length())
    if not (windowed and plog + mf_win_log + mlb + int(SS > 1) <= 31):
        # The JAX package's restore packs (ml << 20) | off here: the length
        # as it unpacks it, and no match where the offset overflows.
        if SS > 1 and cap >= 1 << 6:
            raise ValueError("a sampled search past the packed key needs cap < 64")
        wide = best_off >= 1 << 20
        best_ml = torch.where(wide, best_ml | (best_off >> 20), best_ml)
        best_off = torch.where(wide, 0, best_off)
    out = [best_ml, best_off]
    if two_band:
        out += [torch.minimum(best_ml2, room), best_off2]
    if SS == 1:
        return tuple(v.reshape(B, N) for v in _scatter_back(sp, *out))

    # Left-extension fill: an unsampled position q takes (ml + 1, off) from
    # its sampled successor q + 1 when that one's winning candidate also
    # matched one byte left.
    def spread(v):
        full = torch.zeros((B, nwin, W // SS, SS), dtype=torch.int64, device=dev)
        full[..., 0] = v
        return full.reshape(B, N)

    ml_f, off_f, ext_f = (spread(v) for v in _scatter_back(sp, best_ml, best_off,
                                                           best_ext.to(torch.int64)))
    nx_ml = torch.roll(ml_f, -1, -1)
    take = (torch.roll(ext_f, -1, -1) > 0) & (nx_ml > 0) & (ml_f == 0)
    ml_f = torch.where(take, torch.minimum(nx_ml + 1, torch.clamp(n[:, None] - pos, min=0)), ml_f)
    off_f = torch.where(take, torch.roll(off_f, -1, -1), off_f)
    return ml_f, off_f


def fused_route_ok(N: int, hash_log: int, mf_win_log: int) -> bool:
    """Where the fused route runs: a windowed search over windows of at
    least 1024 positions whose key hash << mf_win_log | pos fits 31 bits."""
    return _is_windowed(N, mf_win_log) and mf_win_log >= 10 and hash_log + 1 + mf_win_log <= 31


def find_matches_fused(block: torch.Tensor, n: torch.Tensor, *, hash_log: int, depth: int,
                       cap: int, mf_win_log: int, min_match: int = 4, win_start=0):
    """The fused route of `find_matches`: keys hash << mf_win_log | pos
    (the sentinel hash 2^hash_log on dead positions) and the cap // 4 suffix
    words per window, one `match_windows` call over every window of the
    batch (K13 on a CUDA block, its plain version on a CPU one), lengths
    clamped to the block end. Returns (best_ml, best_off), each (B, N)
    int64, 0 at dead positions."""
    B, N = block.shape
    if not fused_route_ok(N, hash_log, mf_win_log):
        raise ValueError(f"find_matches_fused: needs a windowed search with mf_win_log >= 10 "
                         f"and hash_log + 1 + mf_win_log <= 31 (N {N}, hash_log {hash_log}, "
                         f"mf_win_log {mf_win_log})")
    dev = block.device
    nwords = cap // 4
    W = 1 << mf_win_log
    sentinel = 1 << hash_log
    pos = torch.arange(N, device=dev)
    n = n.to(torch.int64)
    w, h = _hash_words(block, hash_log, min_match)
    live = (pos < n[:, None] - (min_match - 1)) & (pos >= _col(win_start, dev))
    key = ((torch.where(live, h, sentinel) << mf_win_log) | (pos & (W - 1))).to(torch.int32)
    del h, live
    shape = (B * (N // W), W)
    words = torch.stack([_as_i32(torch.roll(w, -4 * k, -1)).reshape(shape)
                         for k in range(nwords)]) if nwords else []
    del w
    best_ml, best_off = match_windows(key.reshape(shape), words, depth, sentinel)
    best_ml = torch.minimum(best_ml.reshape(B, N).to(torch.int64),
                            torch.clamp(n[:, None] - pos, min=0))
    return best_ml, best_off.reshape(B, N).to(torch.int64)


def find_matches_long(
    block: torch.Tensor,
    n: torch.Tensor,
    *,
    hash_log2: int = 16,
    sample_log: int = 2,
    depth: int = 2,
    win_start=0,
    nwords: int = 4,
):
    """Sampled whole-block long-range match candidates (LDM): every
    2^sample_log-th position from win_start on, hashed over 8 bytes, verified
    and measured on 4 * nwords carried bytes; only matches of at least
    LDM_MIN count.
    Returns (ml, off), each (B, N) int64, zero at unsampled positions."""
    B, N = block.shape
    dev = block.device
    SS = 1 << sample_log
    P = N // SS
    n = n.to(torch.int64)
    w = _words(block)
    plog = max(1, (P - 1).bit_length())
    ws = [torch.roll(w, -4 * k, -1)[:, ::SS] for k in range(nwords)]
    h2 = (_mul32(ws[0], HASH_PRIME) ^ _mul32(ws[1], LDM_PRIME)) >> (32 - hash_log2)
    spos = torch.arange(N, device=dev)[::SS]
    live = (spos < n[:, None] - (LDM_MIN + 3)) & (spos >= _col(win_start, dev))
    idx = torch.arange(P, device=dev)
    key = (torch.where(live, h2, 1 << hash_log2) << plog) | idx
    skey, *sw = _sort_unique(key, *(_as_i32(x) for x in ws))
    sk = skey >> plog
    sp = skey & ((1 << plog) - 1)

    best_ml = torch.zeros((B, P), dtype=torch.int64, device=dev)
    best_di = torch.zeros_like(best_ml)
    for d in range(1, depth + 1):
        ml, pp, _ = _chain_lengths(sk, sp, sw, d, idx)
        better = (ml >= LDM_MIN) & (ml > best_ml)
        best_ml = torch.where(better, ml, best_ml)
        best_di = torch.where(better, sp - pp, best_di)

    s_ml, s_di = _scatter_back(sp, best_ml, best_di)
    s_ml = torch.minimum(s_ml, torch.clamp(n[:, None] - spos, min=0))
    full_ml = torch.zeros((B, P, SS), dtype=torch.int64, device=dev)
    full_off = torch.zeros_like(full_ml)
    full_ml[:, :, 0] = s_ml
    full_off[:, :, 0] = s_di * SS
    return full_ml.reshape(B, N), full_off.reshape(B, N)


def greedy_parse(step: torch.Tensor, matched: torch.Tensor, defer, seg: int):
    """Exact greedy (optionally 1-step lazy) parse of (B, N) positions in
    independent `seg`-byte segments (kernel K3). step[i] never crosses a
    segment boundary. Returns (is_seq, is_lit), each (B, N) bool."""
    B, N = step.shape
    d = torch.zeros_like(matched) if defer is None else defer
    packed = step.to(torch.int64) | (matched.to(torch.int64) << 11) | (d.to(torch.int64) << 12)
    out = greedy_segments(packed.to(torch.int32).reshape(B * (N // seg), seg)).reshape(B, N)
    return (out & 1) == 1, (out & 2) == 2


def _bins(x: torch.Tensor, sel: torch.Tensor, nbins: int) -> torch.Tensor:
    """Per-row histogram (B, nbins) int64 of x's values in [0, nbins) where
    sel holds (an exact integer scatter-add)."""
    idx = torch.where(sel & (x >= 0) & (x < nbins), x, nbins).to(torch.int64)
    h = torch.zeros((x.shape[0], nbins + 1), dtype=torch.int64, device=x.device)
    return h.scatter_add_(1, idx, torch.ones_like(idx))[:, :nbins]


def _log2(x: torch.Tensor) -> torch.Tensor:
    """float32 log2 as the JAX package computes it: log(x) / log(2)."""
    return torch.log(x) / torch.log(torch.tensor(2.0, dtype=torch.float32, device=x.device))


def _sym_bits(hist: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Code bits per symbol in SCALE units from a histogram (B, K) and its
    total (B,); an unseen symbol costs log2(total) + 2 bits."""
    tot = total.to(torch.float32)[:, None]
    bits = -_log2(torch.clamp(hist.to(torch.float32) / tot, min=1e-9))
    unseen = _log2(tot) + 2.0
    return torch.round(torch.where(hist > 0, bits, unseen) * SCALE).to(torch.int64)


def optimal_prices(block, n, ml_t, ofc, matched, *, min_match: int, cap: int, seg: int,
                   block_start: int = 0):
    """Pass 1 of the optimal parse: a greedy walk (K3) over the candidates,
    then the block's measured symbol economics in SCALE units: OF-code bits
    (B, 32), the literal price (B,) from the residual literals' entropy (of
    the payload, from block_start on) and the 128-lane cost bank (B, 128):
    OF-symbol bits plus the amortised LL symbol at lanes [0, 32), ML-symbol
    bits plus exact ML extra bits for lengths min_match..min(cap, 127) from
    lane 32. ofc: each candidate's offset code."""
    B, N = block.shape
    pos = torch.arange(N, device=block.device)
    in_block = pos < n[:, None]
    is_seq1, is_lit1 = greedy_parse(torch.where(matched, ml_t, 1), matched, None, seg)
    ch = is_seq1 & in_block
    lit1 = is_lit1 & in_block & (pos >= block_start)
    nch = torch.clamp(ch.sum(-1), min=1)
    of_bits = _sym_bits(_bins(ofc, ch, 32), nch)
    ml_bits_h = _sym_bits(_bins(ml_code(torch.clamp(ml_t, min=3)), ch, 53), nch)
    # Literal price: entropy of the pass-1 residual literals.
    nlit1 = torch.clamp(lit1.sum(-1), min=1).to(torch.float32)
    lith = _bins(block.to(torch.int64), lit1, 256)
    pl_ = lith.to(torch.float32) / nlit1[:, None]
    h_lit = -torch.where(lith > 0, pl_ * _log2(torch.clamp(pl_, min=1e-9)), 0.0).sum(-1)
    lit_price = torch.clamp(torch.round(h_lit * SCALE).to(torch.int64), SCALE // 2, 11 * SCALE)

    dp_cap = min(cap, 127)
    mlcode_l = np.searchsorted(
        np.asarray(ML_BASELINE), np.arange(min_match, dp_cap + 1), side="right") - 1
    mlx_l = torch.as_tensor(np.asarray(ML_BITS)[mlcode_l].astype(np.int64) * SCALE,
                            device=block.device)
    bank = torch.zeros((B, 128), dtype=torch.int64, device=block.device)
    bank[:, :32] = of_bits + LL_AMORT
    bank[:, 32 : 32 + dp_cap + 1 - min_match] = (
        ml_bits_h[:, torch.as_tensor(mlcode_l, device=block.device)] + mlx_l)
    return of_bits, lit_price, bank


def _optimal_steps(block, n, ml_t, boff, matched, bml2, boff2, room, *,
                   min_match: int, cap: int, seg: int, block_start: int = 0):
    """The optimal branch of the JAX parse: price (pass 1), the segment DP
    over both candidate bands (K10), then which band each chosen match
    takes. Returns (matched, ml_t, boff, step) for the final walk."""
    B, N = block.shape
    pos = torch.arange(N, device=block.device)
    in_payload = (pos < n[:, None]) & (pos >= block_start)
    ofc = highbit32(torch.clamp(boff + 3, min=1))
    of_bits, lit_price, bank = optimal_prices(
        block, n, ml_t, ofc, matched, min_match=min_match, cap=cap, seg=seg,
        block_start=block_start)
    mlv = torch.where(matched, torch.clamp(ml_t, max=127), 0)
    ml2_t = torch.minimum(bml2, room)
    ok2 = (ml2_t >= min_match) & (boff2 > 0) & in_payload
    mlv2 = torch.where(ok2, torch.clamp(ml2_t, max=127), 0)
    ofc2 = highbit32(torch.clamp(boff2 + 3, min=1))
    packed = (mlv | (torch.clamp(ofc, max=31) << 7) | (mlv2 << 12)
              | (torch.clamp(ofc2, max=15) << 19))
    nseg_b = N // seg
    dp = opt_steps(
        packed.to(torch.int32).reshape(B * nseg_b, seg), min_match, min(cap, 127),
        lit_bits=lit_price.to(torch.int32).repeat_interleave(nseg_b),
        cost_bank=bank.to(torch.int32).repeat_interleave(nseg_b, 0),
    ).reshape(B, N).to(torch.int64)
    matched = dp > 1
    # The band the DP priced for the chosen length: the near candidate wins
    # when it reaches that length and is not costlier.
    c1, c2 = torch.clamp(ofc, max=31), torch.clamp(ofc2, max=31)
    mc1 = of_bits.gather(1, c1) + c1 * SCALE
    mc2 = of_bits.gather(1, c2) + c2 * SCALE
    use2 = matched & (mlv2 >= dp) & ((mlv < dp) | (mc2 <= mc1))
    boff = torch.where(use2, boff2, boff)
    ml_t = torch.where(matched, dp, ml_t)
    return matched, ml_t, boff, torch.where(matched, dp, 1)


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
    optimal: bool = False,
    ldm: bool = False,
    block_start: int = 0,
    win_start=0,
    sample_log: int = 0,
    dec_min_ml: int = 0,
) -> BlockSequences:
    """Parse blocks (B, N) uint8 with lengths n (B,) into sequences.

    Window mode: each row's payload lies in [block_start, n) and
    [win_start, block_start) (win_start an int or (B,)) holds the bytes
    before it, match sources only; literals are the payload's. With ldm and
    a windowed search whose windows tile the payload, the windowed matcher
    runs on the payload alone and reaches the prefix only through the
    long-range pass. dec_min_ml > min_match drops matches shorter than it,
    except same-offset continuations."""
    if min_match not in (3, 4):
        raise NotImplementedError("only min_match 3 and 4 are ported")
    B, N = block.shape
    dev = block.device
    n = n.to(torch.int64)
    pos = torch.arange(N, device=dev)
    in_block = pos < n[:, None]

    windowed_ldm = ldm and 0 < mf_win_log < max(1, (N - 1).bit_length())
    fm_kw = dict(hash_log=hash_log, depth=depth, cap=cap, mf_win_log=mf_win_log,
                 min_match=min_match, two_band=optimal, sample_log=sample_log)
    if windowed_ldm and block_start > 0 and (N - block_start) % (1 << mf_win_log) == 0:
        # The prefix adds no rows to the windowed matcher's sorts.
        fm = find_matches(block[:, block_start:], n - block_start, **fm_kw)
        fm = [torch.nn.functional.pad(x, (block_start, 0)) for x in fm]
    else:
        fm = find_matches(block, n, win_start=win_start, **fm_kw)
    bml, boff = fm[0], fm[1]
    if windowed_ldm:
        # Long-range supplement, taken only where strictly longer than the
        # local match (long offsets cost extra bits).
        lml, loff = find_matches_long(block, n, win_start=win_start)
        take_l = lml > bml
        bml = torch.where(take_l, lml, bml)
        boff = torch.where(take_l, loff, boff)

    # Truncate matches at segment boundaries so segments parse independently;
    # the merge pass below re-joins same-offset continuations.
    seg = 1 << seg_log
    room = seg - (pos & (seg - 1))
    ml_t = torch.minimum(bml, room)
    matched = (ml_t >= min_match) & (boff > 0) & in_block & (pos >= block_start)
    if dec_min_ml > min_match:
        # Decode-tuned profile: fewer, longer sequences; same-offset
        # continuations stay (the merge pass joins them).
        matched = matched & ((ml_t >= dec_min_ml) | (boff == torch.roll(boff, 1, -1)))
    defer = None
    if optimal:
        # Segment DP over both candidate bands; lazy and the offset-cost
        # gate do not apply.
        matched, ml_t, boff, step = _optimal_steps(
            block, n, ml_t, boff, matched, fm[2], fm[3], room,
            min_match=min_match, cap=cap, seg=seg, block_start=block_start)
    else:
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
        if lazy:
            next_ml = torch.roll(ml_t, -1, -1)
            next_ml[:, -1] = 0
            next_matched = torch.roll(matched, -1, -1)
            next_matched[:, -1] = False
            defer = matched & next_matched & (next_ml > ml_t + 1)

    is_seq, is_lit = greedy_parse(step, matched, defer, seg)
    is_seq = is_seq & in_block
    is_lit = is_lit & in_block & (pos >= block_start)
    nseq = is_seq.sum(-1)
    nlit = is_lit.sum(-1)

    pk = torch.where(is_seq, (ml_t << 21) | boff, block.to(torch.int64))
    ew_log = min(mf_win_log, 11)
    if 0 < mf_win_log and (1 << ew_log) < N and N % (1 << ew_log) == 0:
        # Windowed extraction: per 2^ew_log window, one compaction sort puts
        # sequence rows first, then literal bytes; K2 joins the windows.
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
        # One K2 launch joins the literal bytes (the low byte of pk), the
        # sequence starts (the window base w << ew_log added in the kernel)
        # and pk, read where the sort left them; the int32 casts of the JAX
        # path (pk is int32 there, so ml << 21 wraps) happen in the kernel.
        lits, starts, pk_acc = concat_fused([
            Operand(e_pk_w, nseq_w, nlit_w, N, torch.uint8),
            Operand(e_key_w[..., :SC], None, nseq_w, max_seqs, torch.int64, win_shift=ew_log),
            Operand(e_pk_w[..., :SC], None, nseq_w, max_seqs, torch.int64),
        ])
    else:
        # One compaction sort over the block: the key is the position, so
        # sequence rows sort to the front with their starts as keys.
        sel_key = torch.where(is_seq, pos, torch.where(is_lit, N + pos, 2 * N + pos))
        e_key, e_pk = _sort_unique(sel_key, pk)
        lits = dynroll_left((e_pk & 0xFF).to(torch.uint8), nseq)
        starts = e_key[:, :max_seqs]
        pk_acc = e_pk[:, :max_seqs]
    mls = pk_acc >> 21
    offs = pk_acc & ((1 << 21) - 1)

    k = torch.arange(max_seqs, device=dev)
    valid = k < nseq[:, None]
    starts = torch.where(valid, starts, 0)
    mls = torch.where(valid, mls, 0)
    offs = torch.where(valid, offs, 0)

    ends = starts + mls
    prev_end = torch.roll(ends, 1, -1)
    prev_end[:, 0] = block_start
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

    if min_match < 4:
        # Overflow poison: past max_seqs the extraction truncates, so a
        # block that parsed into more sequences becomes all literals (the
        # assembler then emits it Raw).
        over = nseq > max_seqs
        nseq2 = torch.where(over, 0, nseq2)
        pay = torch.roll(block, -block_start, -1) if block_start else block
        lits = torch.where(over[:, None], pay.to(torch.uint8), lits)
        nlit = torch.where(over, torch.clamp(n - block_start, min=0), nlit)
        ll2, ml2, ob, off2, starts2 = (torch.where(over[:, None], 0, a).to(a.dtype)
                                       for a in (ll2, ml2, ob, off2, starts2))

    i32 = torch.int32
    return BlockSequences(
        ll2.to(i32), ml2.to(i32), ob, off2.to(i32), starts2.to(i32), nseq2, lits, nlit
    )
