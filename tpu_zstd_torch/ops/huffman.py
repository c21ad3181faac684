"""Batched Huffman literals encoder (RFC 8878 §4.2, 4-stream format).

Counterpart of tpu_zstd/ops/huffman_jax.py, batched: every function takes a
leading batch dimension (one row per block) where the JAX package vmaps a
per-block function. Stages, as there:

- the literal histogram (a scatter-add over the live prefix);
- length-limited (<= 11 bits) code lengths: a uniform shift of
  ceil(-log2 p) that fits the Kraft budget, then an exact repair that
  promotes the highest-count symbols first; blocks where the repair cannot
  reach Kraft equality keep Raw literals;
- canonical codes (natural symbol order within a length);
- the weights header: direct 4-bit, or the FSE-compressed form (two
  interleaved state chains, run through kernel K5 on a card) when it is
  smaller or when more than 128 weights are explicit;
- four backward bitstreams, each packed by the tree deposit, placed after a
  6-byte jump table.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .bitpack import (
    M32,
    deposit_bits,
    deposit_bits_tree,
    dynroll,
    place,
    shift_words,
    words_to_bytes,
)
from .chain import state_chain3
from .fse_tables import TL, build_cf_tables, histogram_codes, ncount_fields, normalize_64

MAX_BITS = 11
WEIGHT_CAP = 160  # payload byte capacity of the FSE weight header (< 128 used)


def huff_payload_cap(block_size: int) -> int:
    """Buffer capacity for the worst-case 4-stream payload of one block,
    rounded up to 4096 bytes."""
    part = block_size // 4 + 4
    num_words = (part * MAX_BITS) // 8 // 4 + 4
    cap = 6 + 4 * (num_words * 4) + 160  # jump + streams + weights header
    return -(-cap // 4096) * 4096


def _floor_log2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for 1 <= v < 2^32 (int64)."""
    out = torch.zeros_like(v)
    for shift in (16, 8, 4, 2, 1):
        m = v >= (1 << shift)
        out = out + torch.where(m, shift, 0)
        v = torch.where(m, v >> shift, v)
    return out


def literal_histogram(lits: torch.Tensor, nlit: torch.Tensor) -> torch.Tensor:
    """(B, 256) counts of lits[b, :nlit[b]] for lits (B, N) uint8."""
    return histogram_codes(lits, nlit, 256)


def build_lengths(cnt: torch.Tensor, nlit: torch.Tensor, max_bits: int = MAX_BITS):
    """Length-limited code lengths with exact Kraft equality, per row.

    cnt (B, 256). Returns (lengths (B, 256) int64, 0 for absent symbols;
    ok (B,)), ok False where the repair could not reach equality or fewer
    than 2 symbols are present.
    """
    cnt = cnt.to(torch.int64)
    B = cnt.shape[0]
    dev = cnt.device
    present = cnt > 0
    nsym = present.sum(-1)
    tsize = 1 << max_bits

    # Initial lengths ~ ceil(-log2 p), via integer ratio against the budget.
    ratio = cnt * tsize // torch.clamp(nlit.to(torch.int64), min=1)[:, None]
    l0 = torch.clamp(max_bits - _floor_log2(torch.clamp(ratio, min=1)), 1, max_bits)

    def kraft(lens):
        return torch.where(present, 1 << (max_bits - lens), 0).sum(-1)

    # Smallest uniform shift theta that fits the Kraft budget.
    fits = torch.stack(
        [kraft(torch.clamp(l0 + t, 1, max_bits)) <= tsize for t in range(max_bits + 1)], -1
    )
    theta = (torch.cumsum(fits.to(torch.int64), -1) == 0).sum(-1, keepdim=True)
    lengths = torch.where(present, torch.clamp(l0 + theta, 1, max_bits), 0)
    D = tsize - kraft(torch.where(present, lengths, max_bits))

    # Exact repair: hand out the remaining budget by promoting symbols
    # (l -> l-1 costs 2^(11-l) budget), two passes over the cost sizes; within
    # a level the highest counts go first (stable order of -cnt). A symbol's
    # rank among the candidates is the exclusive count of candidates before
    # it in that order.
    sym_idx = torch.arange(256, device=dev).expand(B, 256).contiguous()
    order = torch.sort(-cnt, dim=-1, stable=True).indices
    rg = torch.empty_like(order).scatter_(1, order, sym_idx)
    for _ in range(2):
        for l in range(2, max_bits + 1):
            g = 1 << (max_bits - l)
            cand = present & (lengths == l)
            k = torch.minimum(cand.sum(-1), D // g)
            cs = cand.gather(1, order).to(torch.int64)
            rank = (torch.cumsum(cs, -1) - cs).gather(1, rg)
            dec = cand & (rank < k[:, None])
            lengths = torch.where(dec, l - 1, lengths)
            D = D - k * g
    return lengths, (D == 0) & (nsym >= 2)


def canonical_codes(lengths: torch.Tensor) -> torch.Tensor:
    """Canonical code values (B, 256) from lengths (longest codes take the
    smallest values; natural symbol order within a length)."""
    nranks = MAX_BITS + 2
    onehot = (lengths[..., None] == torch.arange(nranks, device=lengths.device)).to(torch.int64)
    nb_per_rank = onehot.sum(1)  # (B, nranks)
    vals = [torch.zeros_like(nb_per_rank[:, 0]) for _ in range(nranks)]
    min_v = vals[0]
    for nbits in range(MAX_BITS, 0, -1):
        vals[nbits] = min_v
        min_v = (min_v + nb_per_rank[:, nbits]) >> 1
    val_per_rank = torch.stack(vals, -1)
    my_rank = ((torch.cumsum(onehot, 1) - onehot) * onehot).sum(-1)
    my_base = val_per_rank.gather(1, torch.clamp(lengths, 0, nranks - 1))
    return torch.where(lengths > 0, my_base + my_rank, 0)


def _weights(lengths: torch.Tensor):
    """Explicit Huffman weights (B, 256) (zero beyond the last present symbol,
    which is implied) and their count num (B,) (-1 with no symbol)."""
    sym = torch.arange(256, device=lengths.device)
    table_log = lengths.amax(-1, keepdim=True)
    weights = torch.where(lengths > 0, table_log + 1 - lengths, 0)
    num = torch.where(lengths > 0, sym, -1).amax(-1)
    return torch.where(sym < num[:, None], weights, 0), num


def weights_header(lengths: torch.Tensor):
    """Direct 4-bit weight serialization (RFC 8878 §4.2.1.2).

    Returns (header (B, 129) uint8, header_len (B,), ok (B,)); ok False when
    the explicit weight count is outside [1, 128].
    """
    wexp, num = _weights(lengths)
    ok = (num >= 1) & (num <= 128)
    packed = ((wexp[:, 0::2] << 4) | wexp[:, 1::2]) & 0xFF
    hdr = torch.cat([((127 + num) & 0xFF)[:, None], packed], -1).to(torch.uint8)
    return hdr, 1 + (num + 1) // 2, ok


def weights_fse_payload(lengths: torch.Tensor):
    """FSE-compressed Huffman weights (RFC 8878 §4.2.1.1, headerByte < 128).

    Returns (payload (B, WEIGHT_CAP) uint8, payload_len (B,), ok (B,)). The
    payload is the NCount header then the interleaved 2-state bitstream; the
    caller prepends the headerByte (= payload_len). ok needs >= 2 distinct
    weights and payload_len < 128. The two chains of every block go through
    one `state_chain3` call (K5 on a card): 2 rows per block, 128 steps.
    """
    B = lengths.shape[0]
    NW = 256
    wexp, num = _weights(lengths)

    cnt = histogram_codes(wexp, num, 13)
    npres = (cnt > 0).sum(-1)
    norm = normalize_64(cnt, num)
    nc_vals, nc_lens, nc_bytes = ncount_fields(norm)
    st_t, dnb_t, dfs_t, init = build_cf_tables(norm)

    # Reversed explicit weights r[t] = wexp[num-1-t], split into the two
    # interleaved chains (A = even t, B = odd t).
    r = dynroll(wexp.flip(-1), (num - NW) % NW)
    rAB = torch.stack([r[:, 0::2], r[:, 1::2]], 1).reshape(2 * B, NW // 2)
    n2 = torch.stack([(num + 1) // 2, num // 2], 1).reshape(-1)

    def rows2(x):
        return x.repeat_interleave(2, dim=0)

    pre2, fin2, nb2 = state_chain3(
        rows2(st_t), rows2(dnb_t), rows2(dfs_t), rows2(init),
        torch.full((2 * B,), TL, dtype=torch.int64, device=lengths.device),
        torch.zeros(2 * B, dtype=torch.bool, device=lengths.device),
        rAB, n2,
    )
    pre2 = pre2.to(torch.int64).reshape(B, 2, NW // 2)
    nb2 = nb2.to(torch.int64).reshape(B, 2, NW // 2)
    fin2 = fin2.to(torch.int64).reshape(B, 2)
    v2 = (64 + pre2) & ((1 << nb2) - 1)
    # Interleave to t order (A0, B0, A1, B1, ...); fields live for 2 <= t < num.
    nb_t = nb2.transpose(1, 2).reshape(B, NW)
    v_t = v2.transpose(1, 2).reshape(B, NW)
    t_ar = torch.arange(NW, device=lengths.device)
    live = (t_ar >= 2) & (t_ar < num[:, None])
    lens_t = torch.where(live, nb_t, 0)

    # Tail: libzstd flushes s2 then s1; with odd num s2 is the B chain, with
    # even num the A chain. 6 bits each (table log TL), then the sentinel.
    odd = (num & 1) == 1
    t1 = torch.where(odd, fin2[:, 1], fin2[:, 0])
    t2 = torch.where(odd, fin2[:, 0], fin2[:, 1])
    has = (num >= 2).to(torch.int64)
    all_vals = torch.cat([v_t, torch.stack([t1, t2, torch.ones_like(t1)], -1)], -1) & M32
    all_lens = torch.cat([lens_t, torch.stack([has * 6, has * 6, has], -1)], -1)

    words, total_bits = deposit_bits(all_vals, all_lens, WEIGHT_CAP // 4)
    stream_bytes = (total_bits + 7) >> 3
    out = place(_nc_desc_bytes(nc_vals, nc_lens), nc_bytes, 0, WEIGHT_CAP) + place(
        words_to_bytes(words), stream_bytes, nc_bytes, WEIGHT_CAP
    )
    payload_len = nc_bytes + stream_bytes
    ok = (npres >= 2) & (num >= 2) & (payload_len < 128)
    return out, payload_len, ok


def _nc_desc_bytes(nc_vals: torch.Tensor, nc_lens: torch.Tensor) -> torch.Tensor:
    """NCount field deposit -> (B, 64) bytes (weights alphabet, small)."""
    return words_to_bytes(deposit_bits(nc_vals, nc_lens, 16)[0])


def _lut256(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[b, idx[b, j]] for a (B, 256) table and (B, N) byte indices."""
    return table.gather(1, idx.to(torch.int64))


def encode_literals_4stream(lits, nlit, lengths, codes, out_cap: int, ckpt_every: int = 0):
    """4-stream Huffman payload: jump table + 4 backward bitstreams.

    lits (B, N) uint8 (the first nlit[b] valid). Returns (payload
    (B, out_cap + 8) uint8, payload_len (B,), ok (B,)), plus with
    ckpt_every > 0 the literal decode checkpoints (B, 4, N // 4 //
    ckpt_every - 1): record c-1 of stream s is the decoder's unread-bit
    cursor before forward symbol c * ckpt_every, 0 where the stream has no
    such symbol. Streams encode their
    symbols in reverse position order; each is aligned to position 0 by one
    roll, adjacent symbols merge into one field (two <= 11-bit codes fit 22
    bits), the streams pack by the tree deposit and compose at their byte
    bases by `shift_words`. Needs nlit >= 16 (ok says so).
    """
    B, N = lits.shape
    dev = lits.device
    nlit = nlit.to(torch.int64)
    seg = (nlit + 3) // 4
    P = N // 4  # per-stream symbol capacity

    pk = _lut256((lengths << 12) | codes, lits).to(torch.int32)
    pkf = pk.flip(-1)  # pkf[j] = packed code of lit[N-1-j]
    starts = torch.stack([seg * 0, seg, seg * 2, seg * 3], -1)
    ends = torch.stack([seg, seg * 2, seg * 3, nlit], -1)
    # Stream s's reversed symbols start at flip index N - ends[s]: a right
    # roll by ends[s] puts them at 0 (mod N when nlit == N). One roll for all
    # four streams.
    pks = dynroll(pkf[:, None, :].expand(B, 4, N), ends % N)[..., :P].to(torch.int64)
    live = torch.arange(P, device=dev) < (ends - starts)[..., None]
    l_s = torch.where(live, pks >> 12, 0)
    c_s = torch.where(live, pks & 0xFFF, 0)
    if ckpt_every:
        # The cursor before forward symbol k is the exclusive prefix of the
        # reversed-order code lengths at reversed index n_s - k.
        cume = torch.cumsum(l_s, -1) - l_s
        c_ar = torch.arange(1, P // ckpt_every, device=dev)
        ti = (ends - starts)[..., None] - c_ar * ckpt_every
        lit_ck = torch.where(ti >= 1, cume.gather(2, torch.clamp(ti, 0, P - 1)), 0)
    v2 = c_s[..., 0::2] | (c_s[..., 1::2] << l_s[..., 0::2])  # <= 22 bits
    l2 = l_s[..., 0::2] + l_s[..., 1::2]

    num_words = out_cap // 4
    NW_S = (P * MAX_BITS) // 32 + 2  # per-stream word capacity
    sw, sb = deposit_bits_tree(
        v2.reshape(B * 4, -1), l2.reshape(B * 4, -1), NW_S, max_field_bits=2 * MAX_BITS
    )
    stream_bits = sb.reshape(B, 4)
    stream_bytes = (stream_bits + 1 + 7) >> 3  # + sentinel bit
    byte_base = torch.cumsum(stream_bytes, -1) - stream_bytes

    # Sentinel bit at each stream's data end.
    jw = torch.arange(NW_S, device=dev)
    sent = torch.where(
        jw == (stream_bits >> 5)[..., None], 1 << (stream_bits & 31)[..., None], 0
    )
    words = shift_words(
        (sw.reshape(B, 4, NW_S) + sent).reshape(B * 4, NW_S),
        (byte_base * 8).reshape(-1), num_words,
    ).reshape(B, 4, num_words).sum(1) & M32

    jump = torch.stack(
        [(stream_bytes[:, k] >> sh) & 0xFF for k in range(3) for sh in (0, 8)], -1
    ).to(torch.uint8)
    ok = (stream_bytes <= 0xFFFF).all(-1) & (nlit >= 16)
    out = torch.cat(
        [jump, words_to_bytes(words), torch.zeros((B, 2), dtype=torch.uint8, device=dev)], -1
    )
    if ckpt_every:
        return out, 6 + stream_bytes.sum(-1), ok, lit_ck
    return out, 6 + stream_bytes.sum(-1), ok


def compress_literals_huffman(
    lits: torch.Tensor, nlit: torch.Tensor, out_cap: int, ckpt_every: int = 0
):
    """Full Huffman literals payload: weights header + 4-stream body.

    Returns (payload (B, out_cap + 4096) uint8, payload_len (B,), ok (B,)),
    plus the literal decode checkpoints of `encode_literals_4stream` with
    ckpt_every > 0 (the code lengths are the same either way: the JAX
    package's accel limit ACCEL_MAX_BITS equals MAX_BITS). Callers compare
    against the Raw representation and pick the smaller.
    """
    hist = literal_histogram(lits, nlit)
    lengths, ok_l = build_lengths(hist, nlit, MAX_BITS)
    codes = canonical_codes(lengths)
    whdr, wlen, ok_w = weights_header(lengths)
    fpay, flen, ok_f = weights_fse_payload(lengths)
    enc = encode_literals_4stream(lits, nlit, lengths, codes, out_cap, ckpt_every)
    body, blen, ok_s = enc[:3]

    # Weights representation: FSE-compressed (headerByte < 128 = its size)
    # when it is valid and smaller, or when direct is impossible (> 128
    # explicit weights); else direct 4-bit.
    use_fse = ok_f & (~ok_w | (1 + flen < wlen))
    hcap = max(129, WEIGHT_CAP + 1)
    hdr_f = torch.cat([(flen & 0xFF).to(torch.uint8)[:, None], fpay], -1)
    hdr_arr = torch.where(
        use_fse[:, None], F.pad(hdr_f, (0, hcap - hdr_f.shape[1])),
        F.pad(whdr, (0, hcap - whdr.shape[1])),
    )
    hdr_len = torch.where(use_fse, 1 + flen, wlen)

    cap2 = out_cap + 4096
    out = place(hdr_arr, hdr_len, 0, cap2) + place(body, blen, hdr_len, cap2)
    return (out, hdr_len + blen, ok_l & (ok_w | ok_f) & ok_s) + enc[3:]
