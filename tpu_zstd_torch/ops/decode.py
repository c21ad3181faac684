"""Device decode in plain PyTorch: FSE sequence decode, 4-stream Huffman
literal decode and sequence execution (RFC 8878 §3.1.1.3-3.1.1.5).

Counterpart of tpu_zstd/ops/decode_jax.py. These functions are the plain
versions of the decode kernels: `decode_sequences_chunks` of K7
(csrc/decode_seq.cu), `decode_huffman_device` of K6 (csrc/decode_huf.cu)
and `execute_sequences_device` of K8/K9 (csrc/exec.cu); the wrappers in
ops/decode_lanes.py and ops/exec.py run them on CPU tensors.

Bitstreams are read backward from u32 words held in int64. A read of n <= 32
bits below the cursor takes a 64-bit window from two words; bits below the
stream start and past its row's end read as zeros, so a Huffman peek near
the start is libzstd's zero-padded lookup. The decode loops are loops over
steps, vectorized over rows (one row per block, or per checkpointed chunk
of a block); each runs to the batch's live maximum (max nseq or nsym), not
to the static capacity. Outputs past nseq / nsym are zero, as in the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import LL_BASELINE, LL_BITS, ML_BASELINE, ML_BITS, REPCODE_INIT

MAX_TABLE_LOG = 9  # RFC limits: LL <= 9, OF <= 8, ML <= 9
TSIZE_MAX = 1 << MAX_TABLE_LOG
HUF_TSIZE = 2048   # 1 << HUF_MAX_BITS: literal decode-table capacity


class SeqTables(NamedTuple):
    """Dense per-block decode tables, padded to TSIZE_MAX states: symbol,
    nb_bits, new_state (B, 3, TSIZE_MAX) with axis 1 = (LL, OF, ML), and
    table_log (B, 3)."""

    symbol: torch.Tensor
    nb_bits: torch.Tensor
    new_state: torch.Tensor
    table_log: torch.Tensor


class PackedSeqTables(NamedTuple):
    """The decode tables as K7 takes them: packed (B, 3, TSIZE_MAX) int32,
    symbol | nb_bits << 8 | new_state << 16, and table_log (B, 3) int32."""

    packed: torch.Tensor
    table_log: torch.Tensor


def pack_seq_tables(tables: SeqTables) -> PackedSeqTables:
    packed = (tables.symbol.to(torch.int32) | (tables.nb_bits.to(torch.int32) << 8)
              | (tables.new_state.to(torch.int32) << 16))
    return PackedSeqTables(packed.contiguous(), tables.table_log.to(torch.int32).contiguous())


def _pack_words(streams: torch.Tensor) -> torch.Tensor:
    """(B, S) uint8 little-endian streams -> (B, ceil(S/4)) u32 words in int64."""
    B, S = streams.shape
    b = torch.nn.functional.pad(streams, (0, (-S) % 4)).to(torch.int64).reshape(B, -1, 4)
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def _read(words: torch.Tensor, wbase: torch.Tensor, nw: int, bits_left: torch.Tensor, n):
    """n (<= 32) bits [bits_left - n, bits_left) of each row's stream.

    words: flat u32 words of all streams, each row's nw words between two
    zero words; wbase (R,) each row's first word; positions outside the row
    read as zeros. Returns (value, bits_left - n).
    """
    nl = bits_left - n
    w = nl >> 5  # floor: negative below the stream start
    lo = words[wbase + torch.clamp(w, -1, nw)]
    hi = words[wbase + torch.clamp(w + 1, -1, nw)]
    v = ((lo | ((hi & 0x7FFFFFFF) << 32)) >> (nl & 31)) & ((1 << n) - 1)
    return v, nl


def _stream_words(streams: torch.Tensor, rows: torch.Tensor):
    """Flat words of (B, S) streams, each row's between two zero words, the
    first word of each row's stream for `rows` (R,) block indices, and the
    words a row."""
    words = torch.nn.functional.pad(_pack_words(streams), (1, 1))
    return words.reshape(-1), rows * words.shape[1] + 1, words.shape[1] - 2


def decode_sequences_chunks(
    streams, total_bits, tables: SeqTables, nseq, rep0, ck_bits, ck_states, ck_rep,
    stride: int, num_chunks: int, max_seqs: int,
):
    """FSE sequence decode of num_chunks chunks of `stride` sequences per
    block, each chunk one row (the plain version of K7).

    streams (B, S) uint8 sequence bitstreams; total_bits (B,) data bits
    (sentinel stripped); tables: SeqTables or PackedSeqTables; nseq (B,);
    rep0 (B, 3) the rep triple before sequence 0. Chunk 0 reads its LL, OF,
    ML states from the stream head; chunk c >= 1 starts from checkpoint
    record c-1: ck_bits
    (B, K) unread-bit cursor, ck_states (B, K) packed ll | of<<10 | ml<<20,
    ck_rep (B, K, 3) rep triple (K >= num_chunks - 1 where a block has that
    many chunks). num_chunks = 1 is the serial decode of a whole block.
    Offsets are resolved (RFC 8878 §3.1.1.5) in int32, wrapping as the JAX
    package's do; states update after every sequence but a block's last and
    index their table modulo TSIZE_MAX; offset codes above 31 read as 31.
    Returns (ll, ml, off) (B, max_seqs) int32, sequence j at column j, zero
    past nseq, and each row's final rep triple (B * num_chunks, 3).
    """
    B = streams.shape[0]
    NC = num_chunks
    dev = streams.device
    R = B * NC
    blk = torch.arange(B, device=dev).repeat_interleave(NC)
    cix = torch.arange(NC, device=dev).repeat(B)
    words, wbase, nw = _stream_words(streams, blk)
    nseq = nseq.to(torch.int64)
    if not isinstance(tables, PackedSeqTables):
        tables = pack_seq_tables(tables)
    tl = tables.table_log.to(torch.int64)[blk]
    tab = tables.packed.to(torch.int64).reshape(-1)
    tbase = (blk * 3)[:, None] * TSIZE_MAX + torch.arange(3, device=dev) * TSIZE_MAX

    bl = total_bits.to(torch.int64)[blk]
    s_ll, bl = _read(words, wbase, nw, bl, tl[:, 0])
    s_of, bl = _read(words, wbase, nw, bl, tl[:, 1])
    s_ml, bl = _read(words, wbase, nw, bl, tl[:, 2])
    rep = rep0.to(torch.int32)[blk]
    if NC > 1:
        def rec(a, fill, dtype=torch.int64):
            a = a.to(dtype)[:, : NC - 1]
            pad = [0, 0] * (a.dim() - 2) + [1, NC - 1 - a.shape[1]]
            return torch.nn.functional.pad(a, pad, value=fill).reshape(R, *a.shape[2:])

        first = cix == 0
        st = rec(ck_states, 0)
        bl = torch.where(first, bl, rec(ck_bits, 0))
        s_ll = torch.where(first, s_ll, st & 0x3FF)
        s_of = torch.where(first, s_of, (st >> 10) & 0x3FF)
        s_ml = torch.where(first, s_ml, (st >> 20) & 0x3FF)
        rep = torch.where(first[:, None], rep, rec(ck_rep, 1, torch.int32))

    # Code -> baseline | extra bits << 24, LL codes at 0.., ML codes at 64..
    vtab = torch.zeros(128, dtype=torch.int64, device=dev)
    vtab[: len(LL_BASELINE)] = torch.as_tensor(
        LL_BASELINE.astype("int64") | (LL_BITS.astype("int64") << 24), device=dev)
    vtab[64 : 64 + len(ML_BASELINE)] = torch.as_tensor(
        ML_BASELINE.astype("int64") | (ML_BITS.astype("int64") << 24), device=dev)
    nseq_r = nseq[blk]
    j0 = cix * stride
    steps = int(torch.clamp(nseq_r - j0, 0, stride).max()) if R else 0
    o_ll = torch.zeros((steps, R), dtype=torch.int64, device=dev)
    o_ml = torch.zeros_like(o_ll)
    o_off = torch.zeros_like(o_ll)
    for t in range(steps):
        j = j0 + t
        active = j < nseq_r
        p_ll = tab[tbase[:, 0] + (s_ll & (TSIZE_MAX - 1))]
        p_of = tab[tbase[:, 1] + (s_of & (TSIZE_MAX - 1))]
        p_ml = tab[tbase[:, 2] + (s_ml & (TSIZE_MAX - 1))]
        ofc = torch.clamp(p_of & 0xFF, max=31)
        llv = vtab[torch.clamp(p_ll & 0xFF, max=len(LL_BASELINE) - 1)]
        mlv = vtab[64 + torch.clamp(p_ml & 0xFF, max=len(ML_BASELINE) - 1)]
        ofx, b2 = _read(words, wbase, nw, bl, torch.where(active, ofc, 0))
        ofv = torch.where(ofc > 0, (1 << torch.clamp(ofc, max=30)) + ofx, 1).to(torch.int32)
        # ML extra bits, then LL extra bits: one read of <= 32 bits.
        nb_l = llv >> 24
        x, b2 = _read(words, wbase, nw, b2, torch.where(active, (mlv >> 24) + nb_l, 0))
        ml = (mlv & 0xFFFFFF) + (x >> nb_l)
        ll = (llv & 0xFFFFFF) + (x & ((1 << nb_l) - 1))
        r0, r1, r2 = rep[:, 0], rep[:, 1], rep[:, 2]
        idx = ofv - 1 + (ll == 0).to(torch.int32)
        off_rep = torch.where(idx == 0, r0, torch.where(
            idx == 1, r1, torch.where(idx == 2, r2, torch.clamp(r0 - 1, min=1))))
        is_lit = ofv > 3
        off = torch.where(is_lit, ofv - 3, off_rep)
        n1 = torch.where(is_lit, r0, torch.where(idx == 0, r1, r0))
        n2 = torch.where(is_lit, r1, torch.where(idx <= 1, r2, r1))
        rep = torch.where(active[:, None], torch.stack([off, n1, n2], 1), rep)
        # State bits, LL then ML then OF: one read of <= 26 bits.
        upd = active & (j < nseq_r - 1)
        nb_ll, nb_ml, nb_of = (p_ll >> 8) & 0xFF, (p_ml >> 8) & 0xFF, (p_of >> 8) & 0xFF
        v, b2 = _read(words, wbase, nw, b2, torch.where(upd, nb_ll + nb_ml + nb_of, 0))
        s_ll = torch.where(upd, (p_ll >> 16) + (v >> (nb_ml + nb_of)), s_ll)
        s_ml = torch.where(upd, (p_ml >> 16) + ((v >> nb_of) & ((1 << nb_ml) - 1)), s_ml)
        s_of = torch.where(upd, (p_of >> 16) + (v & ((1 << nb_of) - 1)), s_of)
        bl = torch.where(active, b2, bl)
        o_ll[t] = torch.where(active, ll, 0)
        o_ml[t] = torch.where(active, ml, 0)
        o_off[t] = torch.where(active, off, 0)

    def layout(o):  # (steps, R) -> (B, max_seqs), sequence j at column j
        full = torch.zeros((R, stride), dtype=torch.int32, device=dev)
        full[:, :steps] = o.T.to(torch.int32)
        full = full.reshape(B, NC * stride)
        if NC * stride >= max_seqs:
            return full[:, :max_seqs]
        return torch.nn.functional.pad(full, (0, max_seqs - NC * stride))

    return layout(o_ll), layout(o_ml), layout(o_off), rep


def final_rep(rep_rows: torch.Tensor, nseq: torch.Tensor, stride: int, num_chunks: int):
    """Each block's rep triple after its last sequence, from the per-row
    triples (B * num_chunks, 3) of `decode_sequences_chunks`: the row of
    chunk min((max(nseq, 1) - 1) // stride, num_chunks - 1). (B, 3) int32."""
    B = nseq.shape[0]
    last = torch.clamp(nseq.to(torch.int64), min=1) - 1
    cl = torch.clamp(last // stride, max=num_chunks - 1)
    return rep_rows.reshape(B, num_chunks, 3)[torch.arange(B, device=cl.device), cl]


def decode_sequences_device(streams, total_bits, tables: SeqTables, nseq, rep_init,
                            max_seqs: int):
    """Serial FSE sequence decode, one chain per block (reference
    decode_jax.decode_sequences_device). Returns (ll, ml, off (B, max_seqs)
    int32, rep_final (B, 3))."""
    return decode_sequences_chunks(streams, total_bits, tables, nseq, rep_init, None, None,
                                   None, max_seqs, 1, max_seqs)


def decode_sequences_device_chunked(streams, total_bits, tables: SeqTables, nseq, ck_bits,
                                    ck_states, ck_rep, stride: int, num_chunks: int,
                                    max_seqs: int):
    """Chunk-parallel FSE sequence decode from encoder-published checkpoints
    (reference decode_jax.decode_sequences_device_chunked); the rep triple
    before sequence 0 is (1, 4, 8). Returns (ll, ml, off (B, max_seqs)
    int32, rep_final), rep_final the initial triple (single-block frames)."""
    B = streams.shape[0]
    rep0 = torch.tensor([REPCODE_INIT], dtype=torch.int32, device=streams.device).expand(B, 3)
    ll, ml, off, _ = decode_sequences_chunks(streams, total_bits, tables, nseq, rep0, ck_bits,
                                             ck_states, ck_rep, stride, num_chunks, max_seqs)
    return ll, ml, off, rep0.contiguous()


def decode_huffman_device(streams, total_bits, dtable, table_log, nsym, stride: int,
                          num_chunks: int, ck_bits):
    """Chunk-parallel 4-stream Huffman literal decode (the plain version of
    K6; reference decode_jax.decode_huffman_device).

    streams (R0, SW) uint8, R0 = B * 4 stream rows; total_bits (R0,) data
    bits; dtable (B, 2048) int32 packed symbol << 4 | nb_bits; table_log
    (B,); nsym (R0,) symbols per stream; ck_bits (R0, K) cursor before
    forward symbol c * stride (record c-1; K >= chunks used - 1). Step
    (RFC 8878 §4.2.2): peek table_log bits (zero-padded past the stream
    start), look up (symbol, nb_bits), consume nb_bits. Returns
    (R0, num_chunks * stride) uint8 in forward order, zero past nsym.
    """
    R0 = streams.shape[0]
    NC = num_chunks
    dev = streams.device
    R = R0 * NC
    row = torch.arange(R0, device=dev).repeat_interleave(NC)
    cix = torch.arange(NC, device=dev).repeat(R0)
    words, wbase, nw = _stream_words(streams, row)
    bl = total_bits.to(torch.int64)[row]
    if NC > 1:
        ck = ck_bits.to(torch.int64)[:, : NC - 1]
        ck = torch.nn.functional.pad(ck, (1, NC - 1 - ck.shape[1])).reshape(R)
        bl = torch.where(cix == 0, bl, ck)
    blk = row >> 2
    tl = table_log.to(torch.int64)[blk]
    dt = dtable.to(torch.int64).reshape(-1)
    tbase = blk * HUF_TSIZE
    nsym_r = nsym.to(torch.int64)[row]
    j0 = cix * stride
    steps = int(torch.clamp(nsym_r - j0, 0, stride).max()) if R else 0
    out = torch.zeros((steps, R), dtype=torch.int64, device=dev)
    for t in range(steps):
        active = j0 + t < nsym_r
        idx, _ = _read(words, wbase, nw, bl, tl)
        e = dt[tbase + idx]
        bl = torch.where(active, bl - (e & 15), bl)
        out[t] = torch.where(active, e >> 4, 0)
    full = torch.zeros((R, stride), dtype=torch.uint8, device=dev)
    full[:, :steps] = out.T.to(torch.uint8)
    return full.reshape(R0, NC * stride)


def assemble_literals_4stream(syms: torch.Tensor, regen: torch.Tensor, out_cap: int):
    """Per-stream symbol rows (B * 4, SEGCAP) -> front-compacted literals
    (B, out_cap) uint8: stream s of block b holds seg = ceil(regen / 4)
    symbols (the 4th the remainder); output position p is stream p // seg at
    p % seg. Zero past regen."""
    B4, SEGCAP = syms.shape
    B = B4 // 4
    dev = syms.device
    p = torch.arange(out_cap, device=dev)[None, :]
    seg = torch.clamp((regen.to(torch.int64) + 3) >> 2, min=1)[:, None]
    s = torch.clamp(p // seg, max=3)
    j = torch.clamp(p - s * seg, 0, SEGCAP - 1)
    rows = torch.arange(B, device=dev)[:, None] * 4 + s
    out = syms.reshape(-1)[rows * SEGCAP + j]
    return torch.where(p < regen.to(torch.int64)[:, None], out, 0).to(torch.uint8)


def execute_sequences_device(lits, nlit, ll, ml, off, nseq, window, out_size: int,
                             win_size: int, lit_src=None):
    """Regenerate block contents (RFC 8878 §3.1.1.4) in parallel over output
    positions (the plain version of K8/K9; reference
    decode_jax.execute_sequences_device).

    lits (B, L) uint8 front-compacted literals, nlit (B,), ll/ml/off
    (B, MS) resolved sequences, nseq (B,), window (B, W) uint8 history
    right-aligned before the block. With lit_src = (syms (B * 4, SEGC)
    uint8, regen (B,)) literals come straight from K6's stream rows.

    Every output position gets a source: a literal index, a window byte, or
    an earlier output position (match bytes). Within a run of match
    positions sharing one offset the chain lands at base + (j - base) % off
    (base = run start - off) in one hop; the rest resolves by pointer
    doubling until every source is a literal or a window byte. Returns
    (out (B, out_size) uint8, out_len (B,)); bytes past out_len are
    unspecified.
    """
    B, MS = ll.shape
    N, W = out_size, win_size
    dev = ll.device
    i64 = torch.int64
    k = torch.arange(MS, device=dev)
    valid = k < nseq.to(i64)[:, None]
    llv = torch.where(valid, ll.to(i64), 0)
    mlv = torch.where(valid, ml.to(i64), 0)
    adv = llv + mlv
    out_start = torch.cumsum(adv, 1) - adv
    lit_start = torch.cumsum(llv, 1) - llv
    match_start = out_start + llv
    total_seq_out = adv.sum(1)
    total_lits_used = llv.sum(1)

    pos = torch.arange(N, device=dev)
    has_m = valid & (mlv > 0)
    ms_idx = torch.clamp(torch.where(has_m, match_start, N), max=N)
    me_idx = torch.clamp(torch.where(has_m, match_start + mlv, N), max=N)
    one = has_m.to(i64)
    diff = torch.zeros((B, N + 1), dtype=i64, device=dev)
    diff.scatter_add_(1, ms_idx, one).scatter_add_(1, me_idx, -one)
    in_match = torch.cumsum(diff[:, :N], 1) > 0

    # Offset per match position: each match run's offset, indexed by run id.
    run_rank = torch.cumsum(one, 1) - 1
    seq_of_run = torch.zeros((B, MS + 1), dtype=i64, device=dev)
    seq_of_run.scatter_(1, torch.where(has_m, run_rank, MS), torch.where(valid, off.to(i64), 0))
    is_mstart = torch.zeros((B, N + 1), dtype=i64, device=dev).scatter_add_(1, ms_idx, one)
    run_id = torch.cumsum(is_mstart[:, :N], 1) - 1
    off_at = seq_of_run.gather(1, torch.clamp(run_id, 0, MS))

    # Literal index per non-match position: j minus the match bytes before j.
    im = in_match.to(i64)
    lit_idx = pos[None, :] - (torch.cumsum(im, 1) - im)

    prev_match = torch.nn.functional.pad(in_match, (1, 0))[:, :N]
    prev_off = torch.nn.functional.pad(off_at, (1, 0), value=-1)[:, :N]
    new_run = in_match & (~prev_match | (off_at != prev_off))
    run_start = torch.cummax(torch.where(new_run, pos[None, :], 0), 1).values
    safe_off = torch.clamp(off_at, min=1)
    base = run_start - safe_off
    hop = torch.where(in_match, base + (pos[None, :] - base) % safe_off, pos[None, :] - off_at)
    L = lits.shape[1] if lit_src is None else N
    src = torch.where(in_match, W + hop, -lit_idx - 1)
    # Window byte w in [0, W) becomes -(L + w) - 1, so the final gather
    # splits the two terminal spaces.
    src = torch.where((src >= 0) & (src < W), -(L + src) - 1, torch.where(src >= 0, src - W, src))
    while bool((src >= 0).any()):
        src = torch.where(src >= 0, src.gather(1, torch.clamp(src, 0, N - 1)), src)

    term = -src - 1
    from_window = term >= L
    if lit_src is not None:
        syms, regen = lit_src
        SEGC = syms.shape[1]
        lidx = torch.clamp(term, 0, L - 1)
        seg_b = torch.clamp((regen.to(i64) + 3) >> 2, min=1)[:, None]
        s = torch.clamp(lidx // seg_b, max=3)
        jj = torch.clamp(lidx - s * seg_b, 0, SEGC - 1)
        srow = torch.arange(B, device=dev)[:, None] * 4 + s
        lit_gather = syms.reshape(-1)[srow * SEGC + jj]
    else:
        lit_gather = lits.gather(1, torch.clamp(term, 0, L - 1))
    if W > 0:
        win_gather = window.gather(1, torch.clamp(term - L, 0, W - 1))
    else:
        win_gather = torch.zeros((B, N), dtype=torch.uint8, device=dev)
    out = torch.where(from_window, win_gather, lit_gather)
    return out, total_seq_out + (nlit.to(i64) - total_lits_used)
