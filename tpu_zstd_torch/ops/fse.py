"""Batched FSE (tANS) sequence-section encoder (RFC 8878 §3.1.1.3.2).

Counterpart of tpu_zstd/ops/fse_jax.py. Two encoders:

- `encode_sequences_predefined`: the predefined tables (compression mode 0)
  for every block.
- `prepare_sequences_auto` + `encode_prepared`: per-block, per-stream mode
  selection (RLE, custom tables, predefined; ops/fse_tables.py), with the
  state chains of all streams in one `chain.state_chain3` call (kernel K5 on
  a card).

In the predefined encoder the ANS state chain is sequential
(state_t = T[sym_t, state_{t-1}]); as in the JAX package it is broken into
CHUNK-sized chunks:

  Phase A (parallel over chunks): evolve every possible entry state through
          each chunk's symbols, giving each chunk's transition function.
  Phase B: thread the real entry state through the chunk functions. The JAX
          package scans the chunks; here the functions are composed by a
          log-depth prefix scan (a gather per level), which gives the same
          entry states in log2(chunks) steps.
  Phase C (parallel over chunks): re-walk each chunk from its entry state,
          recording the pre-transition states.

The three streams (LL, OF, ML) run as one stack with their tables padded to
a common shape. Table lookups are integer indexing where the JAX package
uses exact bf16 one-hot contractions; an out-of-range index reads 0, as a
one-hot of nothing does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import (
    LL_BITS,
    LL_CODE_TABLE,
    LL_DEFAULT_LOG,
    LL_DEFAULT_NORM,
    LL_DELTA_CODE,
    ML_BITS,
    ML_CODE_TABLE,
    ML_DEFAULT_LOG,
    ML_DEFAULT_NORM,
    ML_DELTA_CODE,
    OF_DEFAULT_LOG,
    OF_DEFAULT_NORM,
    SEQ_RLE,
)
from ..format.fse import build_ctable
from .bitpack import M32, deposit_bits, dynroll, place, words_to_bytes
from .chain import state_chain3

CHUNK = 64  # sequences per chunk in the state pre-pass


class EncTables:
    """Dense (symbol, state) -> (next_state, nb_bits) transition tables
    (numpy; copied to a device at use)."""

    def __init__(self, norm: np.ndarray, table_log: int):
        ct = build_ctable(norm, table_log)
        ts = 1 << table_log
        nsym = len(norm)
        u = np.arange(ts, dtype=np.int64)
        value = ts + u  # zstd state "value" range [ts, 2*ts)
        dnb = ct.delta_nb_bits.astype(np.int64)
        dfs = ct.delta_find_state.astype(np.int64)
        nb = (value[None, :] + dnb[:, None]) >> 16  # (nsym, ts)
        idx = (value[None, :] >> nb) + dfs[:, None]
        nxt = ct.state_table.astype(np.int64)[idx] - ts
        # Init state per symbol (FSE_initCState2 semantics).
        nb0 = (dnb + (1 << 15)) >> 16
        v0 = (nb0 << 16) - dnb
        init = ct.state_table.astype(np.int64)[(v0 >> nb0) + dfs] - ts

        self.table_log = table_log
        self.table_size = ts
        self.num_symbols = nsym
        self.next2d = nxt.astype(np.int32)       # (nsym, ts)
        self.nb2d = nb.astype(np.int32)          # (nsym, ts)
        self.init_state = init.astype(np.int32)  # (nsym,)
        # Closed-form params (see fse_tables.build_cf_tables).
        self.dnb = dnb.astype(np.int32)                     # (nsym,)
        self.dfs = dfs.astype(np.int32)                     # (nsym,)
        self.state_table = ct.state_table.astype(np.int32)  # (ts,) in [ts, 2ts)


_PREDEF_ENC = (
    EncTables(LL_DEFAULT_NORM, LL_DEFAULT_LOG),
    EncTables(OF_DEFAULT_NORM, OF_DEFAULT_LOG),
    EncTables(ML_DEFAULT_NORM, ML_DEFAULT_LOG),
)


def predefined_enc_tables() -> tuple[EncTables, EncTables, EncTables]:
    """(LL, OF, ML) encode tables for the RFC 8878 predefined distributions."""
    return _PREDEF_ENC


# --- Code mapping (value -> code) ---------------------------------------------------


def highbit32(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for 1 <= v < 2^32, elementwise (int64)."""
    v = v.to(torch.int64)
    out = torch.zeros_like(v)
    for shift in (16, 8, 4, 2, 1):
        m = v >= (1 << shift)
        out = out + torch.where(m, shift, 0)
        v = torch.where(m, v >> shift, v)
    return out


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> dict:
    """The constant tables as int64 tensors on `device`, copied there once
    (a copy from host memory inside the pipeline would stall the stream)."""
    tabs = predefined_enc_tables()

    def stack(attr):
        arrs = [getattr(t, attr).astype(np.int64) for t in tabs]
        nsym = max(a.shape[0] for a in arrs)
        pads = [[(0, nsym - a.shape[0])] + ([(0, 64 - a.shape[1])] if a.ndim == 2 else []) for a in arrs]
        return np.stack([np.pad(a, p) for a, p in zip(arrs, pads)])

    host = {
        "LL_CODE_TABLE": LL_CODE_TABLE, "ML_CODE_TABLE": ML_CODE_TABLE,
        "LL_BITS": LL_BITS, "ML_BITS": ML_BITS,
        # (LL, OF, ML) stacked, zero-padded to 53 symbols x 64 states.
        "next2d": stack("next2d"), "init_state": stack("init_state"), "nb2d": stack("nb2d"),
        "table_size": np.array([t.table_size for t in tabs]),
    }
    return {k: torch.as_tensor(v.astype(np.int64), device=device) for k, v in host.items()}


def _small_lut(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] from a tiny table; 0 where idx is out of range."""
    ok = (idx >= 0) & (idx < table.shape[0])
    return torch.where(ok, table[torch.clamp(idx, 0, table.shape[0] - 1)], 0)


def ll_code(ll: torch.Tensor) -> torch.Tensor:
    lut = _device_tables(ll.device)["LL_CODE_TABLE"]
    return torch.where(
        ll < 64,
        _small_lut(lut, torch.clamp(ll, max=63)),
        LL_DELTA_CODE + highbit32(torch.clamp(ll, min=1)),
    )


def ml_code(ml: torch.Tensor) -> torch.Tensor:
    lut = _device_tables(ml.device)["ML_CODE_TABLE"]
    base = ml - 3
    return torch.where(
        base < 128,
        _small_lut(lut, torch.clamp(base, max=127)),
        ML_DELTA_CODE + highbit32(torch.clamp(base, min=1)),
    )


def of_code(ob: torch.Tensor) -> torch.Tensor:
    return highbit32(torch.clamp(ob, min=1))


# --- State chains -------------------------------------------------------------------


def _lookup(flat: torch.Tensor, base: torch.Tensor, nsym: int, ts: int, sym, state):
    """flat[table t][sym, state] with t's offset `base` (broadcast); 0 where
    sym is out of the padded range."""
    ok = (sym >= 0) & (sym < nsym)
    idx = base + torch.clamp(sym, 0, nsym - 1) * ts + state
    return torch.where(ok, flat[idx], 0)


def _state_chain_rt(next2d: torch.Tensor, init_table: torch.Tensor, rsym, nseq, max_seqs: int):
    """States of T stacked FSE streams processed in encoder order.

    next2d: (T, nsym, ts) transition tables; init_table: (T, nsym);
    rsym: (T, B, max_seqs), rsym[t, b, i] = symbol of sequence nseq[b]-1-i of
    stream t (i = 0 is the init symbol); transitions consume rsym[..., i]
    for i in [1, nseq). Returns (pre_states (T, B, max_seqs), final (T, B)):
    pre_states[..., i] is the state BEFORE consuming rsym[..., i].
    """
    T, nsym, ts = next2d.shape
    _, B, ms = rsym.shape
    nc = ms // CHUNK
    dev = rsym.device
    flat = next2d.reshape(-1)
    base = (torch.arange(T, device=dev) * (nsym * ts)).view(T, 1, 1)
    ok0 = (rsym[..., 0] >= 0) & (rsym[..., 0] < nsym)
    init = torch.where(
        ok0, torch.gather(init_table[:, None, :].expand(T, B, nsym), 2,
                          torch.clamp(rsym[..., :1], 0, nsym - 1))[..., 0], 0
    )
    # Step s consumes rsym[s + 1]; lay steps out as (chunks, CHUNK).
    st_sym = torch.roll(rsym, -1, -1).reshape(T, B, nc, CHUNK)
    t_idx = torch.arange(ms, device=dev).reshape(nc, CHUNK)
    st_valid = (t_idx + 1) < nseq.view(1, B, 1, 1)

    # Phase A: per-chunk transition function over all ts entry states.
    fn = torch.arange(ts, device=dev).expand(T, B, nc, ts)
    base4 = base[..., None]
    for i in range(CHUNK):
        sym = st_sym[..., i : i + 1]
        nxt = _lookup(flat, base4, nsym, ts, sym, fn)
        fn = torch.where(st_valid[..., i : i + 1], nxt, fn)

    # Phase B: inclusive prefix composition H[c] = fn[c] o ... o fn[0].
    H = fn
    d = 1
    while d < nc:
        comp = torch.gather(H[:, :, d:], 3, H[:, :, :-d])
        H = torch.cat([H[:, :, :d], comp], dim=2)
        d *= 2
    at_init = torch.gather(H, 3, init[..., None, None].expand(T, B, nc, 1))[..., 0]
    entries = torch.cat([init[..., None], at_init[..., :-1]], dim=-1)  # (T, B, nc)
    final = at_init[..., -1]

    # Phase C: re-walk each chunk from its entry state.
    states = entries
    pre = torch.empty((T, B, nc, CHUNK), dtype=torch.int64, device=dev)
    for i in range(CHUNK):
        pre[..., i] = states
        nxt = _lookup(flat, base, nsym, ts, st_sym[..., i], states)
        states = torch.where(st_valid[..., i], nxt, states)
    pre_states = torch.roll(pre.reshape(T, B, ms), 1, -1)
    return pre_states, final


def _state_chain(rsym: torch.Tensor, nseq: torch.Tensor, max_seqs: int):
    """The predefined (LL, OF, ML) tables over _state_chain_rt: rsym
    (3, B, max_seqs) holds the LL, OF and ML symbols."""
    t = _device_tables(rsym.device)
    return _state_chain_rt(t["next2d"], t["init_state"], rsym, nseq, max_seqs)


def encode_sequences_predefined(
    ll: torch.Tensor,
    ml: torch.Tensor,
    ob: torch.Tensor,
    nseq: torch.Tensor,
    max_seqs: int,
    out_bytes_cap: int,
):
    """Encode each block's sequences with the predefined FSE tables (mode 0).

    ll/ml/ob: (B, max_seqs) int32 (entries >= nseq are ignored); nseq (B,).
    Returns (section_bytes (B, out_bytes_cap + 8) uint8, section_len (B,)).
    Emission order follows the JAX package (validated there against stock
    libzstd).
    """
    tl, to, tm = predefined_enc_tables()
    ms = max_seqs
    B = ll.shape[0]
    dev = ll.device
    nseq = nseq.to(torch.int64)

    # Reverse to encoder order once, all three fields in one roll:
    # r[i] = x[nseq - 1 - i].
    x3 = torch.stack([ll, ml, ob]).to(torch.int32).flip(-1)
    r = dynroll(x3, ((nseq - ms) % ms)[None, :]).to(torch.int64)
    r_ll, r_ml, r_ob = r[0], r[1], r[2]
    r_llc = ll_code(r_ll)
    r_mlc = ml_code(r_ml)
    r_ofc = of_code(r_ob)
    r_llb = _small_lut(_device_tables(dev)["LL_BITS"], r_llc)
    r_mlb = _small_lut(_device_tables(dev)["ML_BITS"], r_mlc)
    r_ofb = r_ofc

    rsym = torch.stack([r_llc, r_ofc, r_mlc])
    pre, fin = _state_chain(rsym, nseq, ms)
    # Per-step state bit counts and (pre-masked) values; valid for 1 <= i < nseq.
    tabs = _device_tables(dev)
    T, nsym, ts = tabs["nb2d"].shape
    base = (torch.arange(T, device=dev) * (nsym * ts)).view(T, 1, 1)
    nb = _lookup(tabs["nb2d"].reshape(-1), base, nsym, ts, rsym, pre)
    val = (tabs["table_size"].view(T, 1, 1) + pre) & ((1 << nb) - 1)
    nb_ll, nb_of, nb_ml = nb[0], nb[1], nb[2]
    v_ll, v_of, v_ml = val[0], val[1], val[2]

    t_ar = torch.arange(ms, device=dev)
    is_step = (t_ar >= 1) & (t_ar < nseq[:, None])
    is_seq = t_ar < nseq[:, None]

    # Three packed fields per i (write order: OF, ML, LL state bits; LL, ML,
    # OF extra bits).
    def mask(v, b):
        return v & ((1 << b) - 1)

    f1 = v_of | (v_ml << nb_of) | (v_ll << (nb_of + nb_ml))
    l1 = torch.where(is_step, nb_of + nb_ml + nb_ll, 0)
    f2 = mask(r_ll, r_llb) | (mask(r_ml - 3, r_mlb) << r_llb)
    l2 = torch.where(is_seq, r_llb + r_mlb, 0)
    f3 = mask(r_ob, r_ofb)
    l3 = torch.where(is_seq, r_ofb, 0)
    lens = torch.stack([l1, l2, l3], dim=-1).reshape(B, -1)
    vals = torch.stack([f1, f2, f3], dim=-1).reshape(B, -1)

    # Tail: flush ML, OF, LL states (table_log bits each) + sentinel 1-bit.
    has = (nseq > 0).to(torch.int64)
    tail_val = (
        fin[2]
        | (fin[1] << tm.table_log)
        | (fin[0] << (tm.table_log + to.table_log))
        | (1 << (tm.table_log + to.table_log + tl.table_log))
    )
    tail_len = has * (tm.table_log + to.table_log + tl.table_log + 1)
    all_lens = torch.cat([lens, tail_len[:, None]], dim=1)
    all_vals = torch.cat([vals, tail_val[:, None]], dim=1) & 0xFFFFFFFF

    words, total_bits = deposit_bits(all_vals, all_lens, out_bytes_cap // 4)
    stream_bytes = (total_bits + 7) >> 3

    # Section header: nbSeq varint + mode byte (predefined = 0x00).
    b0 = torch.where(nseq < 128, nseq, torch.where(nseq < 0x7F00, (nseq >> 8) + 0x80, 255))
    b1 = torch.where(nseq < 0x7F00, nseq & 0xFF, (nseq - 0x7F00) & 0xFF)
    b2 = ((nseq - 0x7F00) >> 8) & 0xFF
    hdr_len = torch.where(nseq < 128, 1, torch.where(nseq < 0x7F00, 2, 3)) + has
    zero = torch.zeros_like(nseq)
    hdr = torch.stack(
        [b0, torch.where(nseq < 128, 0, b1), torch.where(nseq < 0x7F00, 0, b2), zero], dim=1
    ).to(torch.uint8)
    # (mode byte 0x00 is already zero at position hdr_len - 1)

    stream = words_to_bytes(words)
    out_len_cap = out_bytes_cap + 8
    out = place(hdr, hdr_len, 0, out_len_cap) + place(stream, has * stream_bytes, hdr_len, out_len_cap)
    return out, hdr_len + has * stream_bytes


# --- Decoder repcode triples (decode checkpoints) ------------------------------------

# Source slot of each new rep slot per step kind (3 = the step's own offset):
# identity (inactive / rep0), rep1 read, rep2 read, front insert.
_REP_SRC_TABLE = ((0, 1, 2), (1, 0, 2), (2, 0, 1), (3, 0, 1))


def _rep_prefix(ob, ll, off, nseq) -> torch.Tensor:
    """Decoder repcode triple BEFORE each decode step (RFC 8878 §3.1.1.5).

    ob/ll/off (B, ms) in decode order (offset value, literal length,
    resolved offset); nseq (B,). Each step's rep update is a slot
    permutation (rep0/1/2 reads) or a front insert of the resolved offset,
    so the prefix over steps is an associative composition of
    {permutation | insert} ops, taken in log2(ms) doubling rounds (the JAX
    package's associative scan). Returns (B, ms, 3) int64.
    """
    B, ms = ob.shape
    dev = ob.device
    ob = ob.to(torch.int64)
    act = torch.arange(ms, device=dev) < nseq.to(torch.int64)[:, None]
    idx = ob - 1 + (ll == 0).to(torch.int64)
    is_insert = (ob > 3) | (idx == 3)
    case = torch.where(act, torch.where(is_insert, 3, torch.clamp(idx, 0, 2)), 0)
    src = torch.tensor(_REP_SRC_TABLE, dtype=torch.int64, device=dev)[case]  # (B, ms, 3)
    const = off.to(torch.int64)[..., None].expand(B, ms, 3)
    d = 1
    while d < ms:  # inclusive scan: step t composed after steps t-d, t-2d, ...
        a_src, a_const = src[:, :-d], const[:, :-d]
        b_src, b_const = src[:, d:], const[:, d:]
        sel = torch.clamp(b_src, 0, 2)
        ins = b_src == 3
        c_src = torch.where(ins, 3, a_src.gather(2, sel))
        c_const = torch.where(ins, b_const, a_const.gather(2, sel))
        src = torch.cat([src[:, :d], c_src], 1)
        const = torch.cat([const[:, :d], c_const], 1)
        d *= 2
    init = torch.tensor((1, 4, 8), dtype=torch.int64, device=dev)
    rep_after = torch.where(src == 3, const, init[torch.clamp(src, 0, 2)])
    return torch.cat([init.expand(B, 1, 3), rep_after[:, :-1]], 1)


# --- Per-block table selection (custom FSE) ------------------------------------------


def prepare_sequences_auto(ll, ml, ob, nseq, max_seqs: int, off=None) -> dict:
    """Bucket-independent half of the auto sequence encoder, per block.

    ll/ml/ob (B, max_seqs) (entries >= nseq ignored), nseq (B,). Reverses to
    encoder order, maps codes and builds each stream's tables (RLE / custom
    FSE / predefined, ops/fse_tables.py). Stream-stacked entries are
    (B, 3, ...) in LL, OF, ML order, alphabets padded to 53 symbols. With
    the resolved offsets `off`, "rep_pre" holds the decoder's rep triple
    before each decode step (for decode checkpoints).
    """
    from .fse_tables import choose_stream_tables, stream_specs

    spec_ll, spec_of, spec_ml = stream_specs()
    ms = max_seqs
    nseq = nseq.to(torch.int64)
    dev = ll.device

    # Reverse all three columns in one stacked flip + roll (same shift).
    x3 = torch.stack([ll, ml, ob]).to(torch.int32).flip(-1)
    r = dynroll(x3, ((nseq - ms) % ms)[None, :]).to(torch.int64)
    r_ll, r_ml, r_ob = r[0], r[1], r[2]
    r_llc = ll_code(r_ll)
    r_mlc = ml_code(r_ml)
    r_ofc = of_code(r_ob)

    tabs = [choose_stream_tables(c, nseq, sp)
            for c, sp in ((r_llc, spec_ll), (r_ofc, spec_of), (r_mlc, spec_ml))]
    S = max(spec_ll.nsym, spec_of.nsym, spec_ml.nsym)

    def stack(key, pad=False):
        xs = [t[key] for t in tabs]
        if pad:
            xs = [F.pad(x, (0, S - x.shape[-1])) for x in xs]
        return torch.stack(xs, 1)

    d = _device_tables(dev)
    return {
        "r_ll": r_ll,
        "r_ml": r_ml,
        "r_ob": r_ob,
        "rep_pre": _rep_prefix(ob, ll, off, nseq) if off is not None else None,
        "rsym3": torch.stack([r_llc, r_ofc, r_mlc], 1),
        "r_llb": _small_lut(d["LL_BITS"], r_llc),
        "r_mlb": _small_lut(d["ML_BITS"], r_mlc),
        "st3": stack("st"),
        "dnb3": stack("dnb", pad=True),
        "dfs3": stack("dfs", pad=True),
        "init3": stack("init", pad=True),
        "tl3": stack("table_log"),
        "mode3": stack("mode"),
        "desc_ll": tabs[0]["desc"],
        "desc_of": tabs[1]["desc"],
        "desc_ml": tabs[2]["desc"],
        "dlen3": stack("desc_len"),
    }


def encode_prepared(
    prep: dict, nseq: torch.Tensor, msb: int, out_bytes_cap: int, ckpt_every: int = 0
):
    """Bucket-sized half: state chains, bit fields, deposit, section assembly.

    msb >= max(nseq) (the caller picks the bucket); prep arrays are sliced to
    msb (the reversed order puts every live entry in the prefix). The
    3 x B state chains run as one `state_chain3` call. Returns
    (section_bytes (B, out_bytes_cap + 8) uint8, section_len (B,)), plus
    with ckpt_every > 0 the decoder checkpoints (ck_bits, ck_states, ck_rep)
    (B, msb // ckpt_every[, 3]): record c-1 describes decode step
    c * ckpt_every, zero (reps 1) where that step is not below nseq.
    """
    nseq = nseq.to(torch.int64)
    rsym3 = prep["rsym3"][..., :msb]
    B = rsym3.shape[0]
    dev = rsym3.device
    S = prep["dnb3"].shape[-1]
    tl3 = prep["tl3"].to(torch.int64)
    rle3 = prep["mode3"] == SEQ_RLE
    pre3, fin3, nb3 = state_chain3(
        prep["st3"].reshape(B * 3, -1), prep["dnb3"].reshape(B * 3, S),
        prep["dfs3"].reshape(B * 3, S), prep["init3"].reshape(B * 3, S),
        tl3.reshape(-1), rle3.reshape(-1), rsym3.reshape(B * 3, msb),
        nseq.repeat_interleave(3),
    )
    t_ar = torch.arange(msb, device=dev)
    is_step = (t_ar >= 1) & (t_ar < nseq[:, None])
    is_seq = t_ar < nseq[:, None]
    # Chain outputs count only for 1 <= t < nseq.
    pre3 = torch.where(is_step[:, None], pre3.reshape(B, 3, msb).to(torch.int64), 0)
    nb3 = torch.where(is_step[:, None], nb3.reshape(B, 3, msb).to(torch.int64), 0)
    fin3 = fin3.reshape(B, 3).to(torch.int64)

    v3 = ((1 << tl3)[..., None] + pre3) & ((1 << nb3) - 1)
    nb_ll, nb_of, nb_ml = nb3[:, 0], nb3[:, 1], nb3[:, 2]
    v_ll, v_of, v_ml = v3[:, 0], v3[:, 1], v3[:, 2]
    r_ll = prep["r_ll"][:, :msb]
    r_ml = prep["r_ml"][:, :msb]
    r_ob = prep["r_ob"][:, :msb]
    r_llb = prep["r_llb"][:, :msb]
    r_mlb = prep["r_mlb"][:, :msb]
    r_ofb = rsym3[:, 1].to(torch.int64)

    def mask(v, b):
        return v & ((1 << b) - 1)

    # Three packed fields per t (write order: OF, ML, LL state bits; LL, ML,
    # OF extra bits).
    f1 = v_of | (v_ml << nb_of) | (v_ll << (nb_of + nb_ml))
    l1 = torch.where(is_step, nb_of + nb_ml + nb_ll, 0)
    f2 = mask(r_ll, r_llb) | (mask(r_ml - 3, r_mlb) << r_llb)
    l2 = torch.where(is_seq, r_llb + r_mlb, 0)
    f3 = mask(r_ob, r_ofb)
    l3 = torch.where(is_seq, r_ofb, 0)
    lens = torch.stack([l1, l2, l3], dim=-1).reshape(B, -1)
    vals = torch.stack([f1, f2, f3], dim=-1).reshape(B, -1)
    if ckpt_every:
        ck = _checkpoints(prep, pre3, l1 + l2 + l3, nseq, msb, ckpt_every)

    # Tail: flush ML, OF, LL states (table_log bits each) + sentinel 1-bit.
    has = (nseq > 0).to(torch.int64)
    tl_l, tl_o, tl_m = tl3[:, 0], tl3[:, 1], tl3[:, 2]
    tail_val = (
        fin3[:, 2]
        | (fin3[:, 1] << tl_m)
        | (fin3[:, 0] << (tl_m + tl_o))
        | (1 << (tl_m + tl_o + tl_l))
    )
    tail_len = has * (tl_m + tl_o + tl_l + 1)
    all_lens = torch.cat([lens, tail_len[:, None]], dim=1)
    all_vals = torch.cat([vals, tail_val[:, None]], dim=1) & M32

    words, total_bits = deposit_bits(all_vals, all_lens, out_bytes_cap // 4)
    stream_bytes = (total_bits + 7) >> 3

    # Section header: nbSeq varint, mode byte, then the LL, OF, ML table
    # descriptions (RLE symbol or NCount header).
    b0 = torch.where(nseq < 128, nseq, torch.where(nseq < 0x7F00, (nseq >> 8) + 0x80, 255))
    b1 = torch.where(nseq < 0x7F00, nseq & 0xFF, (nseq - 0x7F00) & 0xFF)
    b2 = ((nseq - 0x7F00) >> 8) & 0xFF
    nb_len = torch.where(nseq < 128, 1, torch.where(nseq < 0x7F00, 2, 3))
    zero = torch.zeros_like(nseq)
    nbseq_hdr = torch.stack(
        [b0, torch.where(nseq < 128, 0, b1), torch.where(nseq < 0x7F00, 0, b2), zero], dim=1
    ).to(torch.uint8)
    m3 = prep["mode3"].to(torch.int64)
    mode_byte = ((m3[:, 0] << 6) | (m3[:, 1] << 4) | (m3[:, 2] << 2)).to(torch.uint8)
    dlen3 = prep["dlen3"].to(torch.int64)
    d_ll, d_of, d_ml = has * dlen3[:, 0], has * dlen3[:, 1], has * dlen3[:, 2]
    hdr_total = nb_len + has + d_ll + d_of + d_ml

    cap = out_bytes_cap + 8
    out = place(nbseq_hdr, nb_len, 0, cap)
    out = out + place(mode_byte[:, None], has, nb_len, cap)
    out = out + place(prep["desc_ll"], d_ll, nb_len + has, cap)
    out = out + place(prep["desc_of"], d_of, nb_len + has + d_ll, cap)
    out = out + place(prep["desc_ml"], d_ml, nb_len + has + d_ll + d_of, cap)
    out = out + place(words_to_bytes(words), has * stream_bytes, hdr_total, cap)
    if ckpt_every:
        return (out, hdr_total + has * stream_bytes) + ck
    return out, hdr_total + has * stream_bytes


def _checkpoints(prep, pre3, step_bits, nseq, msb: int, C: int):
    """Decoder checkpoints for chunk-parallel decode. At decode step
    j = c * C the decoder's unread-bit cursor is the inclusive prefix of the
    per-step field bits up to encoder step nseq-1-j, and its three FSE states
    are the encoder's pre-transition states at encoder step nseq-j (the
    encoder walks the same state sequence backward); K5's `pre` is defined
    there, since 1 <= nseq-j < nseq. The rep triple is prep["rep_pre"] at
    decode step j."""
    B = pre3.shape[0]
    cum = torch.cumsum(step_bits, 1)
    c_ar = torch.arange(1, msb // C + 1, device=pre3.device)
    t_c = nseq[:, None] - c_ar * C  # encoder step of checkpoint c
    valid = t_c >= 1
    ti = torch.clamp(t_c, 1, msb - 1)
    ck_bits = torch.where(valid, cum.gather(1, ti - 1), 0)
    st = pre3.gather(2, ti[:, None, :].expand(B, 3, ti.shape[1]))
    ck_states = torch.where(valid, st[:, 0] | (st[:, 1] << 10) | (st[:, 2] << 20), 0)
    rep_pre = prep["rep_pre"]
    j = torch.clamp(c_ar * C, 0, rep_pre.shape[1] - 1)
    ck_rep = torch.where(valid[..., None], rep_pre[:, j], 1)
    return ck_bits, ck_states, ck_rep
