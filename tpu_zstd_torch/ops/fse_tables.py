"""Per-block FSE table construction for the sequence streams (RFC 8878 §4.1).

Counterpart of tpu_zstd/ops/fse_tables_jax.py, batched: every function takes
a leading batch dimension (one row per block or stream) where the JAX
package vmaps a per-block function. Each stream of each block picks RLE,
custom FSE tables or the predefined tables by an expected-bit estimate;
custom tables are normalized to a fixed table log of 6 (64 states) with no
-1 entries, and are carried as the closed-form encoder parameters (a shared
64-entry state table plus per-symbol deltaNbBits / deltaFindState).

Histograms are scatter-adds on the live prefix; the reference's stable
`lax.sort` calls become `torch.sort(..., stable=True)` on the same keys, so
ties break the same way. Lookups in tiny tables are integer indexing where
the JAX package uses exact one-hot contractions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import (
    LL_DEFAULT_LOG,
    LL_DEFAULT_NORM,
    ML_DEFAULT_LOG,
    ML_DEFAULT_NORM,
    OF_DEFAULT_LOG,
    OF_DEFAULT_NORM,
    SEQ_FSE,
    SEQ_PREDEFINED,
    SEQ_RLE,
)
from .bitpack import deposit_bits, words_to_bytes

TL = 6                  # fixed custom table log (64 states)
TS = 1 << TL
STEP = (TS >> 1) + (TS >> 3) + 3  # 43, coprime with 64

NSYM_LL = 36
NSYM_OF = 32            # codes up to 31 (offsets < 2^32); predefined covers 29
NSYM_ML = 53

# Static inverse of the spread permutation: SPREAD_INV[p] = rank placed at p.
_pos = (np.arange(TS) * STEP) & (TS - 1)
SPREAD_INV = np.zeros(TS, dtype=np.int32)
SPREAD_INV[_pos] = np.arange(TS, dtype=np.int32)

# Fixed-point log2 (Q8) for values 0..64 (index 0 unused).
LOG2_Q8 = np.round(np.log2(np.maximum(np.arange(TS + 1), 1)) * 256).astype(np.int32)


def _floor_log2(v: torch.Tensor) -> torch.Tensor:
    """floor(log2(v)) for 1 <= v <= 127 (int64)."""
    out = torch.zeros_like(v)
    for shift in (4, 2, 1):
        m = v >= (1 << shift)
        out = out + torch.where(m, shift, 0)
        v = torch.where(m, v >> shift, v)
    return out


def histogram_codes(codes: torch.Tensor, nvalid: torch.Tensor, nsym: int) -> torch.Tensor:
    """(B, nsym) int64 counts of codes[b, :nvalid[b]] for codes (B, M); codes
    outside [0, nsym) are not counted. A scatter-add rather than
    `torch.bincount`, which reads its input's maximum back to the host."""
    B, M = codes.shape
    dev = codes.device
    codes = codes.to(torch.int64)
    pos = torch.arange(M, device=dev)
    live = (pos < nvalid.to(torch.int64)[:, None]) & (codes >= 0) & (codes < nsym)
    row = (torch.arange(B, device=dev) * nsym)[:, None]
    idx = torch.where(live, codes + row, B * nsym).reshape(-1)
    out = torch.zeros(B * nsym + 1, dtype=torch.int64, device=dev)
    out.scatter_add_(0, idx, torch.ones_like(idx))
    return out[: B * nsym].reshape(B, nsym)


def normalize_64(cnt: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
    """Normalize counts (B, nsym) to sum exactly TS per row (present symbols
    >= 1, no -1s): largest remainder with exact repair. Meaningful for rows
    with >= 2 present symbols (callers gate on that; RLE covers one)."""
    cnt = cnt.to(torch.int64)
    B, nsym = cnt.shape
    idx = torch.arange(nsym, device=cnt.device).expand(B, nsym)
    present = cnt > 0
    tot = torch.clamp(total.to(torch.int64), min=1)[:, None]
    num = cnt * TS
    fl = num // tot
    frac = num - fl * tot
    base = torch.where(present, torch.clamp(fl, min=1), 0)
    deficit = TS - base.sum(-1, keepdim=True)

    # deficit > 0: +1 to the `deficit` largest remainders (present first).
    key_add = torch.where(present, -frac, tot + 1)
    order = torch.sort(key_add, dim=-1, stable=True).indices
    rank = torch.empty_like(order).scatter_(1, order, idx.contiguous())
    base_up = base + ((deficit > 0) & present & (rank < deficit)).to(torch.int64)

    # deficit < 0: remove `need` from the largest bases (slack = base - 1).
    need = torch.clamp(-deficit, min=0)
    slack = torch.clamp(base - 1, min=0)
    keys = torch.where(present, -base, 1)
    s_idx = torch.sort(keys, dim=-1, stable=True).indices
    s_slack = slack.gather(1, s_idx)
    cum_ex = torch.cumsum(s_slack, -1) - s_slack
    take_sorted = torch.minimum(torch.clamp(need - cum_ex, min=0), s_slack)
    take = torch.zeros_like(base).scatter_(1, s_idx, take_sorted)
    return torch.where(deficit > 0, base_up, base - take)


def ncount_fields(norm: torch.Tensor):
    """Bit fields of the NCount header for norm (B, nsym) (table log TL, no
    -1s). Returns (vals (B, 1 + 3 nsym) int64 holding u32, lens (B, 1 + 3 nsym),
    total_bytes (B,)); field order matches the reference's host writer."""
    B, nsym = norm.shape
    dev = norm.device
    norm = norm.to(torch.int64)
    idx = torch.arange(nsym, device=dev)
    nz = norm > 0
    last_nz = torch.where(nz, idx, -1).amax(-1, keepdim=True)

    cum_ex = torch.cumsum(norm, -1) - norm
    remaining = TS + 1 - cum_ex
    nbb = torch.clamp(_floor_log2(torch.clamp(remaining, 1, 127)) + 1, max=TL + 1)
    thr = 1 << (nbb - 1)
    max_v = 2 * thr - 1 - remaining
    enc = norm + 1
    enc2 = enc + torch.where(enc >= thr, max_v, 0)
    cwidth = torch.where(enc2 < max_v, nbb - 1, nbb)

    # Zero-run heads: first zero of a run strictly before the last nonzero.
    prev_nz = torch.roll(nz, 1, -1)
    prev_nz[:, 0] = True
    zero_head = ~nz & prev_nz & (idx < last_nz)
    emit_cnt = (nz & (idx <= last_nz)) | zero_head
    cwidth = torch.where(emit_cnt, cwidth, 0)
    cval = torch.where(emit_cnt, enc2, 0) & 0xFFFFFFFF

    # Next nonzero index after s (suffix min of nonzero positions).
    nzpos = torch.where(nz, idx, nsym + 64)
    sufmin = torch.flip(torch.cummin(torch.flip(nzpos, [-1]), -1).values, [-1])
    next_nz = torch.cat([sufmin[:, 1:], torch.full((B, 1), nsym + 64, device=dev)], -1)

    # Repeat descriptor on the head: e extra zeros -> 0xFFFF x (e//24),
    # '3' 2-bit x ((e%24)//3), final 2-bit (e%24)%3. Split into <=2 fields.
    e = torch.where(zero_head, next_nz - idx - 1, 0)
    b16 = e // 24
    rem = e - b16 * 24
    b3 = rem // 3
    r2 = rem - b3 * 3
    ones_run = 16 * b16 + 2 * b3
    tbits = ones_run + 2
    lo_fits = tbits <= 32
    ones_lo = torch.clamp(ones_run, max=30)  # when lo_fits, ones_run <= 30
    lo_val = torch.where(lo_fits, (r2 << ones_lo) | ((1 << ones_lo) - 1), 0xFFFFFFFF)
    lo_len = torch.where(zero_head, torch.clamp(tbits, max=32), 0)
    ones_hi = torch.clamp(ones_run - 32, 0, 16)
    hi_val = (r2 << ones_hi) | ((1 << ones_hi) - 1)
    hi_len = torch.where(zero_head & ~lo_fits, tbits - 32, 0)

    vals = torch.stack([cval, lo_val, hi_val], -1).reshape(B, -1)
    lens = torch.stack([cwidth, lo_len, hi_len], -1).reshape(B, -1)
    vals = torch.cat([torch.full((B, 1), TL - 5, device=dev), vals], -1)  # accuracy_log - 5
    lens = torch.cat([torch.full((B, 1), 4, device=dev), lens], -1)
    total_bytes = (lens.sum(-1) + 7) // 8
    return vals, lens, total_bytes


def build_cf_tables(norm: torch.Tensor):
    """Closed-form encode-table parameters from normalized counts (B, nsym).

    The FSE encoder transition is fully determined by two per-symbol scalars
    and one shared ts-entry table (libzstd's symbolTT closed forms):

        value  = ts + state
        nb     = (value + dnb[sym]) >> 16
        state' = state_table[(value >> nb) + dfs[sym]] - ts

    Returns (state_table (B, TS) values in [TS, 2 TS), dnb (B, nsym),
    dfs (B, nsym), init (B, nsym) states in [0, TS)), int64.
    """
    norm = norm.to(torch.int64)
    dev = norm.device
    cum = torch.cumsum(norm, -1)
    ranks = torch.arange(TS, device=dev)
    sym_of_rank = (ranks[None, :, None] >= cum[:, None, :]).sum(-1)
    sym_state = sym_of_rank[:, torch.as_tensor(SPREAD_INV, dtype=torch.int64, device=dev)]
    st_u = torch.sort(sym_state, dim=-1, stable=True).indices
    state_table = TS + st_u

    cum_ex = cum - norm
    mbo = TL - _floor_log2(torch.clamp(norm - 1, min=1))
    dnb = torch.where(norm > 0, (mbo << 16) - (norm << mbo), ((TL + 1) << 16) - TS)
    dfs = torch.where(norm > 0, cum_ex - norm, 0)

    nb0 = (dnb + (1 << 15)) >> 16
    v0 = (nb0 << 16) - dnb
    i0 = torch.clamp((v0 >> nb0) + dfs, 0, TS - 1)
    init = state_table.gather(1, i0) - TS
    return state_table, dnb, dfs, init


# --- Predefined tables padded to the custom alphabet shapes ------------------------


def _pad_pred(et_next: np.ndarray, et_nb: np.ndarray, et_init: np.ndarray, nsym: int):
    s, ts = et_next.shape
    nxt = np.zeros((nsym, TS), dtype=np.int32)
    nb = np.zeros((nsym, TS), dtype=np.int32)
    init = np.zeros(nsym, dtype=np.int32)
    nxt[:s, :ts] = et_next
    nb[:s, :ts] = et_nb
    init[:s] = et_init
    return nxt, nb, init


def _pred_cost_q8(norm: np.ndarray, table_log: int, nsym: int) -> np.ndarray:
    """Per-symbol expected FSE bit cost (Q8) under a predefined table; symbols
    outside the table get a poison cost (predefined invalid there)."""
    cost = np.full(nsym, 1 << 20, dtype=np.int32)
    eff = np.where(norm == -1, 1, norm).astype(np.int64)
    for s in range(len(norm)):
        if eff[s] > 0:
            cost[s] = table_log * 256 - int(round(np.log2(eff[s]) * 256))
    return cost


class StreamSpec:
    """Static per-stream data: alphabet size + padded predefined tables."""

    def __init__(self, nsym: int, pred_norm: np.ndarray, pred_log: int, enc):
        self.nsym = nsym
        self.pred_log = pred_log
        self.pred_next, self.pred_nb, self.pred_init = _pad_pred(
            enc.next2d, enc.nb2d, enc.init_state, nsym
        )
        # Closed-form predefined params padded to (nsym,) / (TS,).
        self.pred_dnb = np.zeros(nsym, dtype=np.int32)
        self.pred_dnb[: len(enc.dnb)] = enc.dnb
        self.pred_dfs = np.zeros(nsym, dtype=np.int32)
        self.pred_dfs[: len(enc.dfs)] = enc.dfs
        ts = enc.table_size
        self.pred_st = np.full(TS, ts, dtype=np.int32)
        self.pred_st[:ts] = enc.state_table
        self.pred_cost_q8 = _pred_cost_q8(pred_norm, pred_log, nsym)
        self.pred_valid_mask = np.zeros(nsym, dtype=bool)
        self.pred_valid_mask[: len(pred_norm)] = np.asarray(pred_norm) != 0


@functools.lru_cache(maxsize=None)
def stream_specs() -> tuple[StreamSpec, StreamSpec, StreamSpec]:
    """(LL, OF, ML) stream specs."""
    from .fse import predefined_enc_tables

    tl, to, tm = predefined_enc_tables()
    return (
        StreamSpec(NSYM_LL, LL_DEFAULT_NORM, LL_DEFAULT_LOG, tl),
        StreamSpec(NSYM_OF, OF_DEFAULT_NORM, OF_DEFAULT_LOG, to),
        StreamSpec(NSYM_ML, ML_DEFAULT_NORM, ML_DEFAULT_LOG, tm),
    )


@functools.lru_cache(maxsize=None)
def _spec_tensors(spec: StreamSpec, device: torch.device) -> dict:
    """A spec's tables as int64 tensors on `device`, copied there once."""
    names = ("pred_st", "pred_dnb", "pred_dfs", "pred_init", "pred_cost_q8", "pred_valid_mask")
    out = {k: torch.as_tensor(getattr(spec, k).astype(np.int64), device=device) for k in names}
    out["pred_valid_mask"] = out["pred_valid_mask"] != 0
    out["log2_q8"] = torch.as_tensor(LOG2_Q8.astype(np.int64), device=device)
    return out


def choose_stream_tables(codes: torch.Tensor, nvalid: torch.Tensor, spec: StreamSpec) -> dict:
    """Pick RLE / custom FSE / predefined for one stream of each block and
    build its tables.

    codes (B, M) (the first nvalid[b] valid). Returns a dict of per-block
    tensors: mode, table_log (B,), st (B, TS), dnb / dfs / init (B, nsym)
    (closed-form params, see build_cf_tables), desc (B, desc_cap(nsym))
    uint8 (the RLE symbol or the NCount header) and desc_len (B,).
    """
    nsym = spec.nsym
    dev = codes.device
    t = _spec_tensors(spec, dev)
    nvalid = nvalid.to(torch.int64)
    cnt = histogram_codes(codes, nvalid, nsym)
    npresent = (cnt > 0).sum(-1)
    norm = normalize_64(cnt, nvalid)
    nc_vals, nc_lens, nc_bytes = ncount_fields(norm)

    # Expected-bit estimates (Q8 fixed point).
    log2_norm = t["log2_q8"][torch.clamp(norm, 0, TS)]
    est_custom = (cnt * (TL * 256 - log2_norm)).sum(-1) // 256 + nc_bytes * 8
    est_pred = (cnt * t["pred_cost_q8"]).sum(-1) // 256
    pred_ok = torch.where(t["pred_valid_mask"], 0, cnt).sum(-1) == 0

    use_rle = npresent <= 1
    use_custom = ~use_rle & (~pred_ok | (est_custom < est_pred))

    cus_st, cus_dnb, cus_dfs, cus_init = build_cf_tables(norm)

    mode = torch.where(use_rle, SEQ_RLE, torch.where(use_custom, SEQ_FSE, SEQ_PREDEFINED))
    table_log = torch.where(use_rle, 0, torch.where(use_custom, TL, spec.pred_log))

    r, c = use_rle[:, None], use_custom[:, None]

    def sel3(cus, pred):
        return torch.where(r, 0, torch.where(c, cus, pred))

    # Description bytes: RLE -> 1 byte (the symbol); custom -> NCount header.
    cap = desc_cap(nsym)
    nc_bytes_arr = words_to_bytes(deposit_bits(nc_vals, nc_lens, cap // 4)[0])
    pos = torch.arange(codes.shape[1], device=dev)
    rle_sym = torch.where(pos < nvalid[:, None], codes.to(torch.int64), 0).amax(-1)
    rle_desc = torch.zeros_like(nc_bytes_arr)
    rle_desc[:, 0] = (rle_sym & 0xFF).to(torch.uint8)
    desc = torch.where(r, rle_desc, torch.where(c, nc_bytes_arr, torch.zeros_like(nc_bytes_arr)))
    desc_len = torch.where(use_rle, 1, torch.where(use_custom, nc_bytes, 0))
    return {
        "mode": mode,
        "table_log": table_log,
        "st": sel3(cus_st, t["pred_st"]),
        "dnb": sel3(cus_dnb, t["pred_dnb"]),
        "dfs": sel3(cus_dfs, t["pred_dfs"]),
        "init": sel3(cus_init, t["pred_init"]),
        "desc": desc,
        "desc_len": desc_len,
    }


def desc_cap(nsym: int) -> int:
    """Static byte capacity of one stream's table description."""
    # 4 + nsym * (7 + 34 + 16) bits, rounded up to a multiple of 4 bytes.
    bits = 4 + nsym * 57
    return -(-bits // 32) * 4
