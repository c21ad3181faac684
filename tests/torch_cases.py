"""Seeded comparison cases between the PyTorch port and the JAX package.

Each case builds its inputs from a seed with numpy, runs the port's function
on CPU tensors (`port`) and the JAX package's counterpart (`ref`, which
imports JAX inside itself, so a caller that only runs `port` never imports
JAX), and reduces either output to the same digest: small integer arrays as
lists, long arrays as shape plus sha256 of their int64 values, byte strings
as length plus sha256. Integer outputs, exact equality.

- tests/test_torch_golden_cases.py holds `port` against the recorded digests
  in tests/golden/torch_cases.json, without JAX;
- tools/make_torch_goldens.py writes that file from `ref`;
- the live test files (tests/test_torch_*.py) hold the file against `ref`
  again with `check_live`, so it cannot go stale.

State chains are compared on their live range only (1 <= t < nseq, and the
flush state): outside it the port and the JAX package leave different values
that every caller masks.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import pathlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from tpu_zstd_torch.corpus import make_corpus

GOLDEN = pathlib.Path(__file__).resolve().parent / "golden" / "torch_cases.json"


@dataclass(frozen=True)
class Case:
    inputs: Callable[[], dict]
    port: Callable[[dict], dict]
    ref: Callable[[dict], dict]
    group: str  # which live test file re-checks it against the JAX package


CASES: dict[str, Case] = {}


def case(name: str, group: str, inputs, port, ref) -> None:
    CASES[name] = Case(inputs, port, ref, group)


def digest(out: dict) -> dict:
    res = {}
    for k, v in sorted(out.items()):
        if isinstance(v, (bytes, bytearray)):
            res[k] = {"len": len(v), "sha256": hashlib.sha256(v).hexdigest()}
            continue
        a = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v).astype(np.int64)
        if a.size <= 64:
            res[k] = a.tolist()
        else:
            res[k] = {"shape": list(a.shape),
                      "sha256": hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()}
    return res


def run_port(name: str) -> dict:
    c = CASES[name]
    return digest(c.port(c.inputs()))


def run_ref(name: str) -> dict:
    c = CASES[name]
    return digest(c.ref(c.inputs()))


def load_golden() -> dict:
    return json.loads(GOLDEN.read_text())["cases"]


def check_live(group: str) -> None:
    """For every case of `group`: the recorded digest equals the JAX
    package's live output, and the port's output equals both."""
    golden = load_golden()
    names = [n for n, c in CASES.items() if c.group == group]
    assert names, group
    for name in names:
        ref = run_ref(name)
        assert ref == golden[name], f"{name}: golden is stale against the JAX package"
        assert run_port(name) == ref, f"{name}: the port differs from the JAX package"


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# --- Slice 1: kernels K1-K4, bit deposit, parse, predefined encode, frames --------


def _roll_inputs(dtype, width):
    def make():
        rng = np.random.default_rng(width)
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, (5, width), dtype=dtype, endpoint=True)
        s = rng.integers(0, width + 1, 5)
        s[0] = 0
        return {"x": x, "s": s}

    return make


def _roll_port(i):
    from tpu_zstd_torch.ops import roll

    return {"out": roll.roll_rows_plain(_t(i["x"]), _t(i["s"]))}


def _roll_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops import bitpack

    W = i["x"].shape[1]
    return {"out": bitpack.dynroll(jnp.asarray(i["x"]), jnp.asarray(i["s"][:, None], jnp.int32), W)}


case("roll_u8", "kernels", _roll_inputs(np.uint8, 4096), _roll_port, _roll_ref)
case("roll_i32", "kernels", _roll_inputs(np.int32, 2048), _roll_port, _roll_ref)


def roll_hard_shifts(rng, rows: int, width: int) -> np.ndarray:
    """Per-row shifts for K1: 0, W, -1, 3W, -3W, W - 1, 1, -W - 5 and
    2^40 + 7 first, then shifts drawn from [-3W, 3W]."""
    s = rng.integers(-3 * width, 3 * width + 1, rows)
    fixed = [0, width, -1, 3 * width, -3 * width, width - 1, 1, -width - 5, (1 << 40) + 7]
    s[: min(rows, len(fixed))] = fixed[:rows]
    return s.astype(np.int64)


def roll_hard_rows(seed: int, dtype, rows: int, width: int):
    """(x, shift) for K1: rows of `dtype` (int64 rows carry u32 values, as
    the deposit trees' word rows do), shifts from `roll_hard_shifts`."""
    rng = np.random.default_rng(seed)
    if np.dtype(dtype) == np.int64:
        x = rng.integers(0, 1 << 32, (rows, width), dtype=np.int64)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, (rows, width), dtype=dtype, endpoint=True)
    return x, roll_hard_shifts(rng, rows, width)


# K1's hard shapes: int64 word rows as narrow as the deposit trees' (2, 3,
# 11) and as wide (16384); byte rows whose width is no multiple of 16 (the
# pipeline's literal rows) or is one; int32 rows of odd width.
ROLL_HARD = ((np.int64, 37, 2), (np.int64, 29, 3), (np.int64, 23, 11), (np.int64, 3, 16384),
             (np.uint8, 3, 110600), (np.uint8, 11, 160), (np.uint8, 9, 1), (np.uint8, 13, 21),
             (np.int32, 7, 1001))


def _roll_hard_inputs():
    return {f"x{k}": v for k, (dt, r, w) in enumerate(ROLL_HARD)
            for v in [roll_hard_rows(k, dt, r, w)]}


def _roll_hard_port(i):
    from tpu_zstd_torch.ops import roll

    return {k: roll.roll_rows_plain(_t(x), _t(s)) for k, (x, s) in i.items()}


def _roll_hard_ref(i):
    """The JAX roll takes shifts in [0, W]: it gets each shift mod W and the
    int64 rows as the u32 words they carry."""
    import jax.numpy as jnp

    from tpu_zstd.ops import bitpack

    res = {}
    for k, (x, s) in i.items():
        W = x.shape[1]
        xj = x.astype(np.uint32) if x.dtype == np.int64 else x
        res[k] = np.asarray(bitpack.dynroll(jnp.asarray(xj), jnp.asarray((s % W)[:, None],
                                                                         jnp.int32), W))
    return res


case("roll_hard", "kernels", _roll_hard_inputs, _roll_hard_port, _roll_hard_ref)


def _concat_inputs():
    rng = np.random.default_rng(384)
    B, NW, W = 2, 4, 256
    off = rng.integers(0, W, (B, NW)).astype(np.int32)
    cnt = rng.integers(0, W - off + 1).astype(np.int32)
    cnt[0] = W - off[0]  # a full-width segment row
    return {"x": rng.integers(0, 1 << 30, (B, NW, W), dtype=np.int32), "off": off, "cnt": cnt,
            "out_len": 384}


def _concat_port(i):
    from tpu_zstd_torch.ops import concat

    return {"out": concat.concat_varlen_plain(_t(i["x"]), _t(i["off"]), _t(i["cnt"]),
                                              int(i["out_len"]))}


def _concat_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops.pallas_concat import concat_varlen

    n = int(i["out_len"])
    return {"out": jax.vmap(lambda a, o, c: concat_varlen(a, o, c, n))(
        jnp.asarray(i["x"]), jnp.asarray(i["off"]), jnp.asarray(i["cnt"]))}


case("concat", "kernels", _concat_inputs, _concat_port, _concat_ref)


def concat_fused_hard(seed: int = 385, B: int = 3, NW: int = 8, W: int = 256,
                      lit_len: int = 1024, seq_len: int = 384) -> dict:
    """Hard operands for K2's fused entry (`concat.concat_fused`), laid out as
    the parse hands them: per window `nseq` sequence rows, then `nlit`
    literal rows, of an int64 `pk` (B, NW, W) and `key`. Row 0 has full
    windows (nseq + nlit = W) whose literals pass `lit_len` and whose
    sequences pass `seq_len`; row 1 has windows without sequences, without
    literals or empty; the rest are seeded. Rows 0 and 2 give nseq every
    residue mod 16 (the source offsets of the literal segments). pk holds values at
    and past 2^31 and 2^32, negative ones and ml << 21 | off with ml up to
    4095; key holds positions and negative values."""
    rng = np.random.default_rng(seed)
    SC = W // 2
    nseq = rng.integers(0, SC + 1, (B, NW))
    nseq[0] = SC - 16 + np.arange(NW) % 16  # residues 0 .. NW - 1
    nseq[1, ::2] = 0
    if B > 2:  # the other residues
        nseq[2] = (NW + np.arange(NW)) % 16 + 16 * rng.integers(0, SC // 16, NW)
    nlit = rng.integers(0, W - nseq + 1)
    nlit[0] = W - nseq[0]
    nlit[1, 1::4] = 0
    nlit[1, 2] = 0
    ml = rng.integers(0, 4096, (B, NW, W))
    pk = (ml << 21) | rng.integers(0, 1 << 21, (B, NW, W))
    pk = np.where(rng.random((B, NW, W)) < 0.2, rng.integers(-2**40, 2**40, (B, NW, W)), pk)
    special = np.array([2**31, 2**31 - 1, -1, -2**31, 2**32 + 5, -2**40 - 3, 255, 256])
    pk.reshape(-1)[rng.choice(B * NW * W, 64, replace=False)] = rng.choice(special, 64)
    key = np.where(rng.random((B, NW, W)) < 0.9, rng.integers(0, W, (B, NW, W)),
                   rng.integers(-2**33, 2**33, (B, NW, W)))
    return {"pk": pk.astype(np.int64), "key": key.astype(np.int64),
            "nseq": nseq.astype(np.int64), "nlit": nlit.astype(np.int64),
            "SC": SC, "shift": W.bit_length() - 1, "lit_len": lit_len, "seq_len": seq_len}


def concat_fused_operands(i: dict, t=None) -> list:
    """The operands of `concat_fused` for `concat_fused_hard` inputs, as the
    parse builds them (literal bytes, starts with the window base, pk), and a
    fourth in int32 (source, counts, output) with literal offsets."""
    from tpu_zstd_torch.ops.concat import Operand

    t = t or _t
    pk, key, nseq, nlit = (t(i[k]) for k in ("pk", "key", "nseq", "nlit"))
    SC = i["SC"]
    return [
        Operand(pk, nseq, nlit, i["lit_len"], torch.uint8),
        Operand(key[..., :SC], None, nseq, i["seq_len"], torch.int64, win_shift=i["shift"]),
        Operand(pk[..., :SC], None, nseq, i["seq_len"], torch.int64),
        Operand(pk.to(torch.int32), nseq.to(torch.int32), nlit.to(torch.int32), i["lit_len"],
                torch.int32),
    ]


def _concat_fused_port(i):
    from tpu_zstd_torch.ops import concat

    return {f"out{k}": o for k, o in enumerate(concat.concat_fused(concat_fused_operands(i)))}


def _concat_fused_ref(i):
    """JAX's int32 concat_varlen on each operand after the casts of the
    parse's former chain (the literals `& 0xFF`), then the output casts."""
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops.pallas_concat import concat_varlen

    def jcat(x, off, cnt, n):
        return np.asarray(jax.vmap(lambda a, o, c: concat_varlen(a, o, c, n))(
            jnp.asarray(x.astype(np.int32)), jnp.asarray(off.astype(np.int32)),
            jnp.asarray(cnt.astype(np.int32))))

    pk, key, nseq, nlit, SC = i["pk"], i["key"], i["nseq"], i["nlit"], i["SC"]
    zero = np.zeros_like(nseq)
    starts = key[..., :SC] + (np.arange(key.shape[1]) << i["shift"])[:, None]
    return {"out0": jcat(pk & 0xFF, nseq, nlit, i["lit_len"]).astype(np.uint8),
            "out1": jcat(starts, zero, nseq, i["seq_len"]).astype(np.int64),
            "out2": jcat(pk[..., :SC], zero, nseq, i["seq_len"]).astype(np.int64),
            "out3": jcat(pk, nseq, nlit, i["lit_len"])}


case("concat_fused", "kernels", concat_fused_hard, _concat_fused_port, _concat_fused_ref)


def _greedy_inputs():
    rng = np.random.default_rng(1024)
    seg, nseg = 1024, 3
    N = seg * nseg
    step = np.minimum(rng.integers(1, 40, N), seg - np.arange(N) % seg).astype(np.int32)
    matched = (rng.random(N) < 0.4) & (step >= 4)
    defer = (rng.random(N) < 0.1) & matched
    return {"step": step, "matched": matched, "defer": defer, "seg": seg}


def _greedy_port(i):
    from tpu_zstd_torch.ops import greedy

    seg = int(i["seg"])
    packed = (i["step"] | i["matched"].astype(np.int32) << 11
              | i["defer"].astype(np.int32) << 12).reshape(-1, seg)
    out = greedy.greedy_segments_plain(_t(packed)).reshape(-1)
    return {"seq": (out & 1) == 1, "lit": (out & 2) == 2}


def _greedy_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops.lz77_jax import greedy_parse

    seq, lit = greedy_parse(jnp.asarray(i["step"]), jnp.asarray(i["matched"]),
                            jnp.asarray(i["defer"]), seg=int(i["seg"]))
    return {"seq": seq, "lit": lit}


case("greedy", "kernels", _greedy_inputs, _greedy_port, _greedy_ref)


def greedy_hard_segments(seed: int, nseg: int, seg: int):
    """(step, matched, defer) of nseg segments (nseg, seg) that are hard for
    K3, in a cycle of eight patterns: one match covering the whole segment
    (step = seg - p everywhere); every position matched with steps of 4 up to
    the segment's end; all literals; defer on every match; every position
    matched with step 4 (walks started a position apart never meet); step 7
    with defer on every third; random (40 % matched, 10 % deferred); and
    matches running exactly to the segment's end near it."""
    rng = np.random.default_rng(seed)
    p = np.arange(seg)
    rest = seg - p  # the longest step that stays in the segment
    step = np.ones((nseg, seg), np.int64)
    matched = np.zeros((nseg, seg), bool)
    defer = np.zeros((nseg, seg), bool)
    for k in range(nseg):
        kind = k % 8
        if kind == 0:
            step[k], matched[k] = rest, True
        elif kind == 1:
            step[k] = np.minimum(rng.integers(4, seg + 1, seg), rest)
            matched[k] = True
        elif kind == 3:
            step[k] = np.minimum(rng.integers(1, 40, seg), rest)
            matched[k] = rng.random(seg) < 0.4
            defer[k] = matched[k]
        elif kind == 4:
            step[k], matched[k] = np.minimum(4, rest), True
        elif kind == 5:
            step[k], matched[k], defer[k] = np.minimum(7, rest), True, p % 3 == 0
        elif kind == 6:
            step[k] = np.minimum(rng.integers(1, 40, seg), rest)
            matched[k] = (rng.random(seg) < 0.4) & (step[k] >= 4)
            defer[k] = (rng.random(seg) < 0.1) & matched[k]
        elif kind == 7:
            step[k] = np.where(p >= seg - 50, rest, np.minimum(rng.integers(1, 40, seg), rest))
            matched[k] = rng.random(seg) < 0.5
    return step.astype(np.int32), matched, defer


def greedy_hard_packed(seed: int, nseg: int, seg: int) -> np.ndarray:
    """greedy_hard_segments packed as K3 reads them: (nseg, seg) int32."""
    step, matched, defer = greedy_hard_segments(seed, nseg, seg)
    return (step | matched.astype(np.int32) << 11 | defer.astype(np.int32) << 12).astype(np.int32)


def _greedy_hard_inputs():
    seg, nseg = 1024, 45  # no multiple of K3's 32 segments a CTA
    step, matched, defer = greedy_hard_segments(21, nseg, seg)
    return {"step": step.reshape(-1), "matched": matched.reshape(-1),
            "defer": defer.reshape(-1), "seg": seg}


case("greedy_hard", "kernels", _greedy_hard_inputs, _greedy_port, _greedy_ref)


def _rep_inputs():
    rng = np.random.default_rng(11)
    S, rows = 3, 600
    offs = np.where(rng.random((S, rows)) < 0.6, rng.integers(1, 5, (S, rows)),
                    rng.integers(1, 1 << 21, (S, rows)))
    has_lit = rng.integers(0, 2, (S, rows))
    valid = np.arange(rows)[None, :] < np.array([rows, 0, 377])[:, None]
    return {"packed": np.where(valid, offs | has_lit << 21 | 1 << 22, 0).astype(np.int32)}


def _rep_port(i):
    from tpu_zstd_torch.ops import rep

    return {"ob": rep.rep_codes_plain(_t(i["packed"]))}


def _rep_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops.pallas_rep import rep_codes_scan

    return {"ob": np.stack([np.asarray(rep_codes_scan(jnp.asarray(p))) for p in i["packed"]])}


case("rep", "kernels", _rep_inputs, _rep_port, _rep_ref)


def rep_hard_rows(seed: int, rows: int) -> np.ndarray:
    """Packed rows (6, rows) that are hard for K4's chunked walk: small
    offsets repeating across chunk boundaries; the whole block alternating
    between two offsets (the history keeps an old third entry, so a re-walked
    chunk never meets its speculative state); ll == 0 rows whose offset is
    v0 - 1 (repcode 3); invalid rows with garbage bits scattered between
    valid ones; no valid row (nseq 0); valid rows up to a count that is no
    multiple of any chunk."""
    rng = np.random.default_rng(seed)
    t = np.arange(rows)
    valid = 1 << 22
    cross = rng.choice([3, 5, 8, 13], rows, p=[0.4, 0.3, 0.2, 0.1]) | rng.integers(0, 2, rows) << 21
    alternate = np.where(t % 2 == 0, 7, 9) | 1 << 21
    alternate[0] = 5 | 1 << 21
    off = rng.integers(2, 40, rows)
    dec = rng.random(rows) < 0.4
    for i in range(1, rows):  # ll == 0 rows copying the last offset minus one
        if dec[i] and off[i - 1] > 1:
            off[i] = off[i - 1] - 1
    ll0 = off | np.where(dec, 0, rng.integers(0, 2, rows)) << 21
    garbage = rng.integers(0, 1 << 22, rows)
    mixed = rng.integers(1, 6, rows) | rng.integers(0, 2, rows) << 21
    scattered = np.where(rng.random(rows) < 0.4, garbage, mixed | valid)
    prefix = np.where(t < rows - rows // 3 - 5, mixed | valid, 0)
    return np.stack([cross | valid, alternate | valid, ll0 | valid, scattered, garbage,
                     prefix]).astype(np.int32)


def _rep_hard_inputs():
    return {"packed": rep_hard_rows(13, 2100)}


case("rep_hard", "kernels", _rep_hard_inputs, _rep_port, _rep_ref)


def _deposit_inputs(M):
    def make():
        rng = np.random.default_rng(M)
        vals = rng.integers(0, 1 << 32, (2, M), dtype=np.uint64).astype(np.int64)
        lens = rng.integers(0, 33, (2, M)).astype(np.int32)
        lens[:, ::7] = 0
        # Three words short: the scatter drops the last fields, the tree wraps them.
        return {"vals": vals, "lens": lens, "num_words": int(lens.sum(1).max()) // 32 - 3}

    return make


def _deposit_port(i):
    from tpu_zstd_torch.ops import bitpack

    words, total = bitpack.deposit_bits(_t(i["vals"]), _t(i["lens"]), int(i["num_words"]))
    return {"words": words, "total": total}


def _deposit_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import bitpack

    dep = jax.jit(bitpack.deposit_bits, static_argnums=(2,))
    out = [dep(jnp.asarray(v.astype(np.uint32)), jnp.asarray(l), int(i["num_words"]))
           for v, l in zip(i["vals"], i["lens"])]
    return {"words": np.stack([np.asarray(w) for w, _ in out]),
            "total": np.array([int(t) for _, t in out])}


case("deposit_scatter", "kernels", _deposit_inputs(300), _deposit_port, _deposit_ref)
case("deposit_tree", "kernels", _deposit_inputs(5000), _deposit_port, _deposit_ref)

PARSE_N = 8192
PARSE_KW = dict(max_seqs=PARSE_N // 4, hash_log=13, depth=8, cap=8, min_match=4, lazy=True,
                seg_log=10, of_gate=(8, 12), mf_win_log=12)


def _parse_inputs():
    rng = np.random.default_rng(0x5EED)
    N = PARSE_N
    mix = rng.integers(0, 256, N, dtype=np.uint8)
    for _ in range(60):
        src, dst, ln = rng.integers(0, N - 300), rng.integers(0, N - 300), rng.integers(4, 300)
        mix[dst:dst + ln] = mix[src:src + ln]
    datas = [make_corpus(N), make_corpus(3 * N)[2 * N:], mix.tobytes(),
             rng.integers(0, 8, N, dtype=np.uint8).tobytes(), b"abcd" * 5]
    blocks = np.zeros((len(datas), N), np.uint8)
    lengths = np.zeros(len(datas), np.int32)
    for k, d in enumerate(datas):
        blocks[k, : len(d)] = np.frombuffer(d, np.uint8)
        lengths[k] = len(d)
    return {"blocks": blocks, "lengths": lengths}


def _parse_digest(seqs):
    nseq = np.asarray(seqs.nseq).astype(np.int64)
    nlit = np.asarray(seqs.nlit).astype(np.int64)
    pos = np.arange(PARSE_N)
    out = {"nseq": nseq, "nlit": nlit,
           "lits": np.where(pos < nlit[:, None], np.asarray(seqs.lits), 0)}
    for f in ("ll", "ml", "ob", "off", "starts"):
        a = np.asarray(getattr(seqs, f))
        out[f] = np.where(np.arange(a.shape[1]) < nseq[:, None], a, 0)
    return out


def _parse_port(i):
    from tpu_zstd_torch.ops import lz77

    return _parse_digest(lz77.parse_block(_t(i["blocks"]), _t(i["lengths"]), **PARSE_KW))


def _parse_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import lz77_jax

    seqs = jax.jit(jax.vmap(lambda b, n: lz77_jax.parse_block(b, n, **PARSE_KW)))(
        jnp.asarray(i["blocks"]), jnp.asarray(i["lengths"]))
    return _parse_digest(jax.device_get(seqs))


case("parse_8k", "parse", _parse_inputs, _parse_port, _parse_ref)


def _random_sequences(rng, B, ms, nseq):
    """Sequences with literal/match lengths and offsets across every code
    range, including repcode offset-base values 1..3."""
    ll = np.where(rng.random((B, ms)) < 0.9, rng.integers(0, 40, (B, ms)),
                  rng.integers(0, 70000, (B, ms)))
    ml = np.where(rng.random((B, ms)) < 0.9, rng.integers(4, 40, (B, ms)),
                  rng.integers(4, 70000, (B, ms)))
    ob = np.where(rng.random((B, ms)) < 0.3, rng.integers(1, 4, (B, ms)),
                  rng.integers(4, (1 << 21) + 3, (B, ms)))
    live = np.arange(ms)[None, :] < nseq[:, None]
    return [np.where(live, a, 0).astype(np.int32) for a in (ll, ml, ob)]


def _seq_cap(ms):
    return -(-((ms * 40) // 8 + 1024) // 4096) * 4096


def _predef_inputs():
    rng = np.random.default_rng(2048)
    ms = 2048
    nseq = np.array([2048, 0, 1, 127, 128, 1500])
    ll, ml, ob = _random_sequences(rng, len(nseq), ms, nseq)
    return {"ll": ll, "ml": ml, "ob": ob, "nseq": nseq, "ms": ms}


def _predef_port(i):
    from tpu_zstd_torch.ops import fse

    ms = int(i["ms"])
    out, n = fse.encode_sequences_predefined(_t(i["ll"]), _t(i["ml"]), _t(i["ob"]),
                                             _t(i["nseq"]), ms, _seq_cap(ms))
    return {"out": out, "len": n}


def _predef_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import fse_jax

    ms = int(i["ms"])
    enc = jax.jit(jax.vmap(
        lambda a, b, c, n: fse_jax.encode_sequences_predefined(a, b, c, n, ms, _seq_cap(ms))))
    out, n = enc(jnp.asarray(i["ll"]), jnp.asarray(i["ml"]), jnp.asarray(i["ob"]),
                 jnp.asarray(i["nseq"], jnp.int32))
    return {"out": out, "len": n}


case("encode_predefined", "fse", _predef_inputs, _predef_port, _predef_ref)


# Frames: the pipeline configuration as a dict of PipelineConfig fields,
# identical in both packages.
def _cfg(bs, **kw):
    return {"block_size": bs, "hash_log": 13, "mf_win_log": 12, **kw}


def _mix(seed, n):
    """Text, random bytes, a run of one byte and repeats: every block type."""
    rng = np.random.default_rng(seed)
    parts = [make_corpus(n // 2), rng.integers(0, 256, n // 4, dtype=np.uint8).tobytes(),
             b"\x42" * (n // 8)]
    data = b"".join(parts)
    return data + data[: n - len(data)]


def _frame_inputs(cfg, data_fn, checksum=False):
    def make():
        return {"cfg": cfg, "data": data_fn(), "checksum": checksum}

    return make


def _frame_port(i):
    from tpu_zstd_torch.ops import pipeline

    cfg = pipeline.PipelineConfig(**i["cfg"])
    return {"frame": pipeline.compress(i["data"], cfg, checksum=i["checksum"], device="cpu")}


def _frame_ref(i):
    from tpu_zstd.ops import pipeline

    kw = dict(i["cfg"])
    cfg = pipeline.PipelineConfig(**kw)
    return {"frame": pipeline.compress(i["data"], cfg, checksum=i["checksum"])}


_SLICE1 = dict(huffman_literals=False, custom_fse=False)
case("frame_slice1_8k", "pipeline",
     _frame_inputs(_cfg(8192, **_SLICE1), lambda: make_corpus(2 * 8192)), _frame_port, _frame_ref)
case("frame_slice1_16k", "pipeline",
     _frame_inputs(_cfg(16384, **_SLICE1), lambda: _mix(1, 2 * 16384)), _frame_port, _frame_ref)


# --- Slice 2: custom FSE tables, state chains, Huffman literals, checksums ----------


def _counts_inputs():
    """Counts over the LL alphabet (36): skewed, flat, two symbols, sparse with
    long zero runs, and counts forcing both repair directions."""
    rng = np.random.default_rng(36)
    rows = [rng.geometric(0.2, 3000).clip(0, 35), rng.integers(0, 36, 500),
            np.array([0, 35] * 40), np.array([1] * 500 + [30] * 3 + [31] * 2),
            np.array(list(range(36)) + [0] * 2000), np.array([5] * 63 + [6])]
    cnt = np.stack([np.bincount(r, minlength=36) for r in rows]).astype(np.int32)
    return {"cnt": cnt, "total": cnt.sum(1).astype(np.int32)}


def _norm_port(i):
    from tpu_zstd_torch.ops import fse_tables

    return {"norm": fse_tables.normalize_64(_t(i["cnt"]), _t(i["total"]))}


def _norm_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import fse_tables_jax

    return {"norm": jax.vmap(fse_tables_jax.normalize_64)(jnp.asarray(i["cnt"]),
                                                          jnp.asarray(i["total"]))}


case("normalize_64", "fse_custom", _counts_inputs, _norm_port, _norm_ref)


def _norm_inputs():
    """The normalized counts of _counts_inputs (normalize_64 is its own case)."""
    from tpu_zstd_torch.ops import fse_tables

    i = _counts_inputs()
    return {"norm": fse_tables.normalize_64(_t(i["cnt"]), _t(i["total"])).numpy()}


def _ncount_port(i):
    from tpu_zstd_torch.ops import fse_tables

    vals, lens, nbytes = fse_tables.ncount_fields(_t(i["norm"]))
    return {"vals": vals, "lens": lens, "bytes": nbytes}


def _ncount_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import fse_tables_jax

    vals, lens, nbytes = jax.vmap(fse_tables_jax.ncount_fields)(jnp.asarray(i["norm"], jnp.int32))
    return {"vals": vals, "lens": lens, "bytes": nbytes}


def _cf_port(i):
    from tpu_zstd_torch.ops import fse_tables

    st, dnb, dfs, init = fse_tables.build_cf_tables(_t(i["norm"]))
    return {"st": st, "dnb": dnb, "dfs": dfs, "init": init}


def _cf_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import fse_tables_jax

    st, dnb, dfs, init = jax.vmap(fse_tables_jax.build_cf_tables)(jnp.asarray(i["norm"], jnp.int32))
    return {"st": st, "dnb": dnb, "dfs": dfs, "init": init}


case("ncount_fields", "fse_custom", _norm_inputs, _ncount_port, _ncount_ref)
case("build_cf_tables", "fse_custom", _norm_inputs, _cf_port, _cf_ref)


_STREAMS = {"ll": (0, 36), "of": (1, 32), "ml": (2, 53)}


def _codes_inputs(stream):
    """Per-stream codes (B=6, M=1024): nvalid 0, 1 and a single symbol (RLE),
    near-predefined, skewed (custom) and spread distributions."""
    def make():
        k, nsym = _STREAMS[stream]
        rng = np.random.default_rng(100 + k)
        M = 1024
        codes = np.stack([
            rng.integers(0, nsym, M),
            rng.integers(0, nsym, M),
            np.full(M, 7),
            np.minimum(rng.geometric(0.35, M), nsym - 1),
            rng.integers(0, min(nsym, 24), M),
            np.minimum(rng.geometric(0.08, M), nsym - 1),
        ]).astype(np.int32)
        return {"codes": codes, "nvalid": np.array([0, 1, 900, M, 700, 333], np.int32),
                "stream": k}

    return make


def _choose_port(i):
    from tpu_zstd_torch.ops import fse_tables

    spec = fse_tables.stream_specs()[int(i["stream"])]
    return fse_tables.choose_stream_tables(_t(i["codes"]), _t(i["nvalid"]), spec)


def _choose_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import fse_tables_jax

    spec = fse_tables_jax.stream_specs()[int(i["stream"])]
    return jax.vmap(lambda c, n: fse_tables_jax.choose_stream_tables(c, n, spec))(
        jnp.asarray(i["codes"]), jnp.asarray(i["nvalid"]))


for _s in _STREAMS:
    case(f"choose_tables_{_s}", "fse_custom", _codes_inputs(_s), _choose_port, _choose_ref)


def _chain_inputs(kind):
    """Random closed-form tables per row. kind "seq": 6 rows of msb 1024 with
    nseq 1024, 0, 1, 2, 129 (a chunk edge) and 700, one RLE row; kind
    "weights": 4 rows of msb 128 over the 13-symbol weight alphabet."""
    def make():
        from tpu_zstd_torch.ops import fse_tables

        rng = np.random.default_rng(7 if kind == "seq" else 8)
        S, msb, nseq = (53, 1024, [1024, 0, 1, 2, 129, 700]) if kind == "seq" else (
            13, 128, [128, 3, 64, 100])
        R = len(nseq)
        cnt = np.stack([np.bincount(np.minimum(rng.geometric(rng.uniform(0.05, 0.5), 400), S - 1),
                                    minlength=S) for _ in range(R)])
        norm = fse_tables.normalize_64(torch.from_numpy(cnt), torch.from_numpy(cnt.sum(1)))
        st, dnb, dfs, init = (x.numpy() for x in fse_tables.build_cf_tables(norm))
        # Symbols drawn where the table has states (norm > 0).
        p = norm.numpy() / norm.numpy().sum(1, keepdims=True)
        rsym = np.stack([rng.choice(S, msb, p=p[r]) for r in range(R)])
        rle = np.zeros(R, bool)
        if kind == "seq":
            rle[3] = True
        return {"st": st, "dnb": dnb, "dfs": dfs, "init": init,
                "tl": np.full(R, 6), "rle": rle, "rsym": rsym, "nseq": np.array(nseq)}

    return make


def _chain_live(pre, fin, nb, nseq):
    pre, fin, nb = (np.asarray(x).astype(np.int64) for x in (pre, fin, nb))
    t = np.arange(pre.shape[1])
    live = (t >= 1) & (t < np.asarray(nseq)[:, None])
    return {"pre": np.where(live, pre, 0), "nb": np.where(live, nb, 0), "fin": fin}


def _chain_port(i):
    from tpu_zstd_torch.ops import chain

    keys = ("st", "dnb", "dfs", "init", "tl", "rle", "rsym", "nseq")
    pre, fin, nb = chain.state_chain3_plain(*(_t(i[k]) for k in keys))
    return _chain_live(pre, fin, nb, i["nseq"])


def _chain_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops import fse_jax

    keys = ("st", "dnb", "dfs", "init", "tl", "rle", "rsym", "nseq")
    a = [jnp.asarray(i[k], bool if k == "rle" else jnp.int32) for k in keys]
    pre, fin, nb = fse_jax._state_chain3_cf(*a, i["rsym"].shape[1])
    return _chain_live(pre, fin, nb, i["nseq"])


case("chain_sequences", "fse_custom", _chain_inputs("seq"), _chain_port, _chain_ref)
case("chain_weights", "fse_custom", _chain_inputs("weights"), _chain_port, _chain_ref)


CHAIN_KEYS = ("st", "dnb", "dfs", "init", "tl", "rle", "rsym", "nseq")


def _cf_tables(norm: np.ndarray):
    from tpu_zstd_torch.ops import fse_tables

    return [x.numpy() for x in fse_tables.build_cf_tables(torch.from_numpy(norm))]


def chain_hard_inputs(seed: int = 31) -> list[dict]:
    """State-chain calls (state_chain3's operands, numpy) hard for K5:

    - msb 32768 (256 chunks, the cap), 53 symbols: custom tables with nseq
      msb and msb - 1; the predefined OF (table log 5) and LL (log 6) tables
      with nseq 130 and 129; an RLE row; a symbol holding 63 of the 64 states
      and every symbol that one (its transitions only shift the state: walks
      from different entries never meet), the same with the 1-state symbol
      drawn as often as its count says, a symbol holding all 64 states
      (identity transitions); nseq 0, 1, 2 and 128;
    - msb 128, 13 symbols (the Huffman-weight shape): nseq 0, 1, 2, 127, 128,
      an RLE row, the 63-state symbol;
    - msb 1024 with S = 1 (the one symbol holds all 64 states);
    - msb 2048 with S = 64: one state each, random counts, the 63-state
      symbol, nseq 2048, 2047 and 1000.
    Symbols are drawn where the table has states."""
    from tpu_zstd_torch.ops import fse_tables

    rng = np.random.default_rng(seed)

    def rand_norm(S, R):
        cnt = np.stack([np.bincount(np.minimum(rng.geometric(rng.uniform(0.05, 0.5), 400), S - 1),
                                    minlength=S) for _ in range(R)])
        return fse_tables.normalize_64(torch.from_numpy(cnt),
                                       torch.from_numpy(cnt.sum(1))).numpy()

    def draw(norm, msb):
        p = norm / norm.sum()
        return rng.choice(len(norm), msb, p=p)

    def block(norms, msb, nseq, rle=None, tl=None, tabs=None, rsym=None):
        R, S = len(norms), norms.shape[1]
        st, dnb, dfs, init = _cf_tables(norms) if tabs is None else tabs
        if rsym is None:
            rsym = np.stack([draw(norms[r], msb) for r in range(R)])
        return {"st": st, "dnb": dnb, "dfs": dfs, "init": init,
                "tl": np.full(R, 6) if tl is None else np.asarray(tl),
                "rle": np.zeros(R, bool) if rle is None else np.asarray(rle),
                "rsym": rsym.astype(np.int64), "nseq": np.asarray(nseq)}

    def shift(S):  # a symbol holding 63 states, one holding 1
        n = np.zeros(S, np.int64)
        n[0], n[1] = 63, 1
        return n

    calls = []
    # msb 32768, S 53.
    S, msb = 53, 32768
    norms = rand_norm(S, 12)
    norms[4] = shift(S)
    norms[5] = shift(S)
    norms[6] = 0
    norms[6, 3] = 64
    st, dnb, dfs, init = _cf_tables(norms)
    rsym = np.stack([draw(norms[r], msb) for r in range(12)])
    rsym[4] = 0  # only the 63-state symbol
    ll, of = fse_tables.stream_specs()[:2]
    tl = np.full(12, 6)
    for r, spec in ((2, of), (3, ll)):  # predefined tables, padded to S
        st[r], tl[r] = spec.pred_st, spec.pred_log
        for name, dst in (("pred_dnb", dnb), ("pred_dfs", dfs), ("pred_init", init)):
            dst[r] = 0
            dst[r, :spec.nsym] = getattr(spec, name)
        pn = np.zeros(S)
        pn[:spec.nsym] = spec.pred_valid_mask
        rsym[r] = rng.choice(S, msb, p=pn / pn.sum())
    rle = np.zeros(12, bool)
    rle[11] = True  # an RLE stream: table log 0, zero tables
    st[11], dnb[11], dfs[11], init[11], tl[11] = 0, 0, 0, 0, 0
    calls.append(block(norms, msb, [msb, msb - 1, 130, 129, msb, msb, 20000, 0, 1, 2, 128, 5000],
                       rle=rle, tl=tl, tabs=(st, dnb, dfs, init), rsym=rsym))
    # msb 128, S 13 (the Huffman weights).
    norms = rand_norm(13, 8)
    norms[6] = shift(13)
    b = block(norms, 128, [0, 1, 2, 127, 128, 128, 128, 77], rle=[0, 0, 0, 0, 0, 1, 0, 0])
    b["rsym"][6] = 0
    calls.append(b)
    # S = 1: the one symbol holds all 64 states.
    calls.append(block(np.full((3, 1), 64), 1024, [1024, 500, 0]))
    # S = 64.
    norms = rand_norm(64, 5)
    norms[0] = 1
    norms[1] = shift(64)
    b = block(norms, 2048, [2048, 2048, 2047, 1000, 2048])
    b["rsym"][1] = 0
    calls.append(b)
    return calls


def chain_garbage_inputs(seed: int = 32) -> list[dict]:
    """State-chain calls whose tables lie outside the encoder's contract:
    random int32 st, dnb, dfs and init, table logs 0-40, symbols outside
    [0, S), nseq past msb. Only the kernel and its plain version are held
    equal on them (the JAX package computes in 32 bits)."""
    rng = np.random.default_rng(seed)
    calls = []
    for R, S, msb in ((6, 7, 256), (3, 64, 1024)):
        def i32(*shape):
            return rng.integers(-2**31, 2**31, shape)
        calls.append({"st": i32(R, 64), "dnb": i32(R, S), "dfs": i32(R, S), "init": i32(R, S),
                      "tl": rng.integers(0, 41, R), "rle": np.zeros(R, bool),
                      "rsym": rng.integers(-5, S + 5, (R, msb)),
                      "nseq": rng.integers(0, msb + 3, R)})
    # In-contract tables whose st strays by one entry, and an init past 64.
    norms = np.zeros((2, 13), np.int64)
    norms[:, :4] = 16
    st, dnb, dfs, init = _cf_tables(norms)
    st[0, 5] = 200
    init[1] = 70
    calls.append({"st": st, "dnb": dnb, "dfs": dfs, "init": init, "tl": np.full(2, 6),
                  "rle": np.zeros(2, bool), "rsym": rng.integers(0, 4, (2, 512)),
                  "nseq": np.array([512, 300])})
    return calls


def _chain_hard_inputs():
    return {"calls": chain_hard_inputs()}


def _chain_hard_port(i):
    out = {}
    for k, call in enumerate(i["calls"]):
        out.update({f"{n}_{k}": v for n, v in _chain_port(call).items()})
    return out


def _chain_hard_ref(i):
    out = {}
    for k, call in enumerate(i["calls"]):
        out.update({f"{n}_{k}": v for n, v in _chain_ref(call).items()})
    return out


case("chain_hard", "fse_custom", _chain_hard_inputs, _chain_hard_port, _chain_hard_ref)


def _auto_inputs():
    """Random sequences at one bucket (ms 2048): nseq 0, 1, 2, 500 and the
    bucket edge, plus one block whose every match length is the same (an RLE
    ML stream)."""
    rng = np.random.default_rng(4096)
    ms = 2048
    nseq = np.array([2048, 0, 1, 2, 500, 300])
    ll, ml, ob = _random_sequences(rng, len(nseq), ms, nseq)
    ml[5, :300] = 9
    return {"ll": ll, "ml": ml, "ob": ob, "nseq": nseq, "ms": ms}


_PREP_KEYS = ("rsym3", "r_llb", "r_mlb", "st3", "dnb3", "dfs3", "init3", "tl3", "mode3",
              "desc_ll", "desc_of", "desc_ml", "dlen3")


def _prep_port(i):
    from tpu_zstd_torch.ops import fse

    ms = int(i["ms"])
    prep = fse.prepare_sequences_auto(_t(i["ll"]), _t(i["ml"]), _t(i["ob"]), _t(i["nseq"]), ms)
    return {k: prep[k] for k in _PREP_KEYS}


def _prep_ref_full(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import fse_jax

    ms = int(i["ms"])
    return jax.vmap(lambda a, b, c, n: fse_jax.prepare_sequences_auto(a, b, c, n, ms))(
        jnp.asarray(i["ll"]), jnp.asarray(i["ml"]), jnp.asarray(i["ob"]),
        jnp.asarray(i["nseq"], jnp.int32))


def _prep_ref(i):
    prep = _prep_ref_full(i)
    return {k: prep[k] for k in _PREP_KEYS}


case("prepare_sequences_auto", "fse_custom", _auto_inputs, _prep_port, _prep_ref)


def _encode_prepared_port(i):
    from tpu_zstd_torch.ops import fse

    ms = int(i["ms"])
    nseq = _t(i["nseq"])
    prep = fse.prepare_sequences_auto(_t(i["ll"]), _t(i["ml"]), _t(i["ob"]), nseq, ms)
    out, n = fse.encode_prepared(prep, nseq, ms, _seq_cap(ms))
    return {"out": out, "len": n}


def _encode_prepared_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import fse_jax

    ms = int(i["ms"])
    prep = _prep_ref_full(i)
    out, n = jax.vmap(lambda p, n: fse_jax.encode_prepared(p, n, ms, _seq_cap(ms)))(
        prep, jnp.asarray(i["nseq"], jnp.int32))
    return {"out": out, "len": n}


case("encode_prepared", "fse_custom", _auto_inputs, _encode_prepared_port, _encode_prepared_ref)


LIT_N = 4096


def _lits_inputs():
    """Literal rows (capacity 4096): English text, 200 distinct symbols
    (FSE-coded weights), a skewed geometric mix (11-bit codes and the Kraft
    repair), uniform bytes, one repeated byte, 10 literals (nlit < 16), and
    none."""
    rng = np.random.default_rng(256)
    text = np.frombuffer(make_corpus(LIT_N), np.uint8)
    rows = [(text, LIT_N),
            (rng.choice(200, LIT_N, p=np.arange(200, 0, -1) / 20100.0), 3000),
            (np.minimum(rng.geometric(0.12, LIT_N), 255), LIT_N),
            (rng.integers(0, 256, LIT_N), 2500),
            (np.full(LIT_N, 97), 1000),
            (rng.integers(0, 256, LIT_N), 10),
            (rng.integers(0, 256, LIT_N), 0)]
    lits = np.stack([r for r, _ in rows]).astype(np.uint8)
    nlit = np.array([n for _, n in rows], np.int32)
    return {"lits": lits, "nlit": nlit}


def _huff_port_stage(stage):
    def run(i):
        from tpu_zstd_torch.ops import huffman as h

        lits, nlit = _t(i["lits"]), _t(i["nlit"])
        hist = h.literal_histogram(lits, nlit)
        if stage == "histogram":
            return {"hist": hist}
        lengths, ok = h.build_lengths(hist, nlit)
        if stage == "lengths":
            return {"lengths": lengths, "ok": ok}
        if stage == "codes":
            return {"codes": h.canonical_codes(lengths)}
        if stage == "weights_header":
            hdr, n, ok = h.weights_header(lengths)
            return {"hdr": hdr, "len": n, "ok": ok}
        if stage == "weights_fse":
            pay, n, ok = h.weights_fse_payload(lengths)
            return {"payload": pay, "len": n, "ok": ok}
        if stage == "4stream":
            out, n, ok = h.encode_literals_4stream(lits, nlit, lengths, h.canonical_codes(lengths),
                                                   h.huff_payload_cap(LIT_N))
            return {"payload": out, "len": n, "ok": ok}
        out, n, ok = h.compress_literals_huffman(lits, nlit, h.huff_payload_cap(LIT_N))
        return {"payload": out, "len": n, "ok": ok}

    return run


def _huff_ref_stage(stage):
    def run(i):
        import jax
        import jax.numpy as jnp

        from tpu_zstd.ops import huffman_jax as h

        cap = h.huff_payload_cap(LIT_N)

        def one(lits, nlit):
            hist = h.literal_histogram(lits, nlit)
            if stage == "histogram":
                return {"hist": hist}
            lengths, ok = h.build_lengths(hist, nlit)
            if stage == "lengths":
                return {"lengths": lengths, "ok": ok}
            if stage == "codes":
                return {"codes": h.canonical_codes(lengths)}
            if stage == "weights_header":
                return dict(zip(("hdr", "len", "ok"), h.weights_header(lengths)))
            if stage == "weights_fse":
                return dict(zip(("payload", "len", "ok"), h.weights_fse_payload(lengths)))
            if stage == "4stream":
                codes = h.canonical_codes(lengths)
                out = h.encode_literals_4stream(lits, nlit, lengths, codes, cap)
                return dict(zip(("payload", "len", "ok"), out))
            return dict(zip(("payload", "len", "ok"), h.compress_literals_huffman(lits, nlit, cap)))

        return jax.jit(jax.vmap(one))(jnp.asarray(i["lits"]), jnp.asarray(i["nlit"]))

    return run


for _stage in ("histogram", "lengths", "codes", "weights_header", "weights_fse", "4stream",
               "literals"):
    case(f"huffman_{_stage}", "huffman", _lits_inputs, _huff_port_stage(_stage),
         _huff_ref_stage(_stage))


def _lit_header_inputs():
    regen = np.array([0, 5, 1023, 1000, 16383, 3000, 131072, 70000])
    comp = np.array([3, 4, 1000, 1023, 9000, 16000, 100000, 262143])
    hdr_len = np.array([3, 3, 3, 3, 4, 4, 5, 5])
    return {"regen": regen, "comp": comp, "hdr_len": hdr_len}


def _lit_header_port(i):
    from tpu_zstd_torch.ops import pipeline

    return {"hdr": pipeline._lit_compressed_header(_t(i["regen"]), _t(i["comp"]),
                                                   _t(i["hdr_len"]))}


def _lit_header_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import pipeline

    return {"hdr": jax.vmap(pipeline._lit_compressed_header)(
        *(jnp.asarray(i[k], jnp.int32) for k in ("regen", "comp", "hdr_len")))}


case("lit_compressed_header", "huffman", _lit_header_inputs, _lit_header_port, _lit_header_ref)

case("frame_default_8k", "huffman",
     _frame_inputs(_cfg(8192), lambda: _mix(2, 3 * 8192)), _frame_port, _frame_ref)
case("frame_default_16k", "huffman",
     _frame_inputs(_cfg(16384), lambda: make_corpus(2 * 16384)), _frame_port, _frame_ref)
case("frame_default_16k_checksum", "huffman",
     _frame_inputs(_cfg(16384), lambda: _mix(3, 16384 + 1000), True), _frame_port, _frame_ref)


def _level_frame_inputs(level, checksum):
    """`compress` at a level's pipeline configuration with 16 KB blocks."""
    def make():
        return {"level": level, "checksum": checksum, "data": _mix(10 + level, 2 * 16384)}

    return make


def _level_frame_port(i):
    from tpu_zstd_torch.api import config, manager
    from tpu_zstd_torch.ops import pipeline

    cfg = dataclasses.replace(config.CompressionConfig.from_level(i["level"]), block_size=16384)
    return {"frame": pipeline.compress(i["data"], manager._pipeline_config(cfg),
                                       checksum=i["checksum"], device="cpu")}


def _level_frame_ref(i):
    from tpu_zstd.api import config, manager
    from tpu_zstd.ops import pipeline

    cfg = dataclasses.replace(config.CompressionConfig.from_level(i["level"]), block_size=16384)
    return {"frame": pipeline.compress(i["data"], manager._pipeline_config(cfg),
                                       checksum=i["checksum"])}


case("frame_level1_checksum", "manager", _level_frame_inputs(1, True), _level_frame_port,
     _level_frame_ref)
case("frame_level5", "manager", _level_frame_inputs(5, False), _level_frame_port,
     _level_frame_ref)


def _items_inputs(level, checksum):
    """compress_items at 16 KB blocks: corpus slices, an empty item, a run
    of one byte, random bytes and a multi-block item."""
    def make():
        rng = np.random.default_rng(level)
        items = [make_corpus(40000), b"", b"\x07" * 20000,
                 rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
                 make_corpus(70000)[::-1][:33000]]
        return {"level": level, "checksum": checksum, "items": items}

    return make


def _items_port(i):
    from tpu_zstd_torch.api import config, manager

    cfg = config.CompressionConfig.from_level(i["level"])
    cfg = dataclasses.replace(cfg, block_size=16384, checksum=config.ChecksumPolicy(i["checksum"]))
    frames = manager.compress_items(i["items"], cfg, device="cpu")
    return {f"frame{k}": f for k, f in enumerate(frames)}


def _items_ref(i):
    from tpu_zstd.api import config, manager

    cfg = config.CompressionConfig.from_level(i["level"])
    cfg = dataclasses.replace(cfg, block_size=16384, checksum=config.ChecksumPolicy(i["checksum"]))
    frames = manager.compress_items_tpu(i["items"], cfg)
    return {f"frame{k}": f for k, f in enumerate(frames)}


case("items_level3_checksum", "manager", _items_inputs(3, 1), _items_port, _items_ref)


def _xxh_inputs():
    rng = np.random.default_rng(64)
    return {"datas": [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                      for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 63, 100, 1000, 4099)]}


def _xxh_port(i):
    from tpu_zstd_torch.format import xxhash

    return {"xxh64_lo": [xxhash.xxh64(d) & 0xFFFFFFFF for d in i["datas"]],
            "xxh64_hi": [xxhash.xxh64(d) >> 32 for d in i["datas"]],
            "checksum": [xxhash.content_checksum(d) for d in i["datas"]]}


def _xxh_ref(i):
    from tpu_zstd.format import xxhash

    return {"xxh64_lo": [xxhash.xxh64(d) & 0xFFFFFFFF for d in i["datas"]],
            "xxh64_hi": [xxhash.xxh64(d) >> 32 for d in i["datas"]],
            "checksum": [xxhash.content_checksum(d) for d in i["datas"]]}


case("xxh64", "manager", _xxh_inputs, _xxh_port, _xxh_ref)


# --- Slice 3: decode checkpoints, accel frames, the decode path --------------------


def _ckpt_inputs():
    """_auto_inputs plus resolved offsets for the decoder rep triples."""
    i = _auto_inputs()
    rng = np.random.default_rng(8192)
    off = rng.integers(1, 1 << 20, i["ll"].shape).astype(np.int32)
    return {**i, "off": np.where(i["ob"] > 0, off, 0).astype(np.int32)}


def _ckpt_port(i):
    from tpu_zstd_torch.ops import fse

    ms = int(i["ms"])
    nseq = _t(i["nseq"])
    prep = fse.prepare_sequences_auto(_t(i["ll"]), _t(i["ml"]), _t(i["ob"]), nseq, ms,
                                      _t(i["off"]))
    out, n, ckb, cks, ckr = fse.encode_prepared(prep, nseq, ms, _seq_cap(ms), 256)
    return {"out": out, "len": n, "ck_bits": ckb, "ck_states": cks, "ck_rep": ckr,
            "rep_pre": prep["rep_pre"]}


def _ckpt_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import fse_jax

    ms = int(i["ms"])

    def one(a, b, c, n, o):
        p = fse_jax.prepare_sequences_auto(a, b, c, n, ms, o)
        out, ln, ckb, cks, ckr = fse_jax.encode_prepared(p, n, ms, _seq_cap(ms), 256)
        return {"out": out, "len": ln, "ck_bits": ckb, "ck_states": cks, "ck_rep": ckr,
                "rep_pre": p["rep_pre"]}

    return jax.jit(jax.vmap(one))(
        jnp.asarray(i["ll"]), jnp.asarray(i["ml"]), jnp.asarray(i["ob"]),
        jnp.asarray(i["nseq"], jnp.int32), jnp.asarray(i["off"]))


case("encode_prepared_ckpt", "accel", _ckpt_inputs, _ckpt_port, _ckpt_ref)

LIT_CKPT = 64  # literal checkpoint stride at LIT_N = 4096: 15 records a stream


def _huff_ckpt_port(i):
    from tpu_zstd_torch.ops import huffman as h

    out, n, ok, ck = h.compress_literals_huffman(_t(i["lits"]), _t(i["nlit"]),
                                                 h.huff_payload_cap(LIT_N), LIT_CKPT)
    return {"payload": out, "len": n, "ok": ok, "lit_ck": ck}


def _huff_ckpt_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import huffman_jax as h

    def one(lits, nlit):
        out, n, ok, ck = h.compress_literals_huffman(lits, nlit, h.huff_payload_cap(LIT_N),
                                                     LIT_CKPT)
        return {"payload": out, "len": n, "ok": ok, "lit_ck": ck}

    return jax.jit(jax.vmap(one))(jnp.asarray(i["lits"]), jnp.asarray(i["nlit"]))


case("huffman_literals_ckpt", "accel", _lits_inputs, _huff_ckpt_port, _huff_ckpt_ref)


def _accel_record_inputs():
    """Checkpoint records: a block with u24 reps, one with a rep >= 2^24 (u32
    reps), an empty one, and literal records with zero tails (forward
    filled by the writer). Neighbouring bit positions lie at most 65535
    apart (the u16 deltas; one delta is exactly 65535)."""
    rng = np.random.default_rng(24)
    lit = rng.integers(1000, 60000, (4, 5)).astype(np.uint32)
    lit = np.sort(lit, axis=1)[:, ::-1].copy()
    lit[:, 3:] = 0
    blocks = []
    for nck, top in ((6, 1 << 20), (3, 1 << 26), (0, 1)):
        gaps = rng.integers(0, 1 << 16, nck)
        gaps[1:2] = 0xFFFF
        bits = (100 + np.cumsum(gaps))[::-1].astype(np.uint32)
        states = rng.integers(0, 1 << 29, nck).astype(np.uint32)
        reps = rng.integers(1, top, (nck, 3)).astype(np.uint32)
        blocks.append((int(nck * 256 + 17), bits, states, reps,
                       lit if nck == 6 else np.zeros((4, 0), np.uint32)))
    return {"blocks": blocks}


def _accel_record_run(accel, blocks):
    raw = accel.write_accel_frame(256, blocks, lit_stride=1024)
    meta, end = accel.parse_accel_tail(b"\x01\x02" + raw)
    out = {"frame": np.frombuffer(raw, np.uint8), "end": end,
           "strides": [meta.stride, meta.lit_stride, meta.flags]}
    for k, (nseq, bits, states, reps, lit) in enumerate(meta.blocks):
        out.update({f"b{k}_nseq": nseq, f"b{k}_bits": bits, f"b{k}_states": states,
                    f"b{k}_reps": reps, f"b{k}_lit": lit})
    return out


def _accel_record_port(i):
    from tpu_zstd_torch.format import accel

    return _accel_record_run(accel, i["blocks"])


def _accel_record_ref(i):
    from tpu_zstd.format import accel

    return _accel_record_run(accel, i["blocks"])


case("accel_records", "accel", _accel_record_inputs, _accel_record_port, _accel_record_ref)


def _accel_items_inputs(checksum):
    """Level-3 items with decode_accel at 16 KB blocks: corpus blocks with
    several sequence and literal chunks, a run of one byte, random bytes and
    a short text."""
    def make():
        rng = np.random.default_rng(316)
        base = make_corpus(3 * 16384)
        items = [base[:16384], base[16384:32768], b"\x09" * 7000,
                 rng.integers(0, 256, 4000, dtype=np.uint8).tobytes(), base[40000:41000]]
        return {"checksum": checksum, "items": items}

    return make


def _accel_cfg(ref: bool, checksum: int):
    from importlib import import_module

    config = import_module("tpu_zstd.api.config" if ref else "tpu_zstd_torch.api.config")
    cfg = config.CompressionConfig.from_level(3)
    return dataclasses.replace(cfg, block_size=16384, decode_accel=True,
                               checksum=config.ChecksumPolicy(checksum))


def _accel_items_port(i):
    from tpu_zstd_torch.api import manager

    frames = manager.compress_items(i["items"], _accel_cfg(False, i["checksum"]), device="cpu")
    return {f"frame{k}": f for k, f in enumerate(frames)}


def _accel_items_ref(i):
    from tpu_zstd.api import manager

    frames = manager.compress_items_tpu(i["items"], _accel_cfg(True, i["checksum"]))
    return {f"frame{k}": f for k, f in enumerate(frames)}


case("accel_items_16k", "accel", _accel_items_inputs(0), _accel_items_port, _accel_items_ref)
case("accel_items_16k_checksum", "accel", _accel_items_inputs(1), _accel_items_port,
     _accel_items_ref)

DEC_N = 16384  # decode cases: 16 KB blocks (several sequence and literal chunks)


def _dec_frames_inputs(kind):
    """Single-block frames of corpus slices and a mixed block: the port's
    level-3 decode_accel frames ("accel", chunk-parallel with device
    literals), the same without metadata ("plain", serial decode, host
    literals), or stock libzstd's at levels 1, 3, 9 and 19 ("zstd"). Built
    once per kind; callers do not modify the result."""
    @functools.lru_cache(maxsize=None)
    def make():
        from tpu_zstd_torch.api import config, manager

        n = DEC_N if kind == "accel" else DEC_N // 4  # serial decodes cost a step a sequence
        base = make_corpus(4 * n)
        payloads = [base[k * n : (k + 1) * n] for k in range(3)] + [_mix(33, n)]
        if kind == "zstd":  # only libzstd's frames need zstandard (the card's machine has none)
            import zstandard

            frames = [zstandard.ZstdCompressor(level=lv).compress(p)
                      for p, lv in zip(payloads, (1, 3, 9, 19))]
        else:
            cfg = dataclasses.replace(config.CompressionConfig.from_level(3),
                                      decode_accel=kind == "accel")
            frames = manager.compress_items(payloads, cfg, device="cpu")
        return {"frames": frames, "payloads": payloads}

    return make


def _dec_digest(out, lens, payloads):
    lens = np.asarray(lens).astype(np.int64)
    out = np.asarray(out)
    got = [out[k, : lens[k]].tobytes() for k in range(len(payloads))]
    return {"lens": lens, "equal_input": [g == p for g, p in zip(got, payloads)],
            "out": np.where(np.arange(out.shape[1]) < lens[:, None], out, 0)}


def _dec_batch_port(i):
    from tpu_zstd_torch.api import decompress

    out, lens = decompress.prepare_decompress_batch(i["frames"], DEC_N, device="cpu").execute()
    return _dec_digest(out, lens, i["payloads"])


def _dec_batch_ref(i):
    import jax

    from tpu_zstd.api import decompress

    out, lens = jax.device_get(decompress.prepare_decompress_batch(i["frames"], DEC_N).execute())
    return _dec_digest(out, lens, i["payloads"])


_DEC_FRAMES = {kind: _dec_frames_inputs(kind) for kind in ("accel", "plain", "zstd")}
for _kind, _make in _DEC_FRAMES.items():
    case(f"decompress_batch_{_kind}", "decode", _make, _dec_batch_port, _dec_batch_ref)


# Multi-block frames: 8 KB blocks, max_block the same. The frames are made
# once by tools/make_torch_goldens.py multiblock (the JAX package's
# compress_items_tpu, whose frames the port's equal byte for byte, and stock
# libzstd with blocks ended by flushes) and kept in
# tests/golden/multiblock_frames.json, so that the case compresses nothing and
# a machine without `zstandard` decodes libzstd's frames too; those carry
# repeat offsets and matches across blocks, which frames of blocks
# compressed on their own never do.
MB_N = 8192
MB_FRAMES = GOLDEN.parent / "multiblock_frames.json"


def multiblock_specs() -> list[dict]:
    """The frames of the case `decompress_multiblock`, in batch order: who
    makes each ("jax": compress_items_tpu at `level`, with a checksum or
    decode_accel; "zstd": libzstd at `level`, a block ended after each count
    of input bytes in `flush`) and its payload (corpus slices, seeded random
    bytes). libzstd's level-19 frame uses repeat offsets from the block
    before at a block's first sequences: decoded with the triple reset at
    each block it differs from its payload."""
    base = make_corpus(8 * MB_N)
    noise = np.random.default_rng(72).integers(0, 256, MB_N, dtype=np.uint8).tobytes()
    noise2 = np.random.default_rng(71).integers(0, 256, 4500, dtype=np.uint8).tobytes()
    jax3 = {"by": "jax", "level": 3, "checksum": True, "decode_accel": False}
    return [{**jax3, "payload": base[: 3 * MB_N + 5000]},  # 4 blocks
            {**jax3, "payload": base[3 * MB_N : 3 * MB_N + 4500]},  # 1 block
            {**jax3, "payload": noise + base[: MB_N // 2]},  # a Raw block first
            {**jax3, "level": 19, "checksum": False, "payload": base[2 * MB_N : 5 * MB_N]},
            {**jax3, "checksum": False, "decode_accel": True,
             "payload": base[MB_N : 3 * MB_N - 100]},
            {"by": "zstd", "level": 19, "flush": [MB_N, MB_N // 2, MB_N], "checksum": False,
             "payload": base[5 * MB_N :]},
            {"by": "zstd", "level": 3, "flush": [4500, 6000], "checksum": True,
             "payload": noise2 + base[:10000]}]


def zstd_flushed(spec: dict) -> bytes:
    """A libzstd frame of spec's payload with a block ended at each flush
    (needs `zstandard`)."""
    import zstandard

    data = spec["payload"]
    c = zstandard.ZstdCompressor(level=spec["level"], write_checksum=spec["checksum"]).compressobj(
        size=len(data))
    out, p = [], 0
    for n in spec["flush"]:
        out += [c.compress(data[p : p + n]), c.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)]
        p += n
    out += [c.compress(data[p:]), c.flush()]
    return b"".join(out)


def multiblock_frames() -> list[bytes]:
    """The recorded frames of `multiblock_specs`, in the same order."""
    import base64

    return [base64.b64decode(f["b64"]) for f in json.loads(MB_FRAMES.read_text())["frames"]]


def _mb_frames_inputs():
    """A batch of frames of 1-4 blocks (`multiblock_specs`): level-3 frames
    with a checksum (4 blocks, 1 block, a Raw block then a Compressed one), a
    level-19 frame, a level-3 decode_accel frame of 2 blocks (its tail is
    stripped, its checkpoints unused), libzstd's level-19 frame and its
    level-3 checksummed one behind a skippable frame; then a frame whose
    window (8 MiB, no content size) exceeds the plan's cap."""
    @functools.lru_cache(maxsize=None)
    def make():
        frames = multiblock_frames()
        skippable = (0x184D2A50).to_bytes(4, "little") + (3).to_bytes(4, "little") + b"abc"
        frames[-1] = skippable + frames[-1]
        # Window descriptor 8 MiB, no content size; two Raw blocks.
        wide = (0xFD2FB528).to_bytes(4, "little") + bytes([0x00, 13 << 3])
        wide += ((5 << 3) | 0).to_bytes(3, "little") + b"12345"
        wide += ((5 << 3) | 1).to_bytes(3, "little") + b"67890"
        return {"frames": frames, "payloads": [s["payload"] for s in multiblock_specs()],
                "wide": [wide, frames[0]]}

    return make


def _mb_refused(prepare, frames) -> list[int]:
    try:
        prepare(frames)
    except ValueError:
        return [1]
    return [0]


def _mb_port(i):
    from tpu_zstd_torch.api import decompress

    out, lens = decompress.prepare_decompress_batch(i["frames"], MB_N, device="cpu").execute(
        verify_checksum=True)
    return {**_dec_digest(out, lens, i["payloads"]), "refused": _mb_refused(
        lambda f: decompress.prepare_decompress_batch(f, MB_N, device="cpu"), i["wide"])}


def _mb_ref(i):
    import jax

    from tpu_zstd.api import decompress

    out, lens = jax.device_get(decompress.prepare_decompress_batch(i["frames"], MB_N).execute(
        verify_checksum=True))
    return {**_dec_digest(out, lens, i["payloads"]), "refused": _mb_refused(
        lambda f: decompress.prepare_decompress_batch(f, MB_N), i["wide"])}


case("decompress_multiblock", "decode", _mb_frames_inputs(), _mb_port, _mb_ref)


def _staged(kind):
    """The decode kernels' inputs staged as the decode plan stages them, from
    `_dec_frames_inputs(kind)` (every block Compressed, with sequences)."""
    def make():
        from tpu_zstd_torch.api import decompress as D
        from tpu_zstd_torch.format.accel import parse_accel_tail
        from tpu_zstd_torch.format.frame import parse_frame_header

        fr = _DEC_FRAMES[kind]()
        plans, recs, strides = [], [], None
        for f in fr["frames"]:
            meta, end = parse_accel_tail(f)
            f = f[:end]
            pos = parse_frame_header(f).header_size
            bh = int.from_bytes(f[pos : pos + 3], "little")
            assert (bh >> 1) & 3 == 2, "decode cases need Compressed blocks"
            plan, _, _ = D._parse_block_plan(f[pos + 3 : pos + 3 + (bh >> 3)], None, None,
                                             device_literals=meta is not None)
            plans.append(plan)
            recs.append(meta.blocks[0] if meta else None)
            strides = (meta.stride, meta.lit_stride) if meta else None
        B = len(plans)
        # Staged widths as the plan stages them (a power of two >= 64 bytes):
        # the JAX decoders' word windows need slack after a stream's end.
        S = D._bucket(max(max(len(p.stream) for p in plans), 64), lo=64)
        st = {"streams": np.zeros((B, S), np.uint8), "tbits": np.zeros(B, np.int32),
              "nseq": np.zeros(B, np.int32), "sym": np.zeros((B, 3, 512), np.int32),
              "nb": np.zeros((B, 3, 512), np.int32), "ns": np.zeros((B, 3, 512), np.int32),
              "logs": np.zeros((B, 3), np.int32)}
        for b, p in enumerate(plans):
            st["streams"][b, : len(p.stream)] = np.frombuffer(p.stream, np.uint8)
            st["tbits"][b], st["nseq"][b] = p.total_bits, p.nbseq
            st["sym"][b], st["nb"][b], st["ns"][b], st["logs"][b] = p.tables
        if strides is None:
            return st
        C, CL = strides
        NC = -(-int(st["nseq"].max()) // C)
        K = max(NC - 1, 1)
        st.update(C=C, NC=NC, ckb=np.zeros((B, K), np.int32), cks=np.zeros((B, K), np.int32),
                  ckr=np.ones((B, K, 3), np.int32))
        for b, rec in enumerate(recs):
            n = len(rec[1])
            st["ckb"][b, :n], st["cks"][b, :n], st["ckr"][b, :n] = rec[1], rec[2], rec[3]
        lsw = D._bucket(max(max(len(s) for p in plans for s in p.litdev[0]), 64), lo=64)
        NCL = -(-max(max(p.litdev[2]) for p in plans) // CL)
        lst = {"lstreams": np.zeros((4 * B, lsw), np.uint8), "ltbits": np.zeros(4 * B, np.int32),
               "lnsym": np.zeros(4 * B, np.int32), "dtab": np.zeros((B, 2048), np.int32),
               "tlog": np.zeros(B, np.int32), "lck": np.zeros((4 * B, max(NCL - 1, 1)), np.int32),
               "regen": np.zeros(B, np.int32), "CL": CL, "NCL": NCL}
        for b, (p, rec) in enumerate(zip(plans, recs)):
            sts, tb, nsy, packed, tl, rg = p.litdev
            lst["dtab"][b], lst["tlog"][b], lst["regen"][b] = packed, tl, rg
            for s in range(4):
                r = 4 * b + s
                lst["lstreams"][r, : len(sts[s])] = np.frombuffer(sts[s], np.uint8)
                lst["ltbits"][r], lst["lnsym"][r] = tb[s], nsy[s]
                n = min(rec[4].shape[1], NCL - 1)
                lst["lck"][r, :n] = rec[4][s, :n]
        return {**st, **lst}

    return make


MAX_SEQS_DEC = 44032


def _seq_mask(i, outs):
    live = np.arange(MAX_SEQS_DEC)[None, :] < i["nseq"][:, None]
    return {k: np.where(live, np.asarray(v), 0) for k, v in zip(("ll", "ml", "off"), outs)}


def _seq_port(i):
    from tpu_zstd_torch.ops import decode

    tables = decode.SeqTables(*(_t(i[k]) for k in ("sym", "nb", "ns", "logs")))
    args = (_t(i["streams"]), _t(i["tbits"]), tables, _t(i["nseq"]))
    if "C" in i:
        out = decode.decode_sequences_device_chunked(
            *args, _t(i["ckb"]), _t(i["cks"]), _t(i["ckr"]), i["C"], i["NC"], MAX_SEQS_DEC)
    else:
        out = decode.decode_sequences_device(
            *args, _t(np.tile(np.int32([1, 4, 8]), (len(i["nseq"]), 1))), MAX_SEQS_DEC)
    return {**_seq_mask(i, out[:3]), "rep_fin": out[3]}


def _seq_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops import decode_jax

    tables = decode_jax.SeqTables(*(jnp.asarray(i[k]) for k in ("sym", "nb", "ns", "logs")))
    args = (jnp.asarray(i["streams"]), jnp.asarray(i["tbits"]), tables, jnp.asarray(i["nseq"]))
    if "C" in i:
        out = decode_jax.decode_sequences_device_chunked(
            *args, jnp.asarray(i["ckb"]), jnp.asarray(i["cks"]), jnp.asarray(i["ckr"]), i["C"],
            i["NC"], MAX_SEQS_DEC)
    else:
        out = decode_jax.decode_sequences_device(
            *args, jnp.asarray(np.tile(np.int32([1, 4, 8]), (len(i["nseq"]), 1))), MAX_SEQS_DEC)
    return {**_seq_mask(i, out[:3]), "rep_fin": out[3]}


case("decode_sequences_serial", "decode", _staged("zstd"), _seq_port, _seq_ref)
case("decode_sequences_chunked", "decode", _staged("accel"), _seq_port, _seq_ref)


def _i32wrap(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def _seq_block(rng, dts, nseq: int, stride: int):
    """A sequence bitstream that the decode tables dts (LL, OF, ML DTables)
    read as nseq sequences with seeded extra and state bits, and its
    checkpoint records every `stride` sequences. Returns (stream bytes,
    total_bits, records (cursor, packed states, rep triple) before sequences
    stride, 2 stride, ...). The decode walk is simulated forward: the
    fields go in the order the decoder reads them, the first one at the
    stream's top; offsets and the rep triple wrap as int32."""
    from tpu_zstd_torch.constants import LL_BASELINE, LL_BITS, ML_BITS

    fields, used, recs = [], 0, []

    def put(v, n):
        nonlocal used
        fields.append((int(v), int(n)))
        used += int(n)

    def draw(n):
        return int(rng.integers(0, 1 << n)) if n else 0

    st = []
    for dt in dts:
        st.append(draw(dt.table_log))
        put(st[-1], dt.table_log)
    rep = [1, 4, 8]
    for j in range(nseq):
        if j and j % stride == 0:
            recs.append((used, st[0] | st[1] << 10 | st[2] << 20, list(rep)))
        e = [(int(dt.symbol[x]), int(dt.nb_bits[x]), int(dt.new_state[x]))
             for dt, x in zip(dts, st)]
        llc, ofc, mlc = min(e[0][0], 35), min(e[1][0], 31), min(e[2][0], 52)
        ofx = draw(ofc)
        put(ofx, ofc)
        ofv = _i32wrap((1 << min(ofc, 30)) + ofx) if ofc else 1
        mlx, llx = draw(int(ML_BITS[mlc])), draw(int(LL_BITS[llc]))
        put(mlx << int(LL_BITS[llc]) | llx, int(ML_BITS[mlc]) + int(LL_BITS[llc]))
        ll = int(LL_BASELINE[llc]) + llx
        idx = ofv - 1 + (ll == 0)
        if ofv > 3:
            rep = [_i32wrap(ofv - 3), rep[0], rep[1]]
        else:
            off = rep[idx] if 0 <= idx <= 2 else max(_i32wrap(rep[0] - 1), 1)
            rep = [off, rep[1] if idx == 0 else rep[0], rep[2] if idx <= 1 else rep[1]]
        if j < nseq - 1:
            b = [draw(x[1]) for x in e]
            put(b[0] << (e[1][1] + e[2][1]) | b[2] << e[1][1] | b[1], e[0][1] + e[1][1] + e[2][1])
            st = [x[2] + y for x, y in zip(e, b)]
    acc = 0
    for v, n in fields:
        acc = acc << n | v
    T = used
    data = (acc | 1 << T).to_bytes(T // 8 + 1, "little")
    return data, T, [(T - u, sts, r) for u, sts, r in recs]


def _seq_norm(rng, nsym: int, log: int):
    """Normalized counts of every symbol 0..nsym-1, summing to 2^log."""
    extra = rng.multinomial((1 << log) - nsym, rng.dirichlet(np.ones(nsym) * 0.3))
    return (extra + 1).astype(np.int32)


def seq_hard_inputs(seed: int = 11, stride: int = 64):
    """K7's hard inputs, staged as the decode plan stages them (keys as
    `_staged`, plus max_seqs), as "chunked" (records every `stride`
    sequences) and "serial" (one chunk a block) sets:

    - RLE tables of LL code 35, OF code 31 and ML code 52: 16 + 31 + 16
      extra bits every sequence, offsets past 2^31 wrapping; nseq exactly 3
      strides;
    - FSE tables of table_log 9, 8 and 9 over every code; nseq 2 strides
      + 37;
    - the predefined tables, nseq 1;
    - RLE tables whose codes read no bits (states of table_log 0), nseq 2
      strides + 5, a stream that is its end-marker byte alone, and no
      records: its chunks 1 and 2 start from zeros;
    - FSE tables, nseq 4 strides, chunk 1's record pointing 40 bits past the
      stream's end (into the row's zero padding);
    - chunks past every block's last record (the plan's power-of-two chunk
      count), and max_seqs 8 below the longest block's nseq (the last
      sequences decode for the rep triple only).
    Serial set: the first table set with 9000 sequences (a stream longer
    than K7's 64 KB of staged words), the second with 700, the predefined
    tables with 1, and a block with no sequences."""
    from tpu_zstd_torch.api.decompress import _dense_tables
    from tpu_zstd_torch.format.fse import build_dtable
    from tpu_zstd_torch.format.sequences import predefined_dtables, rle_dtable

    rng = np.random.default_rng(seed)
    rle_max = (rle_dtable(35), rle_dtable(31), rle_dtable(52))
    rle_zero = (rle_dtable(0), rle_dtable(0), rle_dtable(0))

    def fse():
        return (build_dtable(_seq_norm(rng, 36, 9), 9), build_dtable(_seq_norm(rng, 32, 8), 8),
                build_dtable(_seq_norm(rng, 53, 9), 9))

    def stage(blocks, C=None, NC=None, max_seqs=None):
        B = len(blocks)
        S = _bucket_pow2(max(max(len(d) for _, d, _, _ in blocks), 64))
        st = {"streams": np.zeros((B, S), np.uint8), "tbits": np.zeros(B, np.int32),
              "nseq": np.zeros(B, np.int32), "sym": np.zeros((B, 3, 512), np.int32),
              "nb": np.zeros((B, 3, 512), np.int32), "ns": np.zeros((B, 3, 512), np.int32),
              "logs": np.zeros((B, 3), np.int32)}
        for b, (dts, data, T, n) in enumerate(blocks):
            st["streams"][b, : len(data)] = np.frombuffer(data, np.uint8)
            st["tbits"][b], st["nseq"][b] = T, n
            if dts is not None:
                st["sym"][b], st["nb"][b], st["ns"][b], st["logs"][b] = _dense_tables(dts)
        mx = int(st["nseq"].max())
        st["max_seqs"] = max_seqs or max(-(-mx // 256) * 256, 256)
        if C is None:
            st.update(C=max(mx, 1), NC=1)
        else:
            st.update(C=C, NC=NC, ckb=np.zeros((B, NC - 1), np.int32),
                      cks=np.zeros((B, NC - 1), np.int32), ckr=np.ones((B, NC - 1, 3), np.int32))
        return st

    chunked, recs = [], []
    for dts, n in ((rle_max, 3 * stride), (fse(), 2 * stride + 37), (predefined_dtables(), 1),
                   (rle_zero, 2 * stride + 5), (fse(), 4 * stride)):
        data, T, rec = _seq_block(rng, dts, n, stride)
        chunked.append((dts, data, T, n))
        recs.append(rec)
    recs[3] = []  # no records: chunks 1 and 2 start from zeros
    NC = _bucket_pow2(-(-max(n for *_, n in chunked) // stride), lo=1)
    ch = stage(chunked, stride, NC, 4 * stride - 8)
    for b, rec in enumerate(recs):
        for k, (cur, sts, rep) in enumerate(rec):
            ch["ckb"][b, k], ch["cks"][b, k], ch["ckr"][b, k] = cur, sts, rep
    bad = 8 * len(chunked[4][1]) + 40
    assert bad + 64 <= 8 * ch["streams"].shape[1]
    ch["ckb"][4, 0] = bad
    serial = []
    for dts, n in ((rle_max, 9000), (fse(), 700), (predefined_dtables(), 1)):
        data, T, _ = _seq_block(rng, dts, n, 1 << 30)
        serial.append((dts, data, T, n))
    serial.append((None, b"", 0, 0))
    return {"chunked": ch, "serial": stage(serial)}


def seq_garbage_inputs(hard: dict, seed: int = 12):
    """The chunked hard set with scrambled records (cursors from below the
    stream to past its row, 10-bit states past the tables, rep triples
    anywhere in int32), 62 sequences a chunk and max_seqs no multiple of 4:
    for K7 against its plain version only (the JAX package reads bits
    below a stream and states past 511 otherwise)."""
    rng = np.random.default_rng(seed)
    g = dict(hard["chunked"])
    B, K = g["ckb"].shape
    S = g["streams"].shape[1]
    g["ckb"] = rng.integers(-300, 8 * S + 600, (B, K)).astype(np.int32)
    g["cks"] = rng.integers(0, 1 << 30, (B, K)).astype(np.int32)
    g["ckr"] = rng.integers(-(1 << 31), 1 << 31, (B, K, 3)).astype(np.int32)
    g.update(C=62, max_seqs=g["max_seqs"] - 3)
    return g


def _bucket_pow2(n: int, lo: int = 64) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def seq_port_run(i):
    """The plain K7 on a staged set: (ll, ml, off, rep_fin)."""
    from tpu_zstd_torch.ops import decode

    tables = decode.SeqTables(*(_t(i[k]) for k in ("sym", "nb", "ns", "logs")))
    nseq = _t(i["nseq"])
    rep0 = _t(np.tile(np.int32([1, 4, 8]), (len(i["nseq"]), 1)))
    none = np.zeros((len(i["nseq"]), 0), np.int32)
    ck = [_t(i.get(k, none)) for k in ("ckb", "cks")] + [_t(i.get("ckr", none[..., None]))]
    ll, ml, off, rows = decode.decode_sequences_chunks(
        _t(i["streams"]), _t(i["tbits"]), tables, nseq, rep0, *ck, i["C"], i["NC"], i["max_seqs"])
    return ll, ml, off, decode.final_rep(rows, nseq, i["C"], i["NC"])


def _seq_hard_port(i):
    out = {}
    for k, v in i.items():
        out.update({f"{k}_{n}": x for n, x in zip(("ll", "ml", "off", "rep_fin"),
                                                   seq_port_run(v))})
    return out


def _seq_hard_ref(i):
    """The chunked set through the JAX package's chunk scan
    (decode_jax._decode_seqs_core, set up as decode_sequences_device_chunked
    sets it up, its carried rep rows kept), the serial set through
    decode_sequences_device."""
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import decode_jax

    out = {}
    for k, v in i.items():
        tables = decode_jax.SeqTables(*(jnp.asarray(v[n]) for n in ("sym", "nb", "ns", "logs")))
        B, C, NC, ms = len(v["nseq"]), v["C"], v["NC"], v["max_seqs"]
        nseq = v["nseq"]
        if k == "serial":
            ll, ml, off, fin = decode_jax.decode_sequences_device(
                jnp.asarray(v["streams"]), jnp.asarray(v["tbits"]), tables, jnp.asarray(nseq),
                jnp.asarray(np.tile(np.int32([1, 4, 8]), (B, 1))), ms)
        else:
            rep_rows = np.concatenate([np.tile(np.int32([[1, 4, 8]]), (B, 1, 1)), v["ckr"]], 1)

            def run(streams, tbits, ckb, cks, rows):
                return decode_jax._decode_seqs_core(
                    decode_jax._pack_words(streams), tbits, tables, jnp.asarray(nseq),
                    rows, ckb, cks, C, NC)

            o_ll, o_ml, o_off, rows = jax.jit(run)(
                jnp.asarray(v["streams"]), jnp.asarray(v["tbits"]), jnp.asarray(v["ckb"]),
                jnp.asarray(v["cks"]), jnp.asarray(rep_rows.reshape(-1, 3)))
            ll, ml, off = (np.asarray(a).T.reshape(B, NC * C)[:, :ms] for a in (o_ll, o_ml, o_off))
            cl = np.minimum((np.maximum(nseq, 1) - 1) // C, NC - 1)
            fin = np.asarray(rows).reshape(B, NC, 3)[np.arange(B), cl]
        out.update({f"{k}_{n}": np.asarray(x) for n, x in zip(("ll", "ml", "off", "rep_fin"),
                                                               (ll, ml, off, fin))})
    return out


case("decode_sequences_hard", "decode", lambda: seq_hard_inputs(), _seq_hard_port,
     _seq_hard_ref)


def _huf_mask(i, syms):
    syms = np.asarray(syms)
    return np.where(np.arange(syms.shape[1])[None, :] < i["lnsym"][:, None], syms, 0)


def _huf_port(i):
    from tpu_zstd_torch.ops import decode

    syms = decode.decode_huffman_device(
        *(_t(i[k]) for k in ("lstreams", "ltbits", "dtab", "tlog", "lnsym")), i["CL"], i["NCL"],
        _t(i["lck"]))
    lits = decode.assemble_literals_4stream(syms, _t(i["regen"]), DEC_N)
    return {"syms": _huf_mask(i, syms), "lits": lits}


def _huf_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops import decode_jax

    syms = decode_jax.decode_huffman_device(
        *(jnp.asarray(i[k]) for k in ("lstreams", "ltbits", "dtab", "tlog", "lnsym")), i["CL"],
        i["NCL"], jnp.asarray(i["lck"]))
    lits = decode_jax.assemble_literals_4stream(syms, jnp.asarray(i["regen"]), DEC_N)
    return {"syms": _huf_mask(i, syms), "lits": lits}


case("decode_huffman", "decode", _staged("accel"), _huf_port, _huf_ref)


def _huf_code(rng, kind: str):
    """Code lengths (256,) and table_log of a complete prefix code: "flat8"
    256 symbols of 8 bits, "one" 2 symbols of 1 bit, "skew11" a random tree
    of depth 11 (short codes beside 11-bit ones)."""
    if kind == "flat8":
        return np.full(256, 8), 8
    if kind == "one":
        ln = np.zeros(256, np.int64)
        ln[[7, 200]] = 1
        return ln, 1
    leaves = [0]  # split random leaves of depth < 11 until 120 leaves, one at 11
    while len(leaves) < 120 or max(leaves) < 11:
        cand = [i for i, d in enumerate(leaves) if d < 11]
        i = cand[-1] if len(leaves) >= 110 else cand[int(rng.integers(0, len(cand)))]
        d = leaves.pop(i)
        leaves += [d + 1, d + 1]
    ln = np.zeros(256, np.int64)
    ln[rng.permutation(256)[: len(leaves)]] = leaves
    return ln, 11


def _huf_table(ln, tl):
    """Canonical codes of lengths ln and the packed decode table
    (sym << 4 | nb_bits at every index the code prefixes)."""
    code = np.zeros(256, np.int64)
    dt = np.zeros(2048, np.int32)
    nxt = 0
    for nb in range(1, tl + 1):
        for sym in np.flatnonzero(ln == nb):
            code[sym] = nxt
            lo = nxt << (tl - nb)
            dt[lo : lo + (1 << (tl - nb))] = sym << 4 | nb
            nxt += 1
        nxt <<= 1
    return code, dt


def _huf_stream(syms, code, ln):
    """Backward stream of syms: symbol 0's code in the top bits, its MSB at
    bit T - 1; the last symbol's code ends at bit 0. Returns (bytes, T,
    cursor before each symbol)."""
    nbits = ln[syms]
    T = int(nbits.sum())
    before = T - np.concatenate([[0], np.cumsum(nbits)[:-1]])
    bits = np.zeros(T + 8, np.uint8)
    for j, (sym, top) in enumerate(zip(syms, before)):
        nb = int(nbits[j])
        c = int(code[sym])
        bits[top - nb : top] = [(c >> k) & 1 for k in range(nb)]
    return np.packbits(bits, bitorder="little").tobytes()[: (T + 7) // 8], T, before


def huf_hard_inputs(seed: int, stride: int = 1024, reps: int = 1):
    """K6's hard inputs, staged as the decode plan stages them (keys as
    `_staged`): per block a table and 4 streams, repeated `reps` times.
    Block tables: 256 codes of 8 bits (lane starts off the 8-bit grid never
    meet); table_log 1; table_log 11 (lengths 1-11). Streams: nsym no
    multiple of the stride, nsym ending exactly on a chunk boundary, 1
    symbol, empty, the last chunk's start record forward-filled with 0, a
    record 3 bits off, records past a stream's chunks forward-filled with
    0."""
    rng = np.random.default_rng(seed)
    plan = [("flat8", [4 * stride + 333, 3 * stride, 1, stride - 1]),
            ("one", [2 * stride + 5, stride, 17, 1]),
            ("skew11", [5 * stride + 999, 4 * stride, 2, 700]),
            ("skew11", [3 * stride + 40, 2 * stride + 1, 6 * stride, 0]),
            ("flat8", [stride - 3, 5, 0, 1])] * reps
    B = len(plan)
    streams, recs, tabs = [], [], []
    for b, (kind, ns) in enumerate(plan):
        ln, tl = _huf_code(rng, kind)
        code, dt = _huf_table(ln, tl)
        tabs.append((dt, tl))
        live = np.flatnonzero(ln)
        p = rng.random(len(live)) ** 3
        for s, n in enumerate(ns):
            syms = rng.choice(live, n, p=p / p.sum())
            data, T, before = _huf_stream(syms, code, ln)
            ck = before[stride::stride][: max(-(-n // stride) - 1, 0)].astype(np.int64)
            streams.append((data, T, n))
            recs.append(ck)
    NC = max(-(-n // stride) for _, _, n in streams)
    K = NC - 1
    SW = max(64, 1 << (max(len(d) for d, _, _ in streams) - 1).bit_length())
    st = {"lstreams": np.zeros((4 * B, SW), np.uint8), "ltbits": np.zeros(4 * B, np.int32),
          "lnsym": np.zeros(4 * B, np.int32), "dtab": np.zeros((B, 2048), np.int32),
          "tlog": np.zeros(B, np.int32), "lck": np.zeros((4 * B, K), np.int32),
          "CL": stride, "NCL": NC}
    for b, (dt, tl) in enumerate(tabs):
        st["dtab"][b], st["tlog"][b] = dt, tl
    for r, ((data, T, n), ck) in enumerate(zip(streams, recs)):
        st["lstreams"][r, : len(data)] = np.frombuffer(data, np.uint8)
        st["ltbits"][r], st["lnsym"][r] = T, n
        st["lck"][r, : len(ck)] = ck
    st["lck"][12, -(-int(st["lnsym"][12]) // stride) - 2] = 0  # last chunk starts at 0
    st["lck"][13, 0] += 3  # a record 3 bits off: chunk 1 decodes from there
    return st


def _huf_hard_inputs():
    """The hard streams with their records, and again with none (K = 0)."""
    st = huf_hard_inputs(5, 1024)
    norec = {**st, "lck": np.zeros((st["lck"].shape[0], 0), np.int32)}
    return {"h": st, "norec": norec}


def _huf_hard_port(i):
    from tpu_zstd_torch.ops import decode

    out = {}
    for k, v in i.items():
        syms = decode.decode_huffman_device(
            *(_t(v[n]) for n in ("lstreams", "ltbits", "dtab", "tlog", "lnsym")), v["CL"],
            v["NCL"], _t(v["lck"]))
        out[k] = _huf_mask(v, syms)
    return out


def _huf_hard_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops import decode_jax

    out = {}
    for k, v in i.items():
        syms = decode_jax.decode_huffman_device(
            *(jnp.asarray(v[n]) for n in ("lstreams", "ltbits", "dtab", "tlog", "lnsym")),
            v["CL"], v["NCL"], jnp.asarray(v["lck"]))
        out[k] = _huf_mask(v, syms)
    return out


case("decode_huffman_hard", "decode", _huf_hard_inputs, _huf_hard_port, _huf_hard_ref)


def exec_inputs(seed, B, N, W, MS, L):
    """Valid random sequences (lits, nlit, ll, ml, off, nseq, window): every
    offset reaches at most into the window, overlapping copies (off < ml)
    included, tail literals after the last sequence."""
    rng = np.random.default_rng(seed)
    ll = np.zeros((B, MS), np.int32)
    ml = np.zeros((B, MS), np.int32)
    off = np.ones((B, MS), np.int32)
    nseq = np.zeros(B, np.int32)
    nlit = np.zeros(B, np.int32)
    lits = np.zeros((B, L), np.uint8)
    for b in range(B):
        po = lp = s = 0
        for _ in range(int(rng.integers(0, MS + 1))):
            llv, mlv = int(rng.integers(0, 20)), int(rng.integers(3, 60))
            if po + llv + mlv > N - 20 or lp + llv > L - 30 or po + llv + W < 1:
                break
            ofv = int(rng.integers(1, 5)) if rng.random() < 0.3 else \
                int(rng.integers(1, po + llv + W + 1))
            ll[b, s], ml[b, s], off[b, s] = llv, mlv, ofv
            po, lp, s = po + llv + mlv, lp + llv, s + 1
        nseq[b] = s
        nlit[b] = lp + int(rng.integers(0, min(20, L - lp)))
        lits[b, : nlit[b]] = rng.integers(0, 256, nlit[b], dtype=np.uint8)
    window = rng.integers(0, 256, (B, max(W, 1)), dtype=np.uint8)
    return lits, nlit, ll, ml, off, nseq, window


def _exec_inputs():
    B, N, MS, L = 6, 4096, 96, 2048
    cases = {f"w{W}": exec_inputs(W + 5, B, N, W, MS, L) for W in (1, 300)}
    # Literal rows straight from 4-stream symbol rows (lit_src).
    lits, nlit = cases["w1"][0], cases["w1"][1]
    return {"cases": cases, "N": N, "syms": stream_rows(lits, nlit, L // 4 + 8)}


def _exec_run(fn, i, conv):
    out = {}
    for name, args in i["cases"].items():
        o, n = fn(*(conv(a) for a in args), i["N"], args[6].shape[1])
        o, n = np.asarray(o), np.asarray(n).astype(np.int64)
        out[f"{name}_len"] = n
        out[f"{name}_out"] = np.where(np.arange(i["N"])[None, :] < n[:, None], o, 0)
    args = i["cases"][i.get("src_case", "w1")]
    o, n = fn(*(conv(a) for a in args), i["N"], 1, lit_src=(conv(i["syms"]), conv(args[1])))
    o, n = np.asarray(o), np.asarray(n).astype(np.int64)
    out["src_len"] = n
    out["src_out"] = np.where(np.arange(i["N"])[None, :] < n[:, None], o, 0)
    return out


def _exec_port(i):
    from tpu_zstd_torch.ops import decode

    return _exec_run(decode.execute_sequences_device, i, _t)


def _exec_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops import decode_jax

    return _exec_run(decode_jax.execute_sequences_device, i, jnp.asarray)


case("execute_sequences", "decode", _exec_inputs, _exec_port, _exec_ref)


def exec_hard_inputs(seed: int, N: int, W: int):
    """Valid sequence lists (lits, nlit, ll, ml, off, nseq, window) that are
    hard for K8/K9, one block per pattern: long overlapping matches at off
    1-3; a chain in which every match copies the match before it (depth
    ~N / 6, so every doubling round is needed); matches that read the
    window (W > 1; far matches into the output otherwise); no sequences,
    tail literals only; no sequences and no literals; output filling N
    exactly."""
    rng = np.random.default_rng(seed)
    blocks = []

    def run(draw, head=8):
        """Sequences from draw(po) -> (ll, ml, off or off(match start))
        until the output is near N; the first sequence puts `head` literals
        down and copies them."""
        ll, ml, off = [head], [head], [head]
        po = 2 * head
        while True:
            a, m, o = draw(po)
            if po + a + m > N - 64:
                return ll, ml, off, po
            ll.append(a)
            ml.append(m)
            off.append(o(po + a) if callable(o) else o)
            po += a + m

    ll, ml, off, _ = run(lambda po: (int(rng.integers(0, 4)), int(rng.integers(64, 4000)),
                                     int(rng.integers(1, 4))))
    blocks.append((ll, ml, off, sum(ll) + 9))
    ll, ml, off, _ = run(lambda po: (1, 5, 6))
    blocks.append((ll, ml, off, sum(ll) + 3))
    if W > 1:
        far = lambda ms: int(rng.integers(ms + 1, ms + W + 1))  # noqa: E731
    else:
        far = lambda ms: int(rng.integers(1, ms + 1))  # noqa: E731
    ll, ml, off, _ = run(lambda po: (int(rng.integers(0, 5)), int(rng.integers(3, 40)), far))
    blocks.append((ll, ml, off, sum(ll)))
    blocks.append(([], [], [], N // 3))
    blocks.append(([], [], [], 0))
    ll, ml, off, po = run(lambda po: (int(rng.integers(0, 20)), int(rng.integers(3, 60)),
                                      lambda ms: int(rng.integers(1, ms + W + 1))))
    blocks.append((ll, ml, off, sum(ll) + N - po))
    B, MS = len(blocks), max(len(x[0]) for x in blocks)
    arr = {k: np.zeros((B, MS), np.int32) for k in ("ll", "ml", "off")}
    nseq = np.zeros(B, np.int32)
    nlit = np.zeros(B, np.int32)
    for b, (ll, ml, off, nl) in enumerate(blocks):
        nseq[b], nlit[b] = len(ll), nl
        arr["ll"][b, : len(ll)], arr["ml"][b, : len(ll)], arr["off"][b, : len(ll)] = ll, ml, off
    lits = rng.integers(0, 256, (B, N), dtype=np.uint8)
    window = rng.integers(0, 256, (B, max(W, 1)), dtype=np.uint8)
    return lits, nlit, arr["ll"], arr["ml"], arr["off"], nseq, window


def stream_rows(lits: np.ndarray, nlit: np.ndarray, segc: int) -> np.ndarray:
    """Front-compacted literals as K6's 4-stream rows (B * 4, segc): stream
    s of block b holds literals s * seg .. (s + 1) * seg, seg = ceil(nlit / 4)."""
    B = lits.shape[0]
    seg = np.maximum((nlit + 3) // 4, 1)
    syms = np.zeros((4 * B, segc), np.uint8)
    for b in range(B):
        for s in range(4):
            part = lits[b, s * seg[b] : min((s + 1) * seg[b], nlit[b])]
            syms[4 * b + s, : len(part)] = part
    return syms


def _exec_hard_inputs():
    N = 8192
    cases = {f"hard_w{W}": exec_hard_inputs(W + 7, N, W) for W in (1, 4096)}
    lits, nlit = cases["hard_w1"][0], cases["hard_w1"][1]
    return {"cases": cases, "N": N, "syms": stream_rows(lits, nlit, N // 4 + 8),
            "src_case": "hard_w1"}


case("execute_sequences_hard", "decode", _exec_hard_inputs, _exec_port, _exec_ref)


def _format_inputs():
    """libzstd frames (levels 1, 3, 9, 19; with checksum, without content
    size) and the port's accel frames, for the host format copies."""
    import zstandard

    fr = _DEC_FRAMES["accel"]()
    base = make_corpus(20000)
    frames = [zstandard.ZstdCompressor(level=lv, write_checksum=lv == 9).compress(base)
              for lv in (1, 3, 9, 19)]
    cobj = zstandard.ZstdCompressor(level=3, write_content_size=False)
    frames.append(cobj.compress(base[:5000]))
    return {"frames": frames + fr["frames"]}


def _format_run(frame_mod, huf_mod, seq_mod, accel_mod, consts, frames):
    out = {}
    for k, f in enumerate(frames):
        meta, end = accel_mod.parse_accel_tail(f)
        f = f[:end]
        h = frame_mod.parse_frame_header(f)
        out[f"f{k}_hdr"] = [h.content_size or -1, h.window_size or -1, int(h.single_segment),
                            int(h.has_checksum), h.dict_id, h.header_size]
        pos = h.header_size
        bh = int.from_bytes(f[pos : pos + 3], "little")
        if (bh >> 1) & 3 != 2:
            continue
        body = f[pos + 3 : pos + 3 + (bh >> 3)]
        lit = frame_mod.decode_literals_section(body, None)
        out[f"f{k}_lits"] = np.frombuffer(lit.data, np.uint8)
        out[f"f{k}_lit_consumed"] = lit.consumed
        if body[0] & 3 == 2:  # Compressed literals: the weights header follows
            out[f"f{k}_huf"] = [lit.huff_table.table_log, lit.huff_table.symbol,
                                lit.huff_table.nb_bits]
            sf = (body[0] >> 2) & 3
            w, c = huf_mod.parse_weights(body[3 if sf <= 1 else sf + 2 :])
            dt = huf_mod.build_dtable(w)
            out[f"f{k}_weights"] = [w, c, dt.table_log, dt.symbol, dt.nb_bits]
        rest = body[lit.consumed :]
        nbseq, p = seq_mod.read_nbseq(rest)
        out[f"f{k}_nbseq"] = [nbseq, p]
        if nbseq == 0:
            continue
        modes = rest[p]
        p += 1
        for name, shift, norm, log, mx in (
                ("ll", 6, consts.LL_DEFAULT_NORM, consts.LL_DEFAULT_LOG, 35),
                ("of", 4, consts.OF_DEFAULT_NORM, consts.OF_DEFAULT_LOG, 31),
                ("ml", 2, consts.ML_DEFAULT_NORM, consts.ML_DEFAULT_LOG, 52)):
            dt, c = seq_mod.read_sequence_table(rest[p:], (modes >> shift) & 3, None, norm, log, mx)
            out[f"f{k}_{name}"] = [dt.table_log, c, dt.symbol, dt.nb_bits, dt.new_state]
            p += c
    dts = seq_mod.predefined_dtables() + (seq_mod.rle_dtable(17),)
    out["predefined"] = [np.concatenate([d.symbol, d.nb_bits, d.new_state]) for d in dts]
    return {k: np.concatenate([np.ravel(np.asarray(x, np.int64)) for x in v])
            if isinstance(v, list) else v for k, v in out.items()}


def _format_port(i):
    from tpu_zstd_torch import constants
    from tpu_zstd_torch.format import accel, frame, huffman, sequences

    return _format_run(frame, huffman, sequences, accel, constants, i["frames"])


def _format_ref(i):
    from tpu_zstd import constants
    from tpu_zstd.format import accel, frame, huffman, sequences

    return _format_run(frame, huffman, sequences, accel, constants, i["frames"])


case("format_decode", "decode", _format_inputs, _format_port, _format_ref)


# --- Slice 4: min_match 3, the wide sort key, LDM, the optimal parse, K10 ------------


def _opt_blocks(N, nblocks, seed):
    """Blocks of N bytes: corpus text, a seeded mix with repeats at short and
    long distances, a short block and one that repeats a 3-byte pattern."""
    rng = np.random.default_rng(seed)
    mix = rng.integers(0, 256, N, dtype=np.uint8)
    for _ in range(N // 100):
        ln = int(rng.integers(3, 300))
        src, dst = rng.integers(0, N - ln, 2)
        mix[dst:dst + ln] = mix[src:src + ln]
    datas = [make_corpus(N), mix.tobytes(), make_corpus(N // 3 + 7)[::-1],
             (b"xyz" + bytes(rng.integers(0, 256, 2, dtype=np.uint8))) * (N // 5)][:nblocks]
    blocks = np.zeros((len(datas), N), np.uint8)
    lengths = np.zeros(len(datas), np.int32)
    for k, d in enumerate(datas):
        blocks[k, : len(d)] = np.frombuffer(d[:N], np.uint8)
        lengths[k] = min(len(d), N)
    return {"blocks": blocks, "lengths": lengths}


def _fm_inputs(N, kw):
    def make():
        return {**_opt_blocks(N, 4, N), "kw": kw}

    return make


def _fm_port(i):
    from tpu_zstd_torch.ops import lz77

    out = lz77.find_matches(_t(i["blocks"]), _t(i["lengths"]), **i["kw"])
    return {f"out{k}": v for k, v in enumerate(out)}


def _fm_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import lz77_jax

    out = jax.jit(jax.vmap(lambda b, n: lz77_jax.find_matches(b, n, **i["kw"])))(
        jnp.asarray(i["blocks"]), jnp.asarray(i["lengths"]))
    return {f"out{k}": np.asarray(v) for k, v in enumerate(out)}


# min_match 3 with the near-offset band: 32 KB windows of 64 KB blocks with
# hash_log 17 (17 + 1 + 15 bits: the JAX package's two-key sort), and the
# search over the whole 32 KB block (mf_win_log 0; 17 + 1 + 15 bits).
case("find_matches_wide", "optimal",
     _fm_inputs(65536, dict(hash_log=17, depth=4, cap=16, mf_win_log=15, min_match=3,
                            two_band=True)), _fm_port, _fm_ref)
case("find_matches_whole", "optimal",
     _fm_inputs(32768, dict(hash_log=17, depth=4, cap=16, mf_win_log=0, min_match=3,
                            two_band=True)), _fm_port, _fm_ref)
# two_band with use_pallas_match on the CPU: the sort route's four outputs,
# as the JAX package returns them off its accelerator.
case("find_matches_fused_two_band", "optimal",
     _fm_inputs(32768, dict(hash_log=14, depth=4, cap=16, mf_win_log=10, min_match=4,
                            two_band=True, use_pallas_match=True)), _fm_port, _fm_ref)


def _fml_port(i):
    from tpu_zstd_torch.ops import lz77

    ml, off = lz77.find_matches_long(_t(i["blocks"]), _t(i["lengths"]))
    return {"ml": ml, "off": off}


def _fml_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import lz77_jax

    ml, off = jax.jit(jax.vmap(lz77_jax.find_matches_long))(
        jnp.asarray(i["blocks"]), jnp.asarray(i["lengths"]))
    return {"ml": np.asarray(ml), "off": np.asarray(off)}


case("find_matches_long", "optimal", _fm_inputs(32768, None), _fml_port, _fml_ref)


def _opt_inputs(mm, cap, per, nblocks):
    """Seeded DP rows: `per` segment rows a block share a literal price and
    a cost-bank row (16 segments a 16 KB block: the per-row bank case)."""
    def make():
        rng = np.random.default_rng(mm * 1000 + cap)
        S, seg = per * nblocks, 1024
        ml = np.where(rng.random((S, seg)) < 0.5, rng.integers(mm, 128, (S, seg)), 0)
        ml2 = np.where(rng.random((S, seg)) < 0.3, rng.integers(mm, 40, (S, seg)), 0)
        packed = (ml | rng.integers(0, 32, (S, seg)) << 7 | ml2 << 12
                  | rng.integers(0, 16, (S, seg)) << 19).astype(np.int32)
        lit = np.repeat(rng.integers(8, 177, nblocks), per).astype(np.int32)
        bank = np.repeat(rng.integers(0, 400, (nblocks, 128)), per, axis=0).astype(np.int32)
        return {"packed": packed, "lit": lit, "bank": bank, "mm": mm, "cap": cap}

    return make


def _opt_port(i):
    from tpu_zstd_torch.ops import opt

    out = {"steps": opt.opt_steps_plain(_t(i["packed"]), i["mm"], i["cap"], _t(i["lit"]),
                                        _t(i["bank"]))}
    if i["mm"] == 4:  # the default literal price and bank
        out["steps_default"] = opt.opt_steps_plain(_t(i["packed"][:8]), i["mm"], i["cap"])
    return out


def _opt_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops import pallas_opt

    out = {"steps": pallas_opt._opt_scan(jnp.asarray(i["packed"]), jnp.asarray(i["lit"]),
                                         jnp.asarray(i["bank"]), i["mm"], i["cap"])}
    if i["mm"] == 4:
        out["steps_default"] = pallas_opt.opt_steps(jnp.asarray(i["packed"][:8]), i["mm"],
                                                    i["cap"])
    return {k: np.asarray(v) for k, v in out.items()}


case("opt_steps_mm3_cap64", "optimal", _opt_inputs(3, 64, 8, 2), _opt_port, _opt_ref)
case("opt_steps_mm4_cap16", "optimal", _opt_inputs(4, 16, 16, 3), _opt_port, _opt_ref)


def opt_hard_row(kind: str, rng, seg: int, mm: int) -> tuple[np.ndarray, int, np.ndarray]:
    """One DP row of hard kind: its packed positions (seg,), literal price
    and cost-bank row (128,), int32.
    - every: every position offers every length in both bands (ml = ml2 = 127);
    - none: no position offers a length (ml, ml2 < mm);
    - zero: every price zero (bank, literal and offset codes 0): ties everywhere;
    - big: no matches and a literal price of 2^20, so the cost-to-go passes
      BIG = 2^28 after 256 positions and the BIG candidate wins;
    - big_sparse: the same with a match at one position in 20 (one band,
      capped at BIG, or both);
    - random: encoder-like lengths and prices;
    - near30, negative: random lengths with bank and literal prices drawn
      from [0, 2^30) and [-2^30, 2^30): sums wrap past 2^31;
    - edge: random lengths, every bank entry and the literal price 4095 (the
      largest price of the kernel's fast path);
    - full: every int32 bit pattern, for the positions, bank and literal."""
    def draw(p_ml, p_ml2):
        ml = np.where(rng.random(seg) < p_ml, rng.integers(mm, 128, seg), 0)
        ml2 = np.where(rng.random(seg) < p_ml2, rng.integers(mm, 40, seg), 0)
        return ml, ml2

    ofc, ofc2 = rng.integers(0, 32, seg), rng.integers(0, 16, seg)
    bank, lit = rng.integers(0, 400, 128), int(rng.integers(8, 177))
    if kind == "every":
        ml = ml2 = np.full(seg, 127)
    elif kind == "none":
        ml, ml2 = rng.integers(0, mm, seg), rng.integers(0, mm, seg)
    elif kind == "zero":
        (ml, ml2), ofc, ofc2 = draw(0.5, 0.3), 0, 0
        bank, lit = np.zeros(128, np.int64), 0
    elif kind == "big":
        ml = ml2 = ofc = ofc2 = 0
        lit = 1 << 20
    elif kind == "big_sparse":
        (ml, ml2), lit = draw(0.05, 0.05), 1 << 20
    else:
        ml, ml2 = draw(0.5, 0.3)
    if kind == "near30":
        bank, lit = rng.integers(0, 1 << 30, 128), int(rng.integers(0, 1 << 30))
    elif kind == "negative":
        bank = rng.integers(-(1 << 30), 1 << 30, 128)
        lit = int(rng.integers(-(1 << 30), 1 << 30))
    elif kind == "edge":
        bank, lit = np.full(128, 4095), 4095
    packed = (ml | ofc << 7 | ml2 << 12 | ofc2 << 19) + np.zeros(seg, np.int64)
    if kind == "full":
        packed = rng.integers(INT32_MIN, INT32_MAX, seg, endpoint=True)
        bank = rng.integers(INT32_MIN, INT32_MAX, 128, endpoint=True)
        lit = int(rng.integers(INT32_MIN, INT32_MAX, endpoint=True))
    return packed.astype(np.int32), lit, bank.astype(np.int32)


# K10's hard calls: (rows' kinds, cycled over S rows, S, seg, mm, cap). Each
# row has its own bank and literal price, so banks differ between the rows of
# one CTA; S 130 is not a multiple of 128; seg 1, 33, 300, 1000 and 1024;
# cap 127 at mm 32 and mm = cap.
OPT_HARD = (
    (("every", "none", "zero", "big", "random"), 130, 1024, 3, 64),
    (("near30", "negative", "full", "big_sparse"), 130, 1024, 3, 64),
    (("every", "full", "big", "zero"), 5, 1, 3, 64),
    (("every", "negative", "big_sparse", "random"), 5, 33, 3, 64),
    (("random", "near30", "every", "big_sparse"), 5, 1000, 3, 64),
    (("every", "full", "zero", "big_sparse", "none"), 7, 300, 32, 127),
    (("every", "negative", "random", "big_sparse", "big"), 7, 300, 16, 16),
)


# Every kind of opt_hard_row, and the hard calls held on the card beside
# OPT_HARD: (S, seg, mm, cap), each of S rows cycling over OPT_KINDS, at the
# main path's width (S not a multiple of a CTA's rows), at seg 1, 33, 1000
# and 4096, and at cap 127 / mm 32 and mm = cap.
OPT_KINDS = ("every", "none", "zero", "big", "big_sparse", "random", "near30", "negative",
             "full", "edge")
OPT_HARD_WIDE = ((16384 + 13, 1024, 3, 64), (1000, 1, 3, 64), (1000, 33, 3, 64),
                 (1000, 1000, 3, 64), (300, 4096, 3, 64), (2000, 1024, 32, 127),
                 (2000, 1024, 16, 16))
# The kinds whose prices all lie in [0, 2^12), and calls of them alone, which
# the kernel walks on its fast path only (seg <= 1024): seg 1, 33, 300, 1000
# and 1024, mm = cap and cap 127 at mm 32. The kinds cycle over each warp's
# 8 rows, so every warp holds ties, rows with no match and the edge row.
OPT_FAST_KINDS = ("every", "none", "zero", "random", "edge")
OPT_FAST_WIDE = ((1000, 1, 3, 64), (1000, 33, 3, 64), (1000, 300, 3, 64), (1000, 1000, 3, 64),
                 (16384 + 13, 1024, 3, 64), (2000, 1024, 16, 16), (2000, 1024, 32, 127))


def opt_hard_call(kinds, S: int, seg: int, mm: int, cap: int, rng) -> dict:
    """One K10 call of S rows cycling over `kinds` (opt_hard_row): packed
    (S, seg), lit (S,), bank (S, 128), mm and cap."""
    rows = [opt_hard_row(kinds[r % len(kinds)], rng, seg, mm) for r in range(S)]
    return {"packed": np.stack([r[0] for r in rows]),
            "lit": np.array([r[1] for r in rows], np.int32),
            "bank": np.stack([r[2] for r in rows]), "mm": mm, "cap": cap}


def opt_hard_inputs(seed: int = 41) -> list[dict]:
    """K10's hard calls (OPT_HARD)."""
    rng = np.random.default_rng(seed)
    return [opt_hard_call(*c, rng) for c in OPT_HARD]


def opt_seeded_call(mm: int, cap: int, B: int, per: int, rng) -> dict:
    """B * per seeded segment rows of 1024 with one bank row and literal
    price per block of `per` rows (128 segments of a 128 KB block; 16 of a
    16 KB block)."""
    S = B * per
    ml = np.where(rng.random((S, 1024)) < 0.5, rng.integers(mm, 128, (S, 1024)), 0)
    ml2 = np.where(rng.random((S, 1024)) < 0.3, rng.integers(mm, 40, (S, 1024)), 0)
    packed = (ml | rng.integers(0, 32, (S, 1024)) << 7 | ml2 << 12
              | rng.integers(0, 16, (S, 1024)) << 19)
    return {"packed": packed.astype(np.int32), "mm": mm, "cap": cap,
            "lit": np.repeat(rng.integers(8, 177, B), per).astype(np.int32),
            "bank": np.repeat(rng.integers(0, 400, (B, 128)), per, axis=0).astype(np.int32)}


def opt_card_calls(B: int = 128, seed: int = 7) -> list[tuple[str, dict]]:
    """K10's calls held against its plain version on the card, labelled:
    the hard calls (OPT_HARD, OPT_HARD_WIDE, and OPT_FAST_WIDE labelled
    "fast ..."), seeded rows at mm 3 / cap 64 and mm 4 / cap 16 (B blocks of
    128 and of 16 rows) and B * 128 rows that offer every length ("every
    length")."""
    rng = np.random.default_rng(seed)

    def label(kind, c):
        return f"{kind} {c['packed'].shape} mm {c['mm']} cap {c['cap']}"

    calls = [(label("hard", c), c) for c in opt_hard_inputs()]
    calls += [(label("hard wide", c), c)
              for c in (opt_hard_call(OPT_KINDS, *w, rng) for w in OPT_HARD_WIDE)]
    calls += [(label("fast", c), c)
              for c in (opt_hard_call(OPT_FAST_KINDS, *w, rng) for w in OPT_FAST_WIDE)]
    return calls + [("seeded mm 3 cap 64", opt_seeded_call(3, 64, B, 128, rng)),
                    ("seeded mm 4 cap 16", opt_seeded_call(4, 16, B, 16, rng)),
                    ("every length", opt_hard_call(("every",), B * 128, 1024, 3, 64, rng))]


case("opt_hard", "optimal", lambda: {"calls": opt_hard_inputs()},
     lambda i: {f"c{k}": _opt_port(c)["steps"] for k, c in enumerate(i["calls"])},
     lambda i: {f"c{k}": _opt_ref(c)["steps"] for k, c in enumerate(i["calls"])})

OPT_PARSE_N = 16384
OPT_PARSE_KW = dict(hash_log=13, depth=6, cap=16, min_match=3, lazy=True, seg_log=10,
                    of_gate=(8, 12), mf_win_log=12, optimal=True, ldm=True)


def _opt_parse_inputs(max_seqs):
    def make():
        return {**_opt_blocks(OPT_PARSE_N, 4, 19), "max_seqs": max_seqs}

    return make


def _opt_parse_digest(seqs, N):
    nseq = np.asarray(seqs.nseq).astype(np.int64)
    nlit = np.asarray(seqs.nlit).astype(np.int64)
    out = {"nseq": nseq, "nlit": nlit,
           "lits": np.where(np.arange(N) < nlit[:, None], np.asarray(seqs.lits), 0)}
    for f in ("ll", "ml", "ob", "off", "starts"):
        a = np.asarray(getattr(seqs, f))
        out[f] = np.where(np.arange(a.shape[1]) < nseq[:, None], a, 0)
    return out


def _opt_parse_port(i):
    from tpu_zstd_torch.ops import lz77

    seqs = lz77.parse_block(_t(i["blocks"]), _t(i["lengths"]), max_seqs=i["max_seqs"],
                            **OPT_PARSE_KW)
    return _opt_parse_digest(seqs, OPT_PARSE_N)


def _opt_parse_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import lz77_jax

    seqs = jax.jit(jax.vmap(lambda b, n: lz77_jax.parse_block(
        b, n, max_seqs=i["max_seqs"], **OPT_PARSE_KW)))(
        jnp.asarray(i["blocks"]), jnp.asarray(i["lengths"]))
    return _opt_parse_digest(jax.device_get(seqs), OPT_PARSE_N)


# The optimal parse with LDM (4 KB windows of 16 KB blocks), and again with a
# sequence capacity that some blocks overflow (the min_match-3 poison).
case("parse_optimal", "optimal", _opt_parse_inputs(OPT_PARSE_N // 4), _opt_parse_port,
     _opt_parse_ref)
case("parse_optimal_overflow", "optimal", _opt_parse_inputs(600), _opt_parse_port,
     _opt_parse_ref)


def _opt_level_cfg(config, level):
    """A level's CompressionConfig at 16 KB blocks with the search trimmed
    (hash_log 13, depth 6, cap 16) so the JAX package compiles in seconds."""
    cfg = config.CompressionConfig.from_level(level)
    return dataclasses.replace(cfg, block_size=16384, hash_log=13, search_depth=6,
                               compare_cap=16)


def _opt_items_port(i):
    from tpu_zstd_torch.api import config, manager

    frames = manager.compress_items(i["items"], _opt_level_cfg(config, i["level"]), device="cpu")
    return {f"frame{k}": f for k, f in enumerate(frames)}


def _opt_items_ref(i):
    from tpu_zstd.api import config, manager

    frames = manager.compress_items_tpu(i["items"], _opt_level_cfg(config, i["level"]))
    return {f"frame{k}": f for k, f in enumerate(frames)}


for _level in (7, 12, 19, 22):
    case(f"items_level{_level}", "optimal", _items_inputs(_level, 0), _opt_items_port,
         _opt_items_ref)


def _whole_frame_port(i):
    from tpu_zstd_torch.ops import pipeline

    return {"frame": pipeline.compress(i["data"], pipeline.PipelineConfig(**WHOLE_KW),
                                       device="cpu")}


def _whole_frame_ref(i):
    from tpu_zstd.ops import pipeline

    return {"frame": pipeline.compress(i["data"], pipeline.PipelineConfig(**WHOLE_KW))}


# The search and the extraction over the whole block (mf_win_log 0: one
# compaction sort a block).
WHOLE_KW = dict(block_size=16384, hash_log=13, depth=4, cap=8, mf_win_log=0)
case("frame_whole_block", "optimal", lambda: {"data": _mix(77, 2 * 16384)}, _whole_frame_port,
     _whole_frame_ref)


# --- Slice 5: the fused match route (K13), the row sort (K12), the deposit (K11) ---


def _sort_inputs(R, W, P):
    """As tests/test_pallas_sort.py builds them, with keys shifted to span
    negative values (the kernels compare signed int32)."""
    def make():
        rng = np.random.default_rng(W + P)
        key = rng.permuted(np.tile(np.arange(W, dtype=np.int32), (R, 1)), axis=1)
        key = (key * 3 - W).astype(np.int32)
        pays = [rng.integers(0, 1 << 30, (R, W), dtype=np.int32) for _ in range(P)]
        return {"ops": [key] + pays}

    return make


def _sort_port(i):
    from tpu_zstd_torch.ops import sort

    return {f"op{k}": v for k, v in enumerate(sort.sort_rows(*(_t(x) for x in i["ops"])))}


def _sort_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops.pallas_sort import sort_rows

    return {f"op{k}": np.asarray(v)
            for k, v in enumerate(sort_rows(*(jnp.asarray(x) for x in i["ops"])))}


for _R, _W, _P in ((2, 1024, 0), (2, 2048, 1), (1, 8192, 3)):
    case(f"sort_rows_{_W}", "kernels", _sort_inputs(_R, _W, _P), _sort_port, _sort_ref)


def _match_inputs(depth, nwords):
    """As tests/test_pallas_sort.py builds match_windows inputs: two 1024-
    position windows of low-entropy bytes (hashes collide as in text),
    hash_log 12, the last 3 positions dead."""
    def make():
        rng = np.random.default_rng(100 * depth + nwords)
        R, W, hash_log, plog = 2, 1024, 12, 10
        sentinel = 1 << hash_log
        data = rng.integers(0, 7, (R, W + 64), dtype=np.uint8)
        b = data.astype(np.uint32)
        w = b[:, :-3] | (b[:, 1:-2] << 8) | (b[:, 2:-1] << 16) | (b[:, 3:] << 24)
        h = ((w.astype(np.uint64) * 2654435761) % (1 << 32) >> (32 - hash_log)).astype(np.int32)
        words = [w[:, 4 * k : 4 * k + W].view(np.int32).copy() for k in range(nwords)]
        lpos = np.tile(np.arange(W, dtype=np.int32), (R, 1))
        hw = np.where(lpos < W - 3, h[:, :W], sentinel)
        return {"key": ((hw << plog) | lpos).astype(np.int32), "words": words, "depth": depth,
                "sentinel": sentinel}

    return make


def _match_port(i):
    from tpu_zstd_torch.ops import match

    ml, off = match.match_windows(_t(i["key"]), [_t(w) for w in i["words"]], i["depth"],
                                  i["sentinel"])
    return {"ml": ml, "off": off}


def _match_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops.pallas_match import match_windows

    ml, off = match_windows(jnp.asarray(i["key"]), [jnp.asarray(w) for w in i["words"]],
                            i["depth"], i["sentinel"])
    return {"ml": np.asarray(ml), "off": np.asarray(off)}


for _d, _nw in ((2, 2), (8, 8)):
    case(f"match_windows_d{_d}_w{_nw}", "kernels", _match_inputs(_d, _nw), _match_port,
         _match_ref)

def lowent_windows(rng, R: int, W: int, nw: int, hl: int):
    """K13's operands on low-entropy windows (bytes 0-6, so hashes collide as
    in text): key (R, W) = hash << log2(W) | pos with the last 3 positions
    dead (hash 1 << hl), and the nw suffix words (nw, R, W), int32."""
    byt = rng.integers(0, 7, (R, W + 4 * nw + 4), dtype=np.uint8).astype(np.uint32)
    w = byt[:, :-3] | (byt[:, 1:-2] << 8) | (byt[:, 2:-1] << 16) | (byt[:, 3:] << 24)
    h = ((w.astype(np.uint64) * 2654435761) % (1 << 32) >> (32 - hl)).astype(np.int64)
    lpos = np.arange(W)
    key = (np.where(lpos < W - 3, h[:, :W], 1 << hl) << (W.bit_length() - 1)) | lpos
    words = np.stack([w[:, 4 * k: 4 * k + W].view(np.int32) for k in range(nw)])
    return key.astype(np.int32), words


INT32_MIN, INT32_MAX = -(1 << 31), (1 << 31) - 1


def sort_hard_row(kind: str, W: int, rng) -> np.ndarray:
    """One row of W unique int32 keys: `values` is "extremes" (W/2 keys at and
    next to INT32_MIN, W/2 at and next to INT32_MAX) or "spread" (3k - W);
    `order` is sorted, reversed, organ (the even ranks ascending, then the odd
    ranks descending) or random. kind = "<values>_<order>"."""
    values, order = kind.split("_")
    h = np.arange(W // 2, dtype=np.int64)
    v = (np.concatenate([INT32_MIN + h, INT32_MAX - h[::-1]]) if values == "extremes"
         else np.arange(W, dtype=np.int64) * 3 - W)
    v = np.sort(v)
    if order == "reversed":
        v = v[::-1]
    elif order == "organ":
        v = np.concatenate([v[0::2], v[1::2][::-1]])
    elif order == "random":
        v = rng.permutation(v)
    return v.astype(np.int32)


# K12's hard calls: (rows' kinds, payloads, width of the golden case). Rows
# already sorted, reversed and organ-pipe; keys at and next to INT32_MIN and
# INT32_MAX; one row and three rows; 0 and 3 payloads.
SORT_HARD = (
    (("extremes_sorted",), 0, 1024),
    (("spread_sorted", "spread_reversed", "spread_organ"), 3, 2048),
    (("extremes_organ", "extremes_reversed", "extremes_random"), 3, 1024),
    (("extremes_reversed",), 0, 2048),
)


def sort_hard_ops(W: int, kinds, P: int, seed: int = 0) -> list[np.ndarray]:
    """The key rows of `kinds` at width W and P payloads of full-range int32."""
    rng = np.random.default_rng(seed)
    key = np.stack([sort_hard_row(k, W, rng) for k in kinds])
    return [key] + [rng.integers(INT32_MIN, INT32_MAX, key.shape, dtype=np.int64,
                                 endpoint=True).astype(np.int32) for _ in range(P)]


def _sort_hard_inputs():
    return {"calls": [sort_hard_ops(W, kinds, P, k) for k, (kinds, P, W) in enumerate(SORT_HARD)]}


def _sort_hard_port(i):
    return {f"c{c}_{k}": v for c, ops in enumerate(i["calls"])
            for k, v in _sort_port({"ops": ops}).items()}


def _sort_hard_ref(i):
    return {f"c{c}_{k}": v for c, ops in enumerate(i["calls"])
            for k, v in _sort_ref({"ops": ops}).items()}


case("sort_rows_hard", "kernels", _sort_hard_inputs, _sort_hard_port, _sort_hard_ref)


def match_hard_window(kind: str, W: int, nwords: int, rng):
    """One window's key row and its nwords suffix-word rows, and the
    sentinel, for hard kind:
    - one_hash: every live position has one hash, so each compare runs to
      the full depth (the words are low-entropy, so most differ);
    - sentinel: every position dead;
    - alternating: two hashes, alternating position by position;
    - equal_words: one hash and every word equal, so each match spans all
      words;
    - extremes: hashes at the ends of the int32 key range (keys at and next
      to INT32_MIN; the sentinel at the top of the range);
    - random: hashes from a small set (collisions as in text).
    The last 3 positions are dead in every kind."""
    plog = W.bit_length() - 1
    sentinel = (1 << (31 - plog)) - 1
    pos = np.arange(W, dtype=np.int64)
    if kind == "one_hash":
        h = np.full(W, 5)
    elif kind == "sentinel":
        h = np.full(W, sentinel)
    elif kind == "alternating":
        h = np.where(pos & 1, 9, 1 << 12)
    elif kind == "equal_words":
        h = np.full(W, sentinel - 1)
    elif kind == "extremes":
        h = rng.choice(np.array([-(1 << (31 - plog)), 1 - (1 << (31 - plog)), -1, 0,
                                 sentinel - 1]), W)
        h[0] = -(1 << (31 - plog))
    else:
        h = rng.integers(0, 6, W)
    h = np.where(pos < W - 3, h, sentinel)
    key = ((h << plog) | pos).astype(np.int64)
    key = np.where(key >= 1 << 31, key - (1 << 32), key).astype(np.int32)
    if kind == "equal_words" or nwords == 0:
        words = np.full((nwords, W), 0x3A3A3A3A, np.int32)
    else:
        byt = rng.integers(0, 3, W + 4 * nwords + 4, dtype=np.uint8).astype(np.uint32)
        w = byt[:-3] | (byt[1:-2] << 8) | (byt[2:-1] << 16) | (byt[3:] << 24)
        words = np.stack([w[4 * k: 4 * k + W].view(np.int32) for k in range(nwords)]
                         ).reshape(nwords, W)
    return key, words, sentinel


# K13's hard calls: (windows' kinds, depth, nwords, width of the golden
# case). Each call's windows are its rows; depth 0 and 127, nwords 0, 1 and
# 16.
MATCH_HARD = (
    (("one_hash", "alternating", "extremes"), 127, 1, 1024),
    (("equal_words", "sentinel", "random"), 8, 16, 1024),
    (("one_hash",), 0, 16, 2048),
    (("alternating", "random"), 5, 0, 2048),
)


def match_hard_inputs(W: int, kinds, depth: int, nwords: int, seed: int = 0) -> dict:
    """K13's operands for one hard call at window width W: the key (R, W),
    the words (nwords, R, W), depth and the sentinel."""
    rng = np.random.default_rng(seed)
    rows = [match_hard_window(k, W, nwords, rng) for k in kinds]
    return {"key": np.stack([r[0] for r in rows]),
            "words": np.stack([r[1] for r in rows], axis=1).reshape(nwords, len(rows), W),
            "depth": depth, "sentinel": rows[0][2]}


def _match_hard_inputs():
    return {"calls": [match_hard_inputs(W, kinds, d, nw, k)
                      for k, (kinds, d, nw, W) in enumerate(MATCH_HARD)]}


def _match_hard_call(i, fn):
    return {f"c{c}_{k}": v for c, m in enumerate(i["calls"])
            for k, v in fn({**m, "words": list(m["words"])}).items()}


case("match_windows_hard", "kernels", _match_hard_inputs,
     lambda i: _match_hard_call(i, _match_port), lambda i: _match_hard_call(i, _match_ref))


def _deposit_pallas_inputs(kind):
    """Seeds 0-2 as tests/test_pallas_deposit.py builds them (3 rows of 1024
    fields, offsets the exclusive cumsum), its sparse case (two live fields),
    and an edge case: 32-bit fields (full u32 values) running past the
    padded width, so the last chunks' windows sit at the clamped row and
    their trailing parts are dropped."""
    def make():
        if kind == "sparse":
            lens = np.zeros((1, 256), np.int32)
            lens[0, 5], lens[0, 200] = 13, 32
            vals = np.full((1, 256), 0xDEADBEEF, np.int64)
            num_words = 200
        elif kind == "edge":
            rng = np.random.default_rng(7)
            lens = np.full((2, 1152), 32, np.int32)
            lens[1] = rng.integers(0, 33, 1152)
            vals = rng.integers(0, 1 << 32, (2, 1152), dtype=np.uint64).astype(np.int64)
            num_words = 400
        else:
            rng = np.random.default_rng(kind)
            maxlen = (20, 32, 6)[kind]
            lens = rng.integers(0, maxlen + 1, (3, 1024)).astype(np.int32)
            vals = rng.integers(0, 1 << 31, (3, 1024)).astype(np.int64)
            num_words = None
        offs = (np.cumsum(lens, axis=1) - lens).astype(np.int32)
        if num_words is None:
            num_words = int(offs.max() // 32) + 64
        return {"vals": vals, "lens": lens, "offs": offs, "num_words": num_words}

    return make


def _deposit_pallas_port(i):
    from tpu_zstd_torch.ops import deposit

    return {"words": deposit.deposit_bits_pallas(_t(i["vals"]), _t(i["lens"]), _t(i["offs"]),
                                                 i["num_words"])}


def _deposit_pallas_ref(i):
    import jax.numpy as jnp

    from tpu_zstd.ops.pallas_deposit import deposit_bits_pallas

    return {"words": np.asarray(deposit_bits_pallas(
        jnp.asarray(i["vals"].astype(np.uint32)), jnp.asarray(i["lens"]), jnp.asarray(i["offs"]),
        i["num_words"], True))}


for _kind in (0, 1, 2, "sparse", "edge"):
    case(f"deposit_pallas_{_kind}", "kernels", _deposit_pallas_inputs(_kind),
         _deposit_pallas_port, _deposit_pallas_ref)

FUSED_N = 2048
FUSED_KW = dict(hash_log=12, depth=3, cap=16, mf_win_log=10)


def _fused_inputs():
    """Two 2 KB blocks (1024-position windows): corpus text, and a seeded
    mix with repeats whose last 777 bytes are outside the payload."""
    rng = np.random.default_rng(0xF05ED)
    mix = rng.integers(0, 256, FUSED_N, dtype=np.uint8)
    for _ in range(30):
        ln = int(rng.integers(4, 200))
        src, dst = rng.integers(0, FUSED_N - ln, 2)
        mix[dst:dst + ln] = mix[src:src + ln]
    blocks = np.stack([np.frombuffer(make_corpus(FUSED_N), np.uint8), mix])
    return {"blocks": blocks, "lengths": np.array([FUSED_N, FUSED_N - 777], np.int32)}


def _fused_port(i):
    from tpu_zstd_torch.ops import lz77

    b, n = _t(i["blocks"]), _t(i["lengths"])
    ml, off = lz77.find_matches(b, n, use_pallas_match=True, **FUSED_KW)
    fml, foff = lz77.find_matches_fused(b, n, **FUSED_KW)
    return {"ml": ml, "off": off, "fused_ml": fml, "fused_off": foff}


def _fused_ref(i):
    """find_matches(use_pallas_match=True) as the JAX package runs it on the
    CPU (its sort route), and its fused route (tpu_zstd/ops/lz77_jax.py,
    the use_pallas_match branch of find_matches) with the Pallas kernel in
    interpret mode."""
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import lz77_jax
    from tpu_zstd.ops.pallas_match import match_windows

    blocks, lengths = jnp.asarray(i["blocks"]), jnp.asarray(i["lengths"])
    ml, off = jax.jit(jax.vmap(lambda b, n: lz77_jax.find_matches(
        b, n, use_pallas_match=True, **FUSED_KW)))(blocks, lengths)
    kw = FUSED_KW
    W, N = 1 << kw["mf_win_log"], FUSED_N
    sentinel = 1 << kw["hash_log"]
    keys, wws = [], []
    for b, n in zip(blocks, lengths):
        pos = jnp.arange(N, dtype=jnp.int32)
        w, h = lz77_jax._hash_words(b, kw["hash_log"], 4)
        live = pos < n - 3
        hw = jnp.where(live, h, sentinel).reshape(N // W, W)
        keys.append((hw << kw["mf_win_log"]) | jnp.arange(W, dtype=jnp.int32))
        wws.append([jnp.roll(w, -4 * k).astype(jnp.int32).reshape(N // W, W)
                    for k in range(kw["cap"] // 4)])
    fml, foff = match_windows(jnp.concatenate(keys),
                              [jnp.concatenate([x[k] for x in wws]) for k in range(len(wws[0]))],
                              kw["depth"], sentinel)
    pos = np.arange(N)
    fml = np.minimum(np.asarray(fml).reshape(-1, N),
                     np.maximum(np.asarray(i["lengths"])[:, None] - pos, 0))
    return {"ml": np.asarray(ml), "off": np.asarray(off), "fused_ml": fml,
            "fused_off": np.asarray(foff).reshape(-1, N)}


case("find_matches_fused", "parse", _fused_inputs, _fused_port, _fused_ref)


# --- The public surface: host codec, decompress_batch_tpu, streaming, managers ------
# Group "api" (tests/test_torch_api.py re-checks it against the JAX package).
# Errors are compared as "ExceptionClass: message" bytes; decoded outputs as
# uint8 arrays (byte-string outputs are frames, which the golden test decodes
# with libzstd).


def _u8(b: bytes) -> np.ndarray:
    return np.frombuffer(bytes(b), np.uint8)


def _err(fn) -> np.ndarray:
    """What fn() raises, as "ExceptionClass: message" bytes; empty when it
    returns."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the class is part of the digest
        return _u8(f"{type(e).__name__}: {e}".encode())
    return _u8(b"")


def _skippable(payload: bytes) -> bytes:
    return (0x184D2A50).to_bytes(4, "little") + len(payload).to_bytes(4, "little") + payload


def rehead_wide(frame: bytes, window_log: int = 23) -> bytes:
    """A frame with its header rewritten to declare a 2^window_log window
    and no content size (its checksum flag kept, no dictionary ID): the
    blocks are unchanged, so the frame stays valid."""
    fhd = frame[4]
    single, did, fcs = (fhd >> 5) & 1, fhd & 3, fhd >> 6
    size = 5 + (0 if single else 1) + (0, 1, 2, 4)[did] + ((1 if single else 0), 2, 4, 8)[fcs]
    return frame[:4] + bytes([fhd & 4, (window_log - 10) << 3]) + frame[size:]


def _flip_last(frame: bytes) -> bytes:
    return frame[:-1] + bytes([frame[-1] ^ 0x5A])


def _reserved_first_block(frame: bytes, header_size: int) -> bytes:
    """The frame with its first block's type set to 3 (reserved)."""
    bh = int.from_bytes(frame[header_size : header_size + 3], "little") | (3 << 1)
    return frame[:header_size] + bh.to_bytes(3, "little") + frame[header_size + 3 :]


# The host codec's parameters: the first two are what Manager._compress_cpu
# builds at levels 1 and 3; then lazy at hash_log 12 with 8 KB blocks,
# min_match 3 with 16 KB blocks and a checksum, no Huffman, and a window_log.
HOST_PARAMS = (
    dict(level=1, hash_log=15, search_depth=3, min_match=4, lazy=False),
    dict(level=3, hash_log=16, search_depth=8, min_match=4, lazy=True),
    dict(hash_log=12, search_depth=4, lazy=True, block_size=8192),
    dict(hash_log=16, min_match=3, block_size=16384, checksum=True),
    dict(min_match=4, enable_huffman=False, block_size=8192),
    dict(hash_log=14, search_depth=2, window_log=20, checksum=True, block_size=16384),
)


def _host_compress_inputs():
    data = _mix(43, 24000)
    return {"items": [data] * len(HOST_PARAMS), "params": HOST_PARAMS}


def _host_compress_run(frame_mod, i):
    return {f"frame{k}": frame_mod.compress(d, frame_mod.CompressParams(**p))
            for k, (d, p) in enumerate(zip(i["items"], i["params"]))}


def _host_compress_port(i):
    from tpu_zstd_torch.format import frame

    return _host_compress_run(frame, i)


def _host_compress_ref(i):
    from tpu_zstd.format import frame

    return _host_compress_run(frame, i)


case("host_compress", "api", _host_compress_inputs, _host_compress_port, _host_compress_ref)


def _host_decode_inputs():
    """Frames of the JAX package (recorded multi-block frames at levels 3
    and 19, one with its decode-acceleration tail), of the port (its host
    codec with a checksum, and compress_items' frames without metadata) and
    of libzstd (levels 1-19, and the recorded multi-block frames), one
    stream of back-to-back frames with skippable ones, and four corrupt
    frames."""
    @functools.lru_cache(maxsize=None)
    def make():
        from tpu_zstd_torch.format import frame

        mb = multiblock_frames()
        data = _mix(42, 20000)
        host = frame.compress(data, frame.CompressParams(block_size=8192, checksum=True))
        plain, zstd = _DEC_FRAMES["plain"](), _DEC_FRAMES["zstd"]()
        frames = [mb[0], *mb[3:], host, *plain["frames"], *zstd["frames"]]
        stream = _skippable(b"abc") + mb[1] + _skippable(b"") + plain["frames"][0] + mb[6]
        hs = frame.parse_frame_header(mb[0]).header_size
        corrupt = [mb[0][: len(mb[0]) // 2], b"\x28\xb5\x2f\xfe" + mb[0][4:],
                   _reserved_first_block(mb[0], hs), _flip_last(host)]
        return {"frames": frames, "stream": stream, "corrupt": corrupt}

    return make


def _host_decode_run(decompress, i):
    return {**{f"out{k}": _u8(decompress(f)) for k, f in enumerate(i["frames"])},
            "stream": _u8(decompress(i["stream"])),
            **{f"err{k}": _err(lambda f=f: decompress(f)) for k, f in enumerate(i["corrupt"])}}


def _host_decode_port(i):
    from tpu_zstd_torch.format import frame

    return _host_decode_run(frame.decompress, i)


def _host_decode_ref(i):
    from tpu_zstd.format import frame

    return _host_decode_run(frame.decompress, i)


case("host_decode", "api", _host_decode_inputs(), _host_decode_port, _host_decode_ref)

DBT_N = 16384  # decompress_batch_tpu cases: max_block


def decompress_batch_tpu_inputs():
    """One batch for `decompress_batch_tpu`, all of it made without libzstd:
    the port's level-3 frames at 16 KB blocks (2 blocks behind a skippable
    frame; 2 blocks with a checksum), libzstd's recorded level-19 frame of 4
    blocks whose first sequences use repeat offsets of the block before, and
    the same frame re-headed to declare an 8 MiB window and no content size
    (the prepared plan refuses it); then a batch with a truncated frame."""
    @functools.lru_cache(maxsize=None)
    def make():
        from tpu_zstd_torch.api import config, manager

        mb, specs = multiblock_frames(), multiblock_specs()
        cfg = dataclasses.replace(config.CompressionConfig.from_level(3), block_size=DBT_N)
        noise = np.random.default_rng(47).integers(0, 256, 10000, dtype=np.uint8).tobytes()
        pay = [noise + make_corpus(8000), b"\x42" * 9000 + make_corpus(9000)[::-1]]
        port, = manager.compress_items(pay[:1], cfg, device="cpu")
        port_ck, = manager.compress_items(pay[1:], dataclasses.replace(
            cfg, checksum=config.ChecksumPolicy.COMPUTE), device="cpu")
        frames = [_skippable(b"xyz") + port, port_ck, mb[5], rehead_wide(mb[5])]
        payloads = [*pay, specs[5]["payload"], specs[5]["payload"]]
        return {"frames": frames, "payloads": payloads,
                "corrupt": [frames[2], port_ck[: len(port_ck) // 2]]}

    return make


def _dbt_digest(outs, payloads, refused, err):
    return {**{f"out{k}": _u8(o) for k, o in enumerate(outs)},
            "equal_input": [o == p for o, p in zip(outs, payloads)],
            "plan_refuses_wide": refused, "corrupt_err": err}


def _dbt_port(i):
    from tpu_zstd_torch.api import decompress

    def run(frames):
        return decompress.decompress_batch_tpu(frames, DBT_N, device="cpu")

    return _dbt_digest(run(i["frames"]), i["payloads"], _mb_refused(
        lambda f: decompress.prepare_decompress_batch(f, DBT_N, device="cpu"), i["frames"][3:4]),
        _err(lambda: run(i["corrupt"])))


def _dbt_ref(i):
    from tpu_zstd.api import decompress

    def run(frames):
        return decompress.decompress_batch_tpu(frames, DBT_N)

    return _dbt_digest(run(i["frames"]), i["payloads"], _mb_refused(
        lambda f: decompress.prepare_decompress_batch(f, DBT_N), i["frames"][3:4]),
        _err(lambda: run(i["corrupt"])))


case("decompress_batch_tpu", "api", decompress_batch_tpu_inputs(), _dbt_port, _dbt_ref)

STREAM_CHUNKS = (1, 7, 4096)


def _streaming_inputs():
    """Back-to-back frames with skippable ones (the port's host frame with a
    checksum at 4 KB blocks, libzstd's level-19 multi-block frame, the JAX
    package's 4-block checksummed frame), the same host frame with a bad
    checksum, and a stream cut mid-frame."""
    from tpu_zstd_torch.format import frame

    mb = multiblock_frames()
    host = frame.compress(_mix(45, 12000), frame.CompressParams(block_size=4096, checksum=True))
    stream = _skippable(b"abc") + host + mb[5] + _skippable(b"") + mb[0]
    return {"stream": stream, "bad": _flip_last(host), "cut": mb[0][: len(mb[0]) // 2]}


def _streaming_run(make, i):
    out = {}
    for n in STREAM_CHUNKS:
        dec = make()
        s = i["stream"]
        got = b"".join(dec.decompress_chunk(s[p : p + n]) for p in range(0, len(s), n))
        out[f"out_chunks{n}"] = _u8(got + dec.flush())
        out[f"frames_completed_chunks{n}"] = [dec.frames_completed, int(dec.at_frame_boundary)]

    def bad():
        dec = make()
        for p in range(0, len(i["bad"]), 4096):
            dec.decompress_chunk(i["bad"][p : p + 4096])

    def cut():
        dec = make()
        dec.decompress_chunk(i["cut"])
        dec.flush()

    return {**out, "bad_checksum": _err(bad), "flush_mid_frame": _err(cut)}


def _streaming_port(i):
    from tpu_zstd_torch.api import manager

    return _streaming_run(manager.StreamingDecompressor, i)


def _streaming_ref(i):
    from tpu_zstd.api import manager

    return _streaming_run(manager.StreamingDecompressor, i)


case("streaming_decode", "api", _streaming_inputs, _streaming_port, _streaming_ref)

MANAGER_THRESHOLD = 8192  # cpu_threshold lowered so that both routes run at test sizes


def _manager_inputs():
    """A 6 KB input (the host route) and a 12 KB one (the device route, 16
    KB blocks) through Manager with cpu_threshold lowered; items for
    BatchManager at 16 KB blocks and for the top-level decoders, with a
    truncated frame among them; frames with and without content size,
    corrupt ones and garbage for the validators; data for XXH64State (in
    uneven updates) and xxh32."""
    from tpu_zstd_torch.format import frame

    rng = np.random.default_rng(46)
    small, big = _mix(46, 6000), _mix(48, 12000)
    good = frame.compress(small, frame.CompressParams(checksum=True, block_size=4096))
    mb = multiblock_frames()
    return {"small": small, "big": big, "good": good, "bad": [good[:-20], good[:7]],
            "no_size": rehead_wide(mb[6]), "flipped": _flip_last(good),
            "garbage": rng.integers(0, 256, 64, dtype=np.uint8).tobytes(),
            "batch_items": [small, b"", b"\x07" * 3000],
            "xxh": [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                    for n in (0, 5, 15, 16, 17, 31, 32, 33, 100, 1000)]}


def _xxh_surface(xxhash, datas):
    state_ok, digests = [], []
    for d in datas:
        st = xxhash.XXH64State()
        for p, q in ((0, 3), (3, 40), (40, len(d))):
            st.update(d[p:q])
        state_ok.append(st.digest() == xxhash.xxh64(d))
        digests.append(st.digest() & 0xFFFFFFFF)
    return {"xxh64_state_equal": state_ok, "xxh64_state_lo": digests,
            "xxh32": [xxhash.xxh32(d) for d in datas],
            "xxh32_seed": [xxhash.xxh32(d, 0x9E3779B1) for d in datas]}


def _stats_row(st) -> list:
    return [st.total_input_bytes, st.total_output_bytes, st.total_frames, st.total_blocks,
            st.total_compress_calls, st.total_decompress_calls]


def _manager_port(i):
    import tpu_zstd_torch as tz
    from tpu_zstd_torch.api import config, manager
    from tpu_zstd_torch.format import xxhash

    cfg = dataclasses.replace(config.CompressionConfig.from_level(3), block_size=16384,
                              cpu_threshold=MANAGER_THRESHOLD)
    m = manager.Manager(config=cfg, device="cpu")
    m_dev = manager.Manager(config=cfg, execution_path=config.ExecutionPath.TPU_BATCH,
                            device="cpu")
    paths = [int(m.select_execution_path(n)) for n in (0, MANAGER_THRESHOLD - 1,
                                                       MANAGER_THRESHOLD, 1 << 30)]
    host_frame, dev_frame = m.compress(i["small"]), m.compress(i["big"])
    dec = [m.decompress(host_frame), m.decompress(dev_frame), m_dev.decompress(dev_frame),
           m_dev.decompress(host_frame)]
    top = tz.compress(i["small"], level=1, checksum=True, device="cpu")
    items = i["batch_items"]
    bm = manager.BatchManager(config=cfg, device="cpu")
    bframes = [it.output for it in bm.compress_batch(items)]
    bitems = [bframes[0], i["bad"][0], bframes[2]]
    return _manager_digest(
        paths, host_frame, dev_frame, dec, _stats_row(m.stats), top,
        tz.decompress(top, device="cpu"), bframes, tz.decompress_batch(bitems, device="cpu"),
        [[int(it.status) for it in bm.decompress_batch(bitems, use_tpu=u)] for u in (True, False)],
        [[o == d for o, d in zip((it.output for it in bm.decompress_batch(bframes, use_tpu=u)),
                                 items)] for u in (True, False)],
        [tz.validate_compressed_data(f) for f in (i["good"], *i["bad"], i["flipped"],
                                                  i["garbage"])],
        [tz.get_decompressed_size(f) for f in (i["good"], i["no_size"], i["garbage"])],
        [tz.estimate_compressed_size(n) for n in (0, 1, 131072, 131073, 10**6)],
        _xxh_surface(xxhash, i["xxh"]))


def _manager_digest(paths, host_frame, dev_frame, dec, stats, top, top_dec, bframes, bdec,
                    statuses, batch_equal, valid, sizes, estimates, xxh):
    return {"paths": paths, "host_frame": _u8(host_frame), "dev_frame": _u8(dev_frame),
            **{f"dec{k}": _u8(d) for k, d in enumerate(dec)}, "stats": stats,
            "top_frame": _u8(top), "top_dec": _u8(top_dec),
            **{f"batch_frame{k}": _u8(f) for k, f in enumerate(bframes)},
            **{f"batch_dec{k}": _u8(d) if d is not None else [-1] for k, d in enumerate(bdec)},
            "batch_statuses": statuses, "batch_equal": batch_equal, "valid": valid,
            "sizes": [-1 if s is None else s for s in sizes], "estimates": estimates, **xxh}


def _manager_ref(i):
    """The reference's Manager: the host route is its Manager._compress_cpu
    (its native C++ engine, as the port's), and the stats are summed from
    the outputs as Manager counts them (its decode half would try libzstd
    first)."""
    import tpu_zstd as tj
    from tpu_zstd.api import config, decompress, manager
    from tpu_zstd.format import frame, xxhash

    cfg = dataclasses.replace(config.CompressionConfig.from_level(3), block_size=16384,
                              cpu_threshold=MANAGER_THRESHOLD)
    m = manager.Manager(config=cfg)
    paths = [int(m.select_execution_path(n)) for n in (0, MANAGER_THRESHOLD - 1,
                                                       MANAGER_THRESHOLD, 1 << 30)]
    host_frame = m._compress_cpu(i["small"])
    dev_frame, = manager.compress_items_tpu([i["big"]], cfg)
    dec = [frame.decompress(host_frame, verify_checksum=False),
           frame.decompress(dev_frame, verify_checksum=False),
           *decompress.decompress_batch_tpu([dev_frame, host_frame], verify_checksum=False)]
    stats = [len(i["small"]) + len(i["big"]), len(host_frame) + len(dev_frame), 2,
             sum(max(1, -(-len(d) // cfg.block_size)) for d in (i["small"], i["big"])), 2, 2]
    top = tj.compress(i["small"], level=1, checksum=True)
    items = i["batch_items"]
    bm = manager.BatchManager(config=cfg)
    bframes = [it.output for it in bm.compress_batch(items)]
    bitems = [bframes[0], i["bad"][0], bframes[2]]
    return _manager_digest(
        paths, host_frame, dev_frame, dec, stats, top, tj.decompress(top), bframes,
        tj.decompress_batch(bitems),
        [[int(it.status) for it in bm.decompress_batch(bitems, use_tpu=u)] for u in (True, False)],
        [[o == d for o, d in zip((it.output for it in bm.decompress_batch(bframes, use_tpu=u)),
                                 items)] for u in (True, False)],
        [tj.validate_compressed_data(f) for f in (i["good"], *i["bad"], i["flipped"],
                                                  i["garbage"])],
        [tj.get_decompressed_size(f) for f in (i["good"], i["no_size"], i["garbage"])],
        [config.estimate_compressed_size(n) for n in (0, 1, 131072, 131073, 10**6)],
        _xxh_surface(xxhash, i["xxh"]))


case("manager_surface", "api", _manager_inputs, _manager_port, _manager_ref)


# --- The last modules: native runtime, hybrid engine, adaptive levels, nvCOMP, OOM ----
# Group "surface" (tests/test_torch_api.py re-checks it against the JAX package).
# Floats are compared by their float64 bits.


def _f64(xs) -> np.ndarray:
    return np.asarray(xs, np.float64).view(np.int64)


XXH_LENS = (0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000, 65537)


def _native_inputs():
    """Seeded buffers for XXH64/32 (at seeds 0 and 2^64 - 1, 0 and 2^32 -
    1); a batch of blocks for the frame assembler (Raw, RLE, Compressed, an
    empty Raw block, checksums and none); Huffman streams of 100, 256, 257,
    300 and 5000 symbols from the port's host encoder with their decode
    tables, one of them cut short, one with a zero last byte and one read
    for more symbols than it holds."""
    from tpu_zstd_torch.format import huffman

    rng = np.random.default_rng(1801)
    bufs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in XXH_LENS]
    B, W = 6, 64
    contents = rng.integers(0, 256, (B, W), dtype=np.uint8)
    lens = np.array([40, 1, 64, 0, 17, 1], np.int32)
    types = np.array([2, 1, 0, 0, 2, 1], np.int32)
    raw_lens = np.array([1000, 300, 64, 0, 900, 5], np.int32)
    firsts, counts = np.array([0, 2, 5], np.int32), np.array([2, 3, 1], np.int32)
    headers = [b"\x28\xb5\x2f\xfd\x20\x10", b"HDR-B", b"H"]
    checks = [b"ck00", b"ck01", b"ck02"]
    streams = []
    for n, alpha in ((100, 9), (256, 30), (257, 200), (300, 4), (5000, 60)):
        sym = rng.integers(0, alpha, n).astype(np.uint8).tobytes()
        ct = huffman.build_ctable(np.bincount(np.frombuffer(sym, np.uint8), minlength=256))
        weights, _ = huffman.lengths_to_weights(ct.lengths)
        dt = huffman.build_dtable(weights)
        streams.append((huffman.encode_stream(sym, ct), dt, n))
    s, dt, n = streams[-1]
    bad = [(s[: len(s) // 2], dt, n), (s[:-1] + b"\x00", dt, n), (s, dt, n + 40)]
    return {"bufs": bufs, "asm": (contents, lens, types, raw_lens, firsts, counts, headers,
                                  checks), "streams": streams + bad}


def _python_join(contents, lens, types, raw_lens, firsts, counts, headers, checks):
    out = b""
    for f, (first, cnt) in enumerate(zip(firsts, counts)):
        out += headers[f]
        for b in range(first, first + cnt):
            last = int(b == first + cnt - 1)
            size = int(raw_lens[b]) if types[b] == 1 else int(lens[b])
            out += ((size << 3) | (int(types[b]) << 1) | last).to_bytes(3, "little")
            out += contents[b, : 1 if types[b] == 1 else lens[b]].tobytes()
        if checks is not None:
            out += checks[f]
    return out


def _native_run(native, decode_stream, i, chain_only):
    def halves(vs):  # 64-bit values as (high, low) 32-bit words
        return [w for v in vs for w in (v >> 32, v & 0xFFFFFFFF)]

    out = {"xxh64": halves(native.xxh64(b) for b in i["bufs"]),
           "xxh64_seed": halves(native.xxh64(b, (1 << 64) - 1) for b in i["bufs"]),
           "xxh32": [native.xxh32(b) for b in i["bufs"]],
           "xxh32_seed": [native.xxh32(b, (1 << 32) - 1) for b in i["bufs"]]}
    a = i["asm"]
    for k, checks in enumerate((a[7], None)):
        blob = native.assemble_frames(*a[:7], checks)
        out[f"assembled{k}"] = _u8(blob)
        out[f"assembled{k}_equals_python_join"] = [blob == _python_join(*a[:7], checks)]
    fast = []
    for k, (stream, dt, n) in enumerate(i["streams"]):
        packed = (dt.symbol.astype(np.int32) << 8) | dt.nb_bits.astype(np.int32)
        if chain_only:  # the Python chain: did it decode?
            fast.append(int(not len(_err(lambda: decode_stream(stream, dt, n)))))
        else:
            fast.append(int(native.huf_decode_stream(stream, packed, dt.table_log, n)
                            is not None))
        err = _err(lambda: decode_stream(stream, dt, n))
        out[f"huf{k}"] = err if len(err) else _u8(decode_stream(stream, dt, n))
    out["huf_decoded"] = fast
    return out


def _native_port(i):
    from tpu_zstd_torch.format import huffman
    from tpu_zstd_torch.utils import native

    assert native.get_native() is not None
    return _native_run(native, huffman.decode_stream, i, chain_only=False)


def _native_ref(i):
    """The reference's native runtime; its Huffman streams through its
    Python chain alone (the native path patched out), so the port's native
    decoder is held against the chain."""
    from tpu_zstd.format import huffman
    from tpu_zstd.utils import native

    orig = native.huf_decode_stream
    native.huf_decode_stream = lambda *a, **k: None
    try:
        return _native_run(native, huffman.decode_stream, i, chain_only=True)
    finally:
        native.huf_decode_stream = orig


case("native_runtime", "surface", _native_inputs, _native_port, _native_ref)

NATIVE_RUNS = ((1, False, 0), (3, True, 0), (19, False, 16384), (3, False, 4096))


def _native_engine_inputs():
    data = _mix(1802, 40000)
    return {"items": [data] * len(NATIVE_RUNS), "garbage": _mix(1803, 64)}


def _native_engine_run(native, host_decompress, i):
    out = {}
    for k, (level, checksum, bs) in enumerate(NATIVE_RUNS):
        eng = native.NativeEngine.create(level, checksum=checksum, block_size=bs)
        data = i["items"][k]
        f = eng.compress(data)
        out[f"frame{k}"] = f
        out[f"stats{k}"] = list(eng.stats())
        out[f"engine_dec{k}"] = [eng.decompress(f, len(data)) == data,
                                 eng.decompress(i["garbage"], 1000) is None,
                                 eng.decompress(f, len(data) - 1) is None]
        out[f"host_dec{k}"] = [host_decompress(f) == data]
        eng.reset()
        out[f"stats_reset{k}"] = list(eng.stats())
    return out


def _native_engine_port(i):
    from tpu_zstd_torch.format import frame
    from tpu_zstd_torch.utils import native

    return _native_engine_run(native, frame.decompress, i)


def _native_engine_ref(i):
    from tpu_zstd.format import frame
    from tpu_zstd.utils import native

    return _native_engine_run(native, frame.decompress, i)


case("native_engine", "surface", _native_engine_inputs, _native_engine_port, _native_engine_ref)

HYBRID_N = 4096  # block size of the hybrid cases' compression config
HYBRID_BATCH = 5000  # tpu_batch_threshold lowered so that both routes run at test sizes
ROUTE_SIZES = (0, 1, (64 << 10) - 1, 64 << 10, HYBRID_BATCH - 1, HYBRID_BATCH, (4 << 20) - 1,
               4 << 20, 16 << 20)


def _hybrid_inputs():
    """Sizes around both thresholds for the routing matrix; a small and a
    large host input (both routes at the lowered threshold); a decode_accel
    frame (the prepared plan, chunk-parallel), a 2-block frame re-headed to
    an 8 MiB window (the plan refuses it: decompress_batch_tpu), a
    truncated frame (the host parse refuses it: the host decoder)."""
    @functools.lru_cache(maxsize=None)
    def make():
        from tpu_zstd_torch.api import config, manager

        cfg = dataclasses.replace(config.CompressionConfig.from_level(3), block_size=HYBRID_N)
        small, big = _mix(1804, 1200), _mix(1805, HYBRID_BATCH + 1000)
        acc, = manager.compress_items([small], dataclasses.replace(cfg, decode_accel=True),
                                      device="cpu")
        two, = manager.compress_items([big[:HYBRID_N + 1000]], cfg, device="cpu")
        return {"small": small, "big": big, "accel": acc, "wide": rehead_wide(two),
                "wide_data": big[:HYBRID_N + 1000], "cut": two[: len(two) // 2]}

    return make


def _hybrid_run(hy, cfg_mod, i, **dev):
    H, R, L = hy.HybridEngine, hy.RoutingMode, hy.DataLocation
    comp = dataclasses.replace(cfg_mod.CompressionConfig.from_level(3), block_size=HYBRID_N)
    out = {}
    routes, reasons = [], []
    for mode in R:
        eng = H(hy.HybridConfig(mode=mode), compression=comp, **dev)
        for loc in L:
            for is_c in (True, False):
                for n in ROUTE_SIZES:
                    b, why = eng.decide_route(n, loc, is_c)
                    routes.append(int(b))
                    reasons.append(why)
    out["routes"] = routes
    out["reasons"] = _u8("|".join(dict.fromkeys(reasons)).encode())
    # The ADAPTIVE switch on seeded histories (MB/s), then AUTO's fall-through.
    eng = H(hy.HybridConfig(mode=R.ADAPTIVE), compression=comp, **dev)
    adaptive = []
    for cpu, tpu in (([], [500.0]), ([100.0], [130.0]), ([100.0], [110.0, 140.0]),
                     ([100.0, 300.0], [200.0])):
        for bk, vals in ((hy.Backend.CPU_LIBZSTD, cpu), (hy.Backend.TPU_KERNELS, tpu)):
            eng._history[bk].clear()
            eng._history[bk].extend(vals)
        b, why = eng.decide_route(1 << 10, L.HOST, True)
        adaptive.append(f"{int(b)}:{why}")
    out["adaptive"] = _u8("|".join(adaptive).encode())
    cfg_h = dict(tpu_batch_threshold=HYBRID_BATCH)
    frames = {}
    for name, mode, data in (("auto_small", R.AUTO, i["small"]), ("auto_big", R.AUTO, i["big"]),
                             ("force_tpu", R.FORCE_TPU, i["small"]),
                             ("force_cpu", R.FORCE_CPU, i["big"])):
        eng = H(hy.HybridConfig(mode=mode, **cfg_h), compression=comp, **dev)
        res = hy.HybridResult()
        frames[name] = eng.compress(np.frombuffer(data, np.uint8), result=res)
        out[f"{name}_route"] = [int(res.backend), res.input_size, res.output_size]
        out[f"{name}_frame"] = _u8(frames[name])
    eng = H(hy.HybridConfig(mode=R.AUTO, **cfg_h), compression=comp, **dev)
    out["batch_frames"] = _u8(b"".join(eng.compress_batch([i["small"], i["big"]])))
    eng_t = H(hy.HybridConfig(mode=R.FORCE_TPU), compression=comp, **dev)
    decoded = []
    for f, want, engines in ((i["accel"], i["small"], (eng, eng_t)),
                             (i["wide"], i["wide_data"], (eng, eng_t)),
                             (frames["auto_big"], i["big"], (eng,)),
                             (frames["force_cpu"], i["big"], (eng,))):
        for e in engines:
            res = hy.HybridResult()
            decoded.append([int(e.decompress(f, result=res) == want), int(res.backend)])
    res = hy.HybridResult()
    out["cut_err"] = _err(lambda: eng_t.decompress(i["cut"], result=res))
    out["cut_route"] = _u8(f"{int(res.backend)}:{res.routing_reason}".encode())
    out["decoded"] = decoded
    out["batch_decoded"] = [
        int(e.decompress_batch([i["accel"], frames["force_tpu"]]) == [i["small"]] * 2)
        for e in (eng, eng_t)]
    out["batch_cut_err"] = _err(lambda: eng_t.decompress_batch([i["accel"], i["cut"]]))
    out["locations"] = [int(hy.detect_location(x)) for x in (
        b"", bytearray(3), memoryview(b"ab"), np.zeros(3, np.uint8), [1, 2], "text")]
    return out


def _hybrid_port(i):
    from tpu_zstd_torch.api import config, hybrid

    out = _hybrid_run(hybrid, config, i, device="cpu")
    assert hybrid.detect_location(torch.zeros(3, dtype=torch.uint8)) == hybrid.DataLocation.HOST
    return out


def _hybrid_ref(i):
    """The reference's HybridEngine with its CPU backend taken by its own
    native engine (the port's by design; the reference's is libzstd)."""
    from tpu_zstd.api import config, hybrid
    from tpu_zstd.utils.native import NativeEngine

    orig = hybrid.HybridEngine._cpu_compress
    hybrid.HybridEngine._cpu_compress = (
        lambda self, data: NativeEngine.create(self.compression.level).compress(data))
    try:
        return _hybrid_run(hybrid, config, i)
    finally:
        hybrid.HybridEngine._cpu_compress = orig


case("hybrid_routes", "surface", _hybrid_inputs(), _hybrid_port, _hybrid_ref)


def _adaptive_inputs():
    rng = np.random.default_rng(1806)
    text = make_corpus(80000)
    return {"datas": [text, rng.integers(0, 256, 80000, dtype=np.uint8).tobytes(),
                      b"\x07" * 70000, b"", b"abcde", rng.integers(0, 4, 5000, np.uint8).tobytes(),
                      text[:40000] + rng.integers(0, 256, 40000, dtype=np.uint8).tobytes(),
                      bytes(range(256)) * 300]}


def _adaptive_run(ad, i):
    out = {}
    for k, d in enumerate(i["datas"]):
        prof = ad.analyze(d)
        out[f"profile{k}"] = _f64([prof.entropy_bits, prof.repetition, prof.pattern_density,
                                   prof.compressibility])
        out[f"levels{k}"] = [ad.select_adaptive_level(d, p) for p in ad.Preference] + [
            int(ad.is_compressible(d)), int(prof.compressible)]
        sel = ad.AdaptiveLevelSelector(ad.Preference.RATIO)
        cfg = sel.config_for(d)
        out[f"config{k}"] = [-1 if v is None else int(v) for v in dataclasses.asdict(cfg).values()]
        out[f"last_profile{k}"] = _f64([sel.last_profile.entropy_bits])
    return out


def _adaptive_port(i):
    from tpu_zstd_torch.api import adaptive

    return _adaptive_run(adaptive, i)


def _adaptive_ref(i):
    from tpu_zstd.api import adaptive

    return _adaptive_run(adaptive, i)


case("adaptive_levels", "surface", _adaptive_inputs, _adaptive_port, _adaptive_ref)


def _nvcomp_inputs():
    rng = np.random.default_rng(1808)
    return {"chunks": [_mix(1809, 3000), b"", b"\x05" * 2000,
                       rng.integers(0, 256, 1000, dtype=np.uint8).tobytes(), make_corpus(2500)]}


def _nvcomp_run(nv, cfg_mod, i, **dev):
    cfg = dataclasses.replace(cfg_mod.CompressionConfig.from_level(3), block_size=HYBRID_N)
    m = nv.NvcompV5BatchManager(config=cfg, **dev)
    chunks = i["chunks"]
    box = m.compress(chunks)
    meta, pos = m.get_metadata(box)
    out = {"container": _u8(box), "async_equal": [m.compress_async(chunks)() == box],
           "meta": [meta.version, meta.chunk_count, meta.total_uncompressed, pos,
                    *meta.uncompressed_sizes, *meta.compressed_sizes],
           "decompress_equal": [m.decompress(box) == chunks],
           "chunks_equal": [m.decompress_chunk(box, k) == c for k, c in enumerate(chunks)],
           "capacity": [m.get_compress_temp_size(4, 1 << 17), m.get_decompress_temp_size(4, 9),
                        *(m.get_max_compressed_chunk_size(n) for n in (0, 1, 131072, 10**6))],
           "nvcomp_errors": [m.status_to_nvcomp_error(st) for st in cfg_mod.Status]}
    bad_version = box[:8] + (2).to_bytes(4, "little") + box[12:]
    for k, fn in enumerate((lambda: m.get_metadata(box[:5]),
                            lambda: m.get_metadata(b"\x28\xb5\x2f\xfd" + box[4:]),
                            lambda: m.get_metadata(bad_version),
                            lambda: m.decompress_chunk(box, len(chunks)),
                            lambda: m.decompress_chunk(box, -1))):
        out[f"err{k}"] = _err(fn)
    return out


def _nvcomp_port(i):
    from tpu_zstd_torch.api import config, nvcomp

    return _nvcomp_run(nvcomp, config, i, device="cpu")


def _nvcomp_ref(i):
    from tpu_zstd.api import config, nvcomp

    return _nvcomp_run(nvcomp, config, i)


case("nvcomp_container", "surface", _nvcomp_inputs, _nvcomp_port, _nvcomp_ref)


def _degraded_inputs():
    return {"items": [_mix(1810 + k, 800 + 400 * k) for k in range(4)]}


def _degraded_run(manager, cfg_mod, name, oom, i, **dev):
    """BatchManager.compress_batch with the module's batch compressor
    raising `oom` for any batch of more than one item."""
    cfg = dataclasses.replace(cfg_mod.CompressionConfig.from_level(3), block_size=HYBRID_N)
    orig = getattr(manager, name)
    sizes = []

    def flaky(items, *a, **k):
        sizes.append(len(items))
        if len(items) > 1:
            raise oom
        return orig(items, *a, **k)

    setattr(manager, name, flaky)
    try:
        bm = manager.BatchManager(config=cfg, **dev)
        res = bm.compress_batch(i["items"])
    finally:
        setattr(manager, name, orig)
    return {**{f"frame{k}": it.output for k, it in enumerate(res)},
            "degradations": [bm.degradations], "batch_sizes": sizes,
            "statuses": [int(it.status) for it in res]}


def _degraded_port(i):
    from tpu_zstd_torch.api import config, manager

    return _degraded_run(manager, config, "compress_items",
                         torch.cuda.OutOfMemoryError("CUDA out of memory"), i, device="cpu")


def _degraded_ref(i):
    from tpu_zstd.api import config, manager

    return _degraded_run(manager, config, "compress_items_tpu",
                         RuntimeError("RESOURCE_EXHAUSTED: Out of memory"), i)


case("batch_degraded", "surface", _degraded_inputs, _degraded_port, _degraded_ref)


# --- Slice 6: cross-block windows, dictionaries, sample_log, dec_min_ml -------------

WIN_DC, WIN_N = 4096, 8192  # window prefix and payload of the parse cases
WIN_FM_KW = (dict(hash_log=13, depth=4, cap=8, mf_win_log=12),
             dict(hash_log=13, depth=4, cap=16, mf_win_log=0, min_match=3, two_band=True))


def _win_rows(DC, N, seed):
    """Rows (DC + N) laid out [padding | dlen window bytes | payload]: corpus
    text continuing its window, a seeded mix whose payload repeats pieces
    of its window, random bytes with no window, a short payload with a
    full window and an empty one. Returns blocks, payload lengths, dlens."""
    rng = np.random.default_rng(seed)
    text = make_corpus(DC + N)
    mix = rng.integers(0, 256, DC + N, dtype=np.uint8)
    for _ in range(N // 64):
        ln = int(rng.integers(3, 200))
        src = int(rng.integers(0, DC + N - ln))
        dst = int(rng.integers(DC, DC + N - ln))
        mix[dst:dst + ln] = mix[src:src + ln]
    spec = [(text, DC, N), (mix.tobytes(), DC - 1000, N - 5), (rng.bytes(DC + N), 0, N),
            (text[::-1], DC, 1500), (text, 777, 0)]
    spec = [(src, min(dlen, DC), n) for src, dlen, n in spec]
    blocks = np.zeros((len(spec), DC + N), np.uint8)
    for k, (src, dlen, n) in enumerate(spec):
        row = np.frombuffer(src, np.uint8)
        blocks[k, DC - dlen : DC + n] = row[DC - dlen : DC + n]
    return {"blocks": blocks, "lengths": np.array([s[2] for s in spec], np.int32),
            "dlens": np.array([s[1] for s in spec], np.int32)}


def _fm_win_inputs():
    return {**_win_rows(WIN_DC, WIN_N, 61), "kws": WIN_FM_KW}


def _fm_win_port(i):
    from tpu_zstd_torch.ops import lz77

    ws = WIN_DC - _t(i["dlens"]).to(torch.int64)
    n = WIN_DC + _t(i["lengths"]).to(torch.int64)
    return {f"c{c}_out{k}": v for c, kw in enumerate(i["kws"])
            for k, v in enumerate(lz77.find_matches(_t(i["blocks"]), n, win_start=ws, **kw))}


def _fm_win_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import lz77_jax

    out = {}
    for c, kw in enumerate(i["kws"]):
        res = jax.jit(jax.vmap(lambda b, n, d, kw=kw: lz77_jax.find_matches(
            b, WIN_DC + n, win_start=WIN_DC - d, **kw)))(
            jnp.asarray(i["blocks"]), jnp.asarray(i["lengths"]), jnp.asarray(i["dlens"]))
        out.update({f"c{c}_out{k}": np.asarray(v) for k, v in enumerate(res)})
    return out


case("find_matches_win_start", "windows", _fm_win_inputs, _fm_win_port, _fm_win_ref)


def _fml_win_port(i):
    from tpu_zstd_torch.ops import lz77

    ml, off = lz77.find_matches_long(_t(i["blocks"]), WIN_DC + _t(i["lengths"]).to(torch.int64),
                                     win_start=WIN_DC - _t(i["dlens"]).to(torch.int64))
    return {"ml": ml, "off": off}


def _fml_win_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import lz77_jax

    ml, off = jax.jit(jax.vmap(lambda b, n, d: lz77_jax.find_matches_long(
        b, WIN_DC + n, win_start=WIN_DC - d)))(
        jnp.asarray(i["blocks"]), jnp.asarray(i["lengths"]), jnp.asarray(i["dlens"]))
    return {"ml": np.asarray(ml), "off": np.asarray(off)}


case("find_matches_long_win_start", "windows", lambda: _win_rows(WIN_DC, WIN_N, 62),
     _fml_win_port, _fml_win_ref)

# Parse calls over window rows: the dictionary mode (the search over the
# whole row; min_match 3 with a capacity some rows overflow), the
# payload-only mode (LDM with windows that tile the payload), sampled
# positions (the packed restore key, and the 20-bit fallback at 16 KB
# windows), and the decode-tuned minimum length.
WIN_PARSE = {
    "parse_dict": ((WIN_DC, WIN_N, 63), (
        dict(max_seqs=WIN_N // 4, hash_log=13, depth=4, cap=8, min_match=4, lazy=True,
             of_gate=(8, 12), mf_win_log=0),
        dict(max_seqs=700, hash_log=13, depth=4, cap=16, min_match=3, lazy=True,
             of_gate=(99, 99), mf_win_log=0))),
    "parse_payload_only": ((8192, 8192, 64), (
        dict(max_seqs=2048, hash_log=13, depth=4, cap=16, min_match=4, lazy=True,
             of_gate=(8, 12), mf_win_log=12, ldm=True),
        dict(max_seqs=2048, hash_log=13, depth=4, cap=16, min_match=3, optimal=True,
             mf_win_log=12, ldm=True))),
    "parse_sample_log": ((0, 16384, 65), (
        dict(max_seqs=4096, hash_log=13, depth=4, cap=8, min_match=4, lazy=True,
             of_gate=(8, 12), mf_win_log=12, sample_log=2),
        dict(max_seqs=4096, hash_log=13, depth=4, cap=32, min_match=4, lazy=False,
             mf_win_log=13, sample_log=1))),
    "parse_dec_min_ml": ((0, 16384, 66), (
        dict(max_seqs=4096, hash_log=13, depth=4, cap=16, min_match=4, lazy=True,
             of_gate=(8, 12), mf_win_log=12, dec_min_ml=8),)),
}


def _win_parse_inputs(name):
    def make():
        (DC, N, seed), kws = WIN_PARSE[name]
        return {**_win_rows(DC, N, seed), "DC": DC, "kws": kws}

    return make


def _win_parse_digest(seqs, c, W):
    return {f"c{c}_{k}": v for k, v in _opt_parse_digest(seqs, W).items()}


def _win_parse_port(i):
    from tpu_zstd_torch.ops import lz77

    DC = i["DC"]
    blocks = _t(i["blocks"])
    n = DC + _t(i["lengths"]).to(torch.int64)
    ws = DC - _t(i["dlens"]).to(torch.int64)
    out = {}
    for c, kw in enumerate(i["kws"]):
        seqs = lz77.parse_block(blocks, n, block_start=DC, win_start=ws, **kw)
        out.update(_win_parse_digest(seqs, c, blocks.shape[1]))
    return out


def _win_parse_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.ops import lz77_jax

    DC = i["DC"]
    out = {}
    for c, kw in enumerate(i["kws"]):
        seqs = jax.jit(jax.vmap(lambda b, n, d, kw=kw: lz77_jax.parse_block(
            b, DC + n, block_start=DC, win_start=DC - d, **kw)))(
            jnp.asarray(i["blocks"]), jnp.asarray(i["lengths"]), jnp.asarray(i["dlens"]))
        out.update(_win_parse_digest(jax.device_get(seqs), c, i["blocks"].shape[1]))
    return out


for _name in WIN_PARSE:
    case(_name, "windows", _win_parse_inputs(_name), _win_parse_port, _win_parse_ref)


def _win_items_inputs(level, history):
    """Items at 16 KB blocks for compress_items' window modes: corpus text
    over several blocks, a seeded mix whose later blocks repeat its first
    one, an empty item and a run of one byte; with history, each item's
    prior stream content (`zstd_dicts`: libzstd decodes each frame with it
    as a raw-content dictionary). Without history, also the frame of the
    first item's first 3000 bytes with dictionary IDs of 1, 2 and 4 bytes
    (the header's only change; libzstd refuses an ID that no loaded
    dictionary carries, so these are compared as bytes only)."""
    def make():
        rng = np.random.default_rng(70 + level)
        first = rng.bytes(9000)
        items = [make_corpus(30000), first + rng.bytes(5000) + first + make_corpus(9000),
                 b"", b"\x09" * 20000]
        out = {"level": level, "items": items, "history": None}
        if not history:
            out["dict_ids"] = (0x12, 0x1234, 0x12345678)
        if history:
            out["history"] = [make_corpus(90000)[-30000:], first[::-1] * 3, b"abc", b""]
            out["zstd_dicts"] = out["history"]
        return out

    return make


def _win_items_cfg(config, i):
    """Windows of 16 KB (window_log 14): enable_ldm without history; level 3
    and level 19 (trimmed, `_opt_level_cfg`) with it, level 19 with a
    checksum."""
    if i["history"] is None:
        return dataclasses.replace(config.CompressionConfig.from_level(i["level"]),
                                   block_size=16384, enable_ldm=True, window_log=14)
    if i["level"] == 3:
        return dataclasses.replace(config.CompressionConfig.from_level(3), block_size=16384,
                                   window_log=14)
    return dataclasses.replace(_opt_level_cfg(config, i["level"]), window_log=14,
                               checksum=config.ChecksumPolicy.COMPUTE)


def _win_items_run(config, compress, i):
    cfg = _win_items_cfg(config, i)
    out = {f"frame{k}": f for k, f in enumerate(compress(i["items"], cfg, i["history"]))}
    for did in i.get("dict_ids", ()):
        f, = compress([i["items"][0][:3000]], dataclasses.replace(cfg, dict_id=did), None)
        out[f"dict_id_{did:x}"] = _u8(f)
    return out


def _win_items_port(i):
    from tpu_zstd_torch.api import config, manager

    return _win_items_run(config, lambda it, c, h: manager.compress_items(
        it, c, history=h, device="cpu"), i)


def _win_items_ref(i):
    from tpu_zstd.api import config, manager

    return _win_items_run(config, lambda it, c, h: manager.compress_items_tpu(
        it, c, history=h), i)


case("items_ldm", "windows", _win_items_inputs(3, False), _win_items_port, _win_items_ref)
for _level in (3, 19):
    case(f"items_history_level{_level}", "windows", _win_items_inputs(_level, True),
         _win_items_port, _win_items_ref)

# StreamingManager at 16 KB blocks: with window history (chunks of 12000,
# 1, 0 and 25000 bytes, the last repeating the first), a checksum and
# window_log 14 (a 16 KB history), decoded again by the manager's
# decompress half; and without history. Then each compress half is reset
# and reused.
STREAM_RUNS = ((True, 1, 14), (False, 0, None))


def _stream_compress_inputs():
    rng = np.random.default_rng(71)
    first = make_corpus(12000)
    chunks = [first, b"Z", b"", rng.bytes(5000) + first + make_corpus(40000)[-8000:]]
    data = b"".join(chunks)
    return {"chunks": chunks, "items": [data] * len(STREAM_RUNS), "runs": STREAM_RUNS}


def _stream_compress_run(config, manager, i, **kw):
    out = {}
    for k, (hist, ck, wl) in enumerate(i["runs"]):
        cfg = dataclasses.replace(config.CompressionConfig.from_level(3), block_size=16384,
                                  checksum=config.ChecksumPolicy(ck), window_log=wl)
        sm = manager.StreamingManager(config=cfg, window_history=hist, **kw)
        stream = b"".join(sm.compress_chunk(c) for c in i["chunks"]) + sm.flush()
        out[f"frame{k}"] = stream
        out[f"flush_again{k}"] = _u8(sm.flush())
        if hist:
            back = b"".join(sm.decompress_chunk(stream[p : p + 5000])
                            for p in range(0, len(stream), 5000)) + sm.decompress_flush()
            out[f"decoded{k}"] = _u8(back)
        out[f"stats{k}"] = [sm.stats.total_input_bytes, sm.stats.total_output_bytes]
        sm.reset()
        out[f"after_reset{k}"] = _u8(sm.compress_chunk(i["chunks"][0][:3000]) + sm.flush())
    return out


def _stream_compress_port(i):
    from tpu_zstd_torch.api import config, manager

    return _stream_compress_run(config, manager, i, device="cpu")


def _stream_compress_ref(i):
    from tpu_zstd.api import config, manager

    return _stream_compress_run(config, manager, i)


case("streaming_compress", "windows", _stream_compress_inputs, _stream_compress_port,
     _stream_compress_ref)


def dict_records(seed: int, count: int, corpus_bytes: int = 1 << 20) -> list[bytes]:
    """count records of 256-4096 bytes cut from make_corpus at seeded
    offsets and lengths."""
    rng = np.random.default_rng(seed)
    base = make_corpus(corpus_bytes)
    lens = rng.integers(256, 4097, count)
    starts = rng.integers(0, len(base) - 4096, count)
    return [base[s : s + n] for s, n in zip(starts, lens)]


# tools/make_torch_goldens.py slice6 and chip_smoke.py phase 4f: the bench
# corpus as items of 1 MiB, a 64 KB history and the 8 blocks after it, and
# records for training and compressing against a 64 KB dictionary.
SLICE6_ITEM = 1 << 20
SLICE6_HISTORY = 64 * 1024
SLICE6_RECORDS = (74, 1024, 256)  # seed, training records, records compressed


def slice6_inputs(data: bytes, N: int) -> dict:
    seed, ntrain, ncomp = SLICE6_RECORDS
    recs = dict_records(seed, ntrain + ncomp, len(data))
    return {"items": [data[k : k + SLICE6_ITEM] for k in range(0, len(data), SLICE6_ITEM)],
            "history": data[:SLICE6_HISTORY],
            "item19": data[SLICE6_HISTORY : SLICE6_HISTORY + 8 * N],
            "train": recs[:ntrain], "records": recs[ntrain:]}


def _train_inputs():
    return {"samples": dict_records(72, 96, 1 << 18), "sizes": (256, 4096, 20000)}


def _train_run(dictionary, i):
    out = {}
    for k, size in enumerate(i["sizes"]):
        d = dictionary.train_dictionary(i["samples"], dict_size=size)
        env = dictionary.write_structured_dictionary(d)
        back = dictionary.read_dictionary(env)
        out[f"content{k}"] = _u8(d.content)
        out[f"id{k}"] = [d.dict_id, back.dict_id, len(d), int(back.content == d.content)]
        out[f"envelope{k}"] = _u8(env)
    raw = dictionary.read_dictionary(b"raw bytes")
    out["raw"] = [raw.dict_id, len(raw)]
    out["few"] = _u8(dictionary.train_dictionary([b"tiny"], dict_size=300).content)
    out["dmer"] = dictionary._dmer_counts(np.frombuffer(i["samples"][0], np.uint8), 8)
    return out


def _train_port(i):
    from tpu_zstd_torch import dictionary

    return _train_run(dictionary, i)


def _train_ref(i):
    from tpu_zstd import dictionary

    return _train_run(dictionary, i)


case("train_dictionary", "windows", _train_inputs, _train_port, _train_ref)


def _dict_frames_inputs():
    """Records against a 3000-byte dictionary trained on other records
    (dict_cap 4096), at 16 KB blocks: `zstd_dict` is the content libzstd
    decodes the frames with, as a raw-content dictionary."""
    from tpu_zstd_torch import dictionary

    recs = dict_records(73, 60, 1 << 18)
    d = dictionary.train_dictionary(recs[:44], dict_size=3000)
    items = recs[44:] + [b"", b"\x05" * 5000, make_corpus(40000)[-20000:]]
    return {"items": items, "content": d.content, "dict_id": d.dict_id, "zstd_dict": d.content}


def _dict_frames_run(dictionary, config, i, **kw):
    d = dictionary.Dictionary(i["content"], i["dict_id"])
    cfg = dataclasses.replace(config.CompressionConfig.from_level(3), block_size=16384)
    frames = dictionary.compress_with_dict(i["items"], d, cfg, **kw)
    return {**{f"frame{k}": f for k, f in enumerate(frames)},
            "decoded": [int(dictionary.decompress_with_dict(f, d) == x)
                        for f, x in zip(frames, i["items"])]}


def _dict_frames_port(i):
    from tpu_zstd_torch import dictionary
    from tpu_zstd_torch.api import config

    return _dict_frames_run(dictionary, config, i, device="cpu")


def _dict_frames_ref(i):
    from tpu_zstd import dictionary
    from tpu_zstd.api import config

    return _dict_frames_run(dictionary, config, i)


case("dict_frames", "windows", _dict_frames_inputs, _dict_frames_port, _dict_frames_ref)


def rung_payload(M: int, seed: int, N: int = 16384) -> bytes:
    """Random bytes with 6-byte copies from up to 4000 bytes back at M
    positions 7 bytes apart: about M sequences at level 3."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, N, dtype=np.uint8)
    for p in np.sort(rng.choice(np.arange(5, (N - 8) // 7), M, replace=False)) * 7:
        src = int(rng.integers(max(0, p - 4000), p - 16))
        a[p : p + 6] = a[src : src + 6]
    return a.tobytes()


def _rung_inputs():
    """Two single-block items behind a 100-byte history (16 KB blocks and
    window: a sequence width of 4096, rungs 2048 and 4096) whose blocks
    parse into 2048 and 2049 sequences, the last max(nseq) of the first rung
    and the first of the second; the parse's nseq is part of the digest."""
    hist = b"h" * 100
    return {"items": [rung_payload(2051, 81), rung_payload(2052, 81)], "hist": hist,
            "zstd_dicts": [hist, hist]}


def _rung_rows(i, DC):
    rows = np.zeros((8, DC + 16384), np.uint8)
    rows[:, DC - len(i["hist"]) : DC] = np.frombuffer(i["hist"], np.uint8)
    rows[:2, DC:] = [np.frombuffer(d, np.uint8) for d in i["items"]]
    return rows, np.array([16384] * 2 + [0] * 6, np.int32), np.full(8, len(i["hist"]), np.int32)


def _rung_run(config, pipeline_config, compress, parse, i):
    cfg = dataclasses.replace(config.CompressionConfig.from_level(3), block_size=16384,
                              window_log=14)
    out = {f"frame{k}": compress([d], cfg, [i["hist"]])[0] for k, d in enumerate(i["items"])}
    pcfg = dataclasses.replace(pipeline_config(cfg), dict_cap=16384)
    out["nseq"] = parse(pcfg, *_rung_rows(i, 16384))
    return out


def _rung_port(i):
    from tpu_zstd_torch.api import config, manager
    from tpu_zstd_torch.ops import pipeline

    def parse(pcfg, rows, lens, dlens):
        return pipeline._parse_one(_t(rows), _t(lens), pcfg, _t(dlens)).nseq

    return _rung_run(config, manager._pipeline_config, lambda it, c, h: manager.compress_items(
        it, c, history=h, device="cpu"), parse, i)


def _rung_ref(i):
    import jax
    import jax.numpy as jnp

    from tpu_zstd.api import config, manager
    from tpu_zstd.ops import pipeline

    def parse(pcfg, rows, lens, dlens):
        return np.asarray(jax.jit(jax.vmap(lambda b, l, d: pipeline._parse_one(b, l, pcfg, d)))(
            jnp.asarray(rows), jnp.asarray(lens), jnp.asarray(dlens)).nseq)

    return _rung_run(config, manager._pipeline_config, lambda it, c, h: manager.compress_items_tpu(
        it, c, history=h), parse, i)


case("items_rung_edge", "windows", _rung_inputs, _rung_port, _rung_ref)


# --- Slice 7: the inputs of tests/golden/torch_slice7.json (chip_smoke.py phase 4g) --

SLICE7_SEED = 1870
SLICE7_NATIVE = 4 << 20  # make_corpus(4 MiB): the native engine's frames
SLICE7_LEVELS = (1, 3, 19)
SLICE7_HOST = 64 << 10  # the hybrid engine's host route: the corpus's first 64 KB
# decide_route calls of phase 4g: (mode, size, location, is_compress).
SLICE7_ROUTES = ((0, 16 << 20, 1, True), (0, SLICE7_HOST, 1, True), (0, 1 << 20, 2, True),
                 (0, 1 << 20, 1, False), (2, 1 << 20, 1, False), (1, 16 << 20, 2, True),
                 (3, 16 << 20, 1, True), (3, SLICE7_HOST, 1, True))


def slice7_inputs(data: bytes) -> dict:
    """Seeded buffers for XXH64/32, the inputs of the native frames, the
    adaptive levels' inputs (the corpus, seeded random bytes, a run of one
    byte; 1 MiB each) and the hybrid host route's input, from the bench
    corpus `data`."""
    rng = np.random.default_rng(SLICE7_SEED)
    return {"xxh": [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                    for n in (0, 7, 32, 1000, 1 << 20)],
            "native": make_corpus(SLICE7_NATIVE),
            "adaptive": [data[: 1 << 20], rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes(),
                         b"\xa5" * (1 << 20)],
            "host": data[:SLICE7_HOST]}
