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
