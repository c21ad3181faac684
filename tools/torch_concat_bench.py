#!/usr/bin/env python3
"""K2 (`concat_fused`, csrc/concat.cu) of the PyTorch port on one CUDA card:
equality with its plain version, then its time beside the K2 stage it
replaced and the batches around it.

    python3 tools/torch_concat_bench.py [--tree DIR] [--sweep T,P ...] [--check-only] [--out DIR]

Builds the port's kernels (seconds and the assembler's report for K2),
holds the fused kernel against its plain version (exact equality, dtypes
too) on tests/torch_cases.py `concat_fused_hard` operands (at the tier-1
case's shape, at the parse's 128 x 64 x 2048 and at widths and lengths off
16 bytes, also from sources that do not start on 16 bytes) and on the
operands the parse hands it for the DEFAULT_CONFIG bench batch (128 x 128
KB of `make_corpus`), captured at its call in ops/lz77.py. --check-only
stops there.

Then it times, by CUDA events over back-to-back calls and on the device
(torch.profiler), on those captured operands:
- the fused launch, beside its bound: the bytes it must move (each live
  source element read once, offsets and counts read once, each output
  written once, over 3.35 TB/s);
- with --tree DIR (another checkout, say the parent commit unpacked with
  `git archive`), the K2 stage as that tree's ops/lz77.py ran it: its
  kernel's three launches on the same operands cast to int32 beforehand,
  and the whole stage (the casts, the window-base add, three zeroed outputs,
  the three launches and the casts back), checked equal to the fused
  outputs;
- the fused call, which is the whole stage in this tree;
- with --sweep T,P ..., csrc/concat.cu built alone with CONCAT_THREADS = T
  and CONCAT_PARTS = P (threads and CTAs a row and operand), each build
  checked equal and timed (queued events and on the device) on all three
  operands, on each alone, with every count set to 0 (a pure zero fill,
  beside `torch.zeros` of the same outputs) and on the literal row with the
  most and with the median literals alone.
It prints the captured operands' live elements a row (mean and max) and,
beside the fused launch's bound, the three launches' bound as that tree ran
them (int32 sources and outputs, the same live elements).
With --tree it then times the DEFAULT_CONFIG, SLICE_CONFIG and level-19
batches (`compress_blocks_staged_many`, pipelined over 5 batches, 3 at
level 19, best of 2, as `chip_smoke.py` times them) with that tree's
pipeline and this one's in turns (tree, this, this, tree), after checking
that both give the same block bytes. Both trees run in one process: the
other tree's package is imported under another name and builds its own
kernel library. The last line is one JSON object of the numbers; --out also
writes it to DIR/concat_bench.json.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
B, N = 128, 131072


def load_tree(tree: pathlib.Path, name: str):
    """The port package of checkout `tree`, imported as `name`."""
    pkg = tree / "tpu_zstd_torch"
    spec = importlib.util.spec_from_file_location(name, pkg / "__init__.py",
                                                  submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def sweep(points, ops, concat, cs, card, dev) -> dict:
    """csrc/concat.cu built alone at each (CONCAT_THREADS, CONCAT_PARTS),
    checked and timed on the captured operands."""
    import ctypes
    import subprocess

    import torch

    from tpu_zstd_torch.ops import _kernels

    want = concat.concat_fused_plain(ops)
    zero_ops = [op._replace(counts=torch.zeros_like(op.counts)) for op in ops]
    tot = ops[0].counts.sum(1)
    rows = {"most literals": int(tot.argmax()),
            "median literals": int(tot.argsort()[len(tot) // 2])}
    stream = torch.cuda.current_stream().cuda_stream
    _kernels.BUILD_DIR.mkdir(exist_ok=True)
    out = {}
    for point in points:
        T, P = (int(v) for v in point.split(","))
        so = _kernels.BUILD_DIR / f"concat_sweep_t{T}_p{P}.so"
        build = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, f"-DCONCAT_THREADS={T}",
                                f"-DCONCAT_PARTS={P}", "-shared", "-o", str(so),
                                str(_kernels.CSRC_DIR / "concat.cu")],
                               capture_output=True, text=True)
        if build.returncode:
            raise SystemExit(f"nvcc failed for T={T}, P={P}:\n{build.stdout}{build.stderr}")
        regs = [x.split(":")[-1].strip() for x in (build.stdout + build.stderr).splitlines()
                if "Used" in x]
        fn = ctypes.CDLL(str(so)).tz_concat_fused
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int

        def runner(ops_k):
            B, NW = ops_k[0].src.shape[:2]
            outs = [torch.empty((B, op.out_len), dtype=op.dtype, device=dev) for op in ops_k]
            d = concat.descriptors(ops_k, outs)

            def run():
                if fn(d, len(ops_k), B, NW, stream):
                    raise SystemExit(f"launch failed for T={T}, P={P}")
            return run, outs

        run, outs = runner(ops)
        run()
        torch.cuda.synchronize()
        if not all(torch.equal(o, w) for o, w in zip(outs, want)):
            raise SystemExit(f"T={T}, P={P}: differs from the plain version")
        r = {"regs": regs, "all": cs._queued_ms(run, 50),
             "all_device": cs._device_ms(run, 30, "concat")}
        for k in range(len(ops)):
            r[f"operand {k}"] = cs._queued_ms(runner([ops[k]])[0], 50)
        r["zero counts"] = cs._queued_ms(runner(zero_ops)[0], 50)
        for label, b in rows.items():
            one = [ops[0]._replace(src=ops[0].src[b:b + 1], src_off=ops[0].src_off[b:b + 1],
                                   counts=ops[0].counts[b:b + 1])]
            r[f"operand 0, the row with the {label} ({int(tot[b])})"] = cs._queued_ms(
                runner(one)[0], 50)
        out[f"{T},{P}"] = r
        print(f"time [{card}]: K2 built with {T} threads, {P} CTAs a row and operand ({regs}): "
              + ", ".join(f"{k} {v:.4f} ms" if isinstance(v, float) else f"{k} {v}"
                          for k, v in r.items() if k != "regs"), flush=True)
    zeros = lambda: [torch.zeros((o.shape), dtype=o.dtype, device=dev) for o in want]  # noqa: E731
    out["torch.zeros of the outputs"] = cs._queued_ms(zeros, 50)
    print(f"time [{card}]: torch.zeros of the three outputs {out['torch.zeros of the outputs']:.4f}"
          " ms")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None, help="another checkout to time beside this one")
    ap.add_argument("--check-only", action="store_true", help="stop after the equality checks")
    ap.add_argument("--sweep", nargs="*", default=[], metavar="T,P",
                    help="time csrc/concat.cu built with CONCAT_THREADS=T, CONCAT_PARTS=P")
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_concat_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # timing helpers and the card's rates
    import torch_cases as tc
    from tpu_zstd_torch.corpus import make_corpus
    from tpu_zstd_torch.ops import _kernels, concat, lz77, pipeline

    card = cs._card_line()
    dev = torch.device("cuda")
    res = {"card": card, "torch": torch.__version__}
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _kernels.library()
    res["build_s"] = _kernels.build_info.get("seconds")
    print(f"build: nvcc {res['build_s']} s, load {time.perf_counter() - t0:.2f} s")
    lines = _kernels.build_info["ptxas"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "concat" in line:
            used = next((x for x in lines[i + 1:i + 5] if "Used" in x), "")
            print("ptxas:", line.split(":")[-1].strip()[:90], "|",
                  used.split("ptxas info    :")[-1].strip())

    def cu(x):
        return torch.from_numpy(np.array(x)).to(dev)

    def same(got, want, label):
        for k, (g, w) in enumerate(zip(got, want)):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                raise SystemExit(f"K2 {label}: operand {k} differs from the plain version")

    def fused_ops(**kw):
        return tc.concat_fused_operands(tc.concat_fused_hard(**kw), cu)

    for label, kw in (("tier-1 shape", {}),
                      ("parse shape", dict(seed=386, B=B, NW=64, W=2048, lit_len=N,
                                           seq_len=32768)),
                      ("W 100, odd lengths", dict(seed=387, B=4, NW=5, W=100, lit_len=1001,
                                                  seq_len=333))):
        ops = fused_ops(**kw)
        same(concat.concat_fused(ops), concat.concat_fused_plain(ops), label)
    hi = tc.concat_fused_hard(seed=388, B=2, NW=8, W=256, lit_len=777, seq_len=131)
    ops = tc.concat_fused_operands(hi, cu)
    shifted = cu(np.concatenate([hi["pk"], hi["pk"][..., :1]], -1))[..., 1:]
    ops[0] = ops[0]._replace(src=shifted)
    ops[2] = ops[2]._replace(src=shifted[..., : hi["SC"]])
    same(concat.concat_fused(ops), concat.concat_fused_plain(ops), "sources off 16 bytes")
    print("K2 == plain version on the hard operands")

    # The operands the parse hands K2 for the DEFAULT_CONFIG batch.
    data = make_corpus(B * N)
    blocks = cu(np.frombuffer(data, dtype=np.uint8).reshape(B, N))
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    seen = []
    fused = lz77.concat_fused

    def spy(ops):
        seen.append(list(ops))
        return fused(ops)

    lz77.concat_fused = spy
    try:
        pipeline._parse_prep_stage(blocks, lengths, pipeline.DEFAULT_CONFIG)
    finally:
        lz77.concat_fused = fused
    torch.cuda.synchronize()
    if len(seen) != 1:
        raise SystemExit(f"expected one K2 call in the parse, saw {len(seen)}")
    ops = seen[0]
    new = concat.concat_fused(ops)
    same(new, concat.concat_fused_plain(ops), "captured DEFAULT_CONFIG operands")
    print("K2 == plain version on the captured DEFAULT_CONFIG operands: "
          + "; ".join(f"{tuple(op.src.shape)} {op.src.dtype} stride {op.src.stride()} -> "
                      f"{op.out_len} {op.dtype}" for op in ops))
    if a.check_only:
        print(json.dumps(res))
        return 0

    def live(op):
        c = op.counts.to(torch.int64)
        start = torch.clamp(torch.cumsum(c, 1) - c, max=op.out_len)
        return torch.minimum(c, op.out_len - start).sum(1)  # live elements a row

    def bound_ms(ops, outs, esize=None):
        """Bytes: live source elements (esize bytes each, else the source's),
        offsets and counts read once, outputs written once."""
        nb = 0
        for op, o in zip(ops, outs):
            moved = int(live(op).sum())
            nb += (moved * (esize or op.src.element_size())
                   + op.counts.numel() * (esize or op.counts.element_size())
                   + o.numel() * (esize or o.element_size())
                   + (0 if op.src_off is None else op.src_off.numel()
                      * (esize or op.src_off.element_size())))
        return nb / cs.HBM_BYTES_PER_S * 1e3, nb

    for k, op in enumerate(ops):
        lv = live(op)
        print(f"operand {k}: live elements a row mean {float(lv.double().mean()):.1f}, max "
              f"{int(lv.max())}, of {op.out_len}")
    res["live_mean"] = [float(live(op).double().mean()) for op in ops]
    res["bound_ms"], res["bound_bytes"] = bound_ms(ops, new)
    # The tree's three launches moved int32 (its wrapper cast offsets and
    # counts to int32; the first launch's offsets are the sequence counts).
    res["old_bound_ms"], res["old_bound_bytes"] = bound_ms(
        [ops[0], ops[1]._replace(src_off=ops[1].counts), ops[2]._replace(src_off=ops[2].counts)],
        new, esize=4)
    run_new = lambda: concat.concat_fused(ops)  # noqa: E731
    res["fused_ms"] = cs._time_ms(run_new, 50)
    res["fused_queued_ms"] = cs._queued_ms(run_new, 50)
    res["fused_device_ms"] = cs._device_ms(run_new, 50, "concat_kernel")
    res["plain_ms"] = cs._time_ms(lambda: concat.concat_fused_plain(ops), 3)
    print(f"time [{card}]: K2 fused on the captured operands {res['fused_ms']:.4f} ms, queued "
          f"{res['fused_queued_ms']:.4f} ms, on the device {cs._fmt_ms(res['fused_device_ms'])}; "
          f"bound {res['bound_ms']:.4f} ms ({res['bound_bytes']} bytes); plain "
          f"{res['plain_ms']:.3f} ms; the one-operand int32 kernel's three launches would be "
          f"bound at {res['old_bound_ms']:.4f} ms ({res['old_bound_bytes']} bytes)")
    if a.sweep:
        res["sweep"] = sweep(a.sweep, ops, concat, cs, card, dev)

    if a.tree:
        tree = pathlib.Path(a.tree).resolve()
        old_pkg = load_tree(tree, "tz_tree")
        old_k = importlib.import_module("tz_tree.ops._kernels")
        old_concat = importlib.import_module("tz_tree.ops.concat")
        old_pipe = importlib.import_module("tz_tree.ops.pipeline")
        t0 = time.perf_counter()
        old_k.library()
        print(f"tree {tree}: kernels from {old_pkg.__file__}, build "
              f"{old_k.build_info.get('seconds')} s, load {time.perf_counter() - t0:.2f} s")
        # The stage as the tree's ops/lz77.py ran it, on the same operands.
        e_pk_w, nseq_w, nlit_w = ops[0].src, ops[0].src_off, ops[0].counts
        key_sc, SC, ew_log, max_seqs = ops[1].src, ops[1].src.shape[2], ops[1].win_shift, \
            ops[1].out_len
        nwin = e_pk_w.shape[1]

        def old_stage():
            startsw = key_sc + (torch.arange(nwin, device=dev) << ew_log)[:, None]
            pkw = e_pk_w[..., :SC]
            zero_w = torch.zeros_like(nseq_w)
            lits = old_concat.concat_varlen((e_pk_w & 0xFF).to(torch.int32), nseq_w, nlit_w,
                                            N).to(torch.uint8)
            starts = old_concat.concat_varlen(startsw.to(torch.int32), zero_w, nseq_w,
                                              max_seqs).to(torch.int64)
            pk_acc = old_concat.concat_varlen(pkw.to(torch.int32), zero_w, nseq_w,
                                              max_seqs).to(torch.int64)
            return lits, starts, pk_acc

        same(old_stage(), new, "the tree's stage against the fused call")
        x_lit = (e_pk_w & 0xFF).to(torch.int32)
        x_st = (key_sc + (torch.arange(nwin, device=dev) << ew_log)[:, None]).to(torch.int32)
        x_pk = e_pk_w[..., :SC].to(torch.int32)
        zero_w = torch.zeros_like(nseq_w)

        def old_launches():
            old_concat.concat_varlen(x_lit, nseq_w, nlit_w, N)
            old_concat.concat_varlen(x_st, zero_w, nseq_w, max_seqs)
            old_concat.concat_varlen(x_pk, zero_w, nseq_w, max_seqs)

        old_k.reset_launches()
        old_launches()
        if old_k.launches["concat"] != 3:
            raise SystemExit(f"the tree's K2 launched {old_k.launches['concat']} times, not 3")
        # Rounds in turns (tree, this, this, tree) for each timing.
        rounds = {"old_launches_ms": [], "old_stage_ms": [], "fused_ms_rounds": []}
        for order in (0, 1, 1, 0):
            if order == 0:
                rounds["old_launches_ms"].append(cs._time_ms(old_launches, 50))
                rounds["old_stage_ms"].append(cs._time_ms(old_stage, 50))
            else:
                rounds["fused_ms_rounds"].append(cs._time_ms(run_new, 50))
        res.update(rounds)
        res["old_launches_device_ms"] = cs._device_ms(old_launches, 50, "concat_varlen_kernel")
        res["old_stage_device_ms"] = cs._device_ms(old_stage, 50, "")
        res["fused_stage_device_ms"] = cs._device_ms(run_new, 50, "")
        print(f"time [{card}]: the tree's K2 three launches on the same operands (int32 "
              f"copies made beforehand) {rounds['old_launches_ms']} ms (on the device "
              f"{cs._fmt_ms(res['old_launches_device_ms'])}); the tree's K2 stage (casts, "
              f"window add, zeroed outputs, three launches, casts back) {rounds['old_stage_ms']}"
              f" ms (every kernel on the device {cs._fmt_ms(res['old_stage_device_ms'])}); the "
              f"fused call (this tree's whole stage) {rounds['fused_ms_rounds']} ms (on the "
              f"device {cs._fmt_ms(res['fused_stage_device_ms'])})")

        # The three batches with the tree's pipeline and this one's in turns.
        from tpu_zstd_torch.api.config import CompressionConfig
        from tpu_zstd_torch.api.manager import _pipeline_config

        cfgs = {"DEFAULT_CONFIG": (pipeline.DEFAULT_CONFIG, 5),
                "SLICE_CONFIG": (pipeline.SLICE_CONFIG, 5),
                "level 19": (_pipeline_config(CompressionConfig.from_level(19)), 3)}

        def batch_ms(pipe, cfg, reps):
            pipe.compress_blocks_staged(blocks, lengths, cfg)
            torch.cuda.synchronize()
            dt = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                outs = pipe.compress_blocks_staged_many([(blocks, lengths)] * reps, cfg)
                torch.stack([o[1] for o in outs]).cpu()
                dt = min(dt, (time.perf_counter() - t0) / reps)
            return dt * 1e3

        res["batches_ms"] = {}
        for label, (cfg, reps) in cfgs.items():
            old_cfg = old_pipe.PipelineConfig(**{f: getattr(cfg, f) for f in
                                                 cfg.__dataclass_fields__})
            mine = pipeline.compress_blocks_staged(blocks, lengths, cfg)
            theirs = old_pipe.compress_blocks_staged(blocks, lengths, old_cfg)
            if not all(torch.equal(x, y) for x, y in zip(mine, theirs)):
                raise SystemExit(f"{label}: the two trees' blocks differ")
            del mine, theirs
            times = []
            for order in (0, 1, 1, 0):
                times.append(batch_ms(old_pipe if order == 0 else pipeline,
                                      old_cfg if order == 0 else cfg, reps))
            res["batches_ms"][label] = {"tree": [times[0], times[3]], "this": times[1:3]}
            print(f"time [{card}]: {label} batch, the tree / this / this / the tree: "
                  f"{' / '.join(f'{t:.3f}' for t in times)} ms (pipelined over {reps} batches, "
                  f"best of 2; blocks equal)")
    line = json.dumps(res)
    if a.out:
        pathlib.Path(a.out).mkdir(parents=True, exist_ok=True)
        (pathlib.Path(a.out) / "concat_bench.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
