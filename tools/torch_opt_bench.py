#!/usr/bin/env python3
"""K10 (`opt_steps`, the level-19 segment DP) of the PyTorch port on one CUDA
card: equality with its plain version, the path each call took, then times
and bounds.

    python3 tools/torch_opt_bench.py [--tree DIR] [--out DIR]

Builds the port's kernels (seconds for the library and for `csrc/opt.cu`
alone, and the assembler's report for K10), captures the input the
level-19 pipeline hands `opt_steps` for the bench batch (128 x 128 KB:
16384 segments of 1024, mm 3, cap 64), then holds the kernel against its
plain version (exact equality) on the calls of tests/torch_cases.py
`opt_card_calls` (the hard calls, the fast-path calls, the seeded rows and
the rows that offer every length, the list chip_smoke.py phase 2 holds) and
on the captured input, and prints how many rows of each call its fast path
walked. It prints how many steps differ on each call and goes on; the exit
code is 1 if any call differed or a fast-path call left the fast path.

Where the tree's `csrc/opt.cu` has a fast path that a build with
-DOPT_FAST_PRICE=0 turns off, it also builds that exact-path-only kernel,
holds it on the same calls and times it beside the shipped kernel in
alternating rounds, so that the fast path's own gain can be set against the
rounds' spread.

Then it times the kernel by CUDA events over back-to-back calls, queued
behind a spin kernel and on the device (torch.profiler), on the captured
input, on rows that offer every length and on the seeded rows, beside its
bound (chip_smoke.opt_bound_ms) and, on the captured input, the plain
version's time. It also gives the lengths the captured input offers: per
position, and the most over the rows that walk together (32 rows of one
warp in a one-thread-a-row walk; `32 / G` rows of a warp whose rows take G
lanes each, in length iterations of G lengths).

With --tree DIR the kernels and the pipeline are the checkout in DIR (an
earlier commit unpacked with `git archive`, say); the calls always come from
this checkout, and the captured input's sha256 is printed so that two runs
can be seen to time the same input. The last line is one JSON object of the
numbers; --out also writes it to DIR/opt_bench.json.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import inspect
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
ROUNDS = 3  # alternating rounds of the shipped and the exact-path-only kernel


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_opt_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # timing helpers, the card's rates, K10's bound
    import torch_cases as tc

    tree = pathlib.Path(a.tree).resolve()
    sys.path.insert(0, str(tree))
    for m in [m for m in sys.modules if m.startswith("tpu_zstd_torch")]:
        del sys.modules[m]
    from tpu_zstd_torch.api.config import CompressionConfig
    from tpu_zstd_torch.api.manager import _pipeline_config
    from tpu_zstd_torch.corpus import make_corpus
    from tpu_zstd_torch.ops import _kernels, lz77, opt
    from tpu_zstd_torch.ops.pipeline import compress_blocks_staged_many

    card = cs._card_line()
    dev = torch.device("cuda")
    res = {"card": card, "tree": a.tree, "kernels_file": _kernels.__file__}
    print(f"card: {card} | torch {torch.__version__} | kernels from {_kernels.__file__}")

    # --- build ------------------------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.library()
    info = _kernels.build_info
    res["build_s"] = info.get("seconds")
    src = _kernels.CSRC_DIR / "opt.cu"

    def nvcc(*extra):
        t = time.perf_counter()
        r = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, *extra, str(src)],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise SystemExit(f"torch_opt_bench: nvcc opt.cu failed:\n{r.stdout}\n{r.stderr}")
        return time.perf_counter() - t, r

    t1 = time.perf_counter()
    res["opt_build_s"], nv = nvcc("-c", "-o", str(_kernels.BUILD_DIR / "opt_alone.o"))
    print(f"build: library nvcc {res['build_s']} s (load {t1 - t0:.2f} s); csrc/opt.cu alone "
          f"{res['opt_build_s']:.2f} s")
    lines = (nv.stdout + nv.stderr).splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line:
            used = next((x for x in lines[i + 1:i + 5] if "Used" in x), "")
            print("ptxas:", line.split(":")[-1].strip()[:90], "|",
                  used.split("ptxas info    :")[-1].strip())

    has_stats = "stats" in inspect.signature(opt.opt_steps).parameters
    exact_lib = None
    if "#ifndef OPT_FAST_PRICE" in src.read_text():
        so = _kernels.BUILD_DIR / "opt_exact_only.so"
        secs, _ = nvcc("-DOPT_FAST_PRICE=0", "-shared", "-o", str(so))
        exact_lib = ctypes.CDLL(str(so))
        exact_lib.tz_opt_steps.argtypes = list(_kernels.SIGNATURES["tz_opt_steps"])
        exact_lib.tz_opt_steps.restype = ctypes.c_int
        print(f"build: csrc/opt.cu with -DOPT_FAST_PRICE=0 (exact path only) {secs:.2f} s")

    def exact_only(packed, mm, cap, lit_bits=None, cost_bank=None):
        lit, bank = opt._operands(packed, mm, cap, lit_bits, cost_bank)
        out = torch.empty_like(packed)
        err = exact_lib.tz_opt_steps(packed.data_ptr(), lit.data_ptr(), bank.data_ptr(),
                                     out.data_ptr(), None, *packed.shape, mm, cap,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"exact-path-only tz_opt_steps: CUDA error {err}")
        return out

    def cu(x):
        return torch.from_numpy(np.array(x)).to(dev)

    def call_of(c):
        return ((cu(c["packed"]), c["mm"], c["cap"]),
                {"lit_bits": cu(c["lit"]), "cost_bank": cu(c["bank"])})

    # --- the captured level-19 input ----------------------------------------------------
    B, N = 128, 131072
    blocks = cu(np.frombuffer(make_corpus(B * N), dtype=np.uint8).reshape(B, N))
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    seen = []
    orig = lz77.opt_steps

    def spy(packed, mm, cap, **kw):
        seen.append(((packed.clone(), mm, cap), {k: v.clone() for k, v in kw.items()}))
        return orig(packed, mm, cap, **kw)

    lz77.opt_steps = spy
    try:
        compress_blocks_staged_many([(blocks, lengths)],
                                    _pipeline_config(CompressionConfig.from_level(19)))
        torch.cuda.synchronize()
    finally:
        lz77.opt_steps = orig
    del blocks
    (cap_args, cap_kw), = seen
    res["captured_sha256"] = hashlib.sha256(cap_args[0].cpu().numpy().tobytes()).hexdigest()
    print(f"captured: packed {tuple(cap_args[0].shape)} mm {cap_args[1]} cap {cap_args[2]}, "
          f"sha256 {res['captured_sha256'][:16]}")

    # Lengths the captured input offers, per position and over rows walked together.
    x = cap_args[0].to(torch.int64)
    mm, capl = cap_args[1], cap_args[2]
    tried = torch.clamp(torch.clamp(torch.maximum(x & 127, (x >> 12) & 127), max=capl)
                        - mm + 1, min=0)
    S, seg = tried.shape
    lens = {"mean": float(tried.float().mean()),
            "max_over_32_rows": float(tried.reshape(-1, 32, seg).amax(1).float().mean())}
    for g in (2, 4, 8):
        it = (tried + g - 1) // g
        lens[f"iterations_G{g}"] = float(it.float().mean())
        lens[f"iterations_G{g}_max_over_{32 // g}_rows"] = float(
            it.reshape(-1, 32 // g, seg).amax(1).float().mean())
    res["captured_lengths"] = lens
    print(f"captured lengths a position: {lens}")

    # --- equality and paths -------------------------------------------------------------
    calls = {label: call_of(c) for label, c in tc.opt_card_calls(B)}
    calls["captured level 19"] = (cap_args, cap_kw)
    t0 = time.perf_counter()
    diffs, exact_diffs, paths, bad = {}, {}, {}, []
    for label, (args, kw) in calls.items():
        want = opt.opt_steps_plain(*args, **kw)
        st = torch.zeros(args[0].shape[0], dtype=torch.int32, device=dev)
        got = opt.opt_steps(*args, **kw, **({"stats": st} if has_stats else {}))
        diffs[label] = int((got != want).sum())
        if exact_lib is not None:
            exact_diffs[label] = int((exact_only(*args, **kw) != want).sum())
        if has_stats:
            paths[label] = [int(st.sum()), st.numel()]
            if label.startswith("fast") and paths[label][0] != st.numel():
                bad.append(label)
        for what, d in (("kernel", diffs), ("exact-path-only kernel", exact_diffs)):
            if d.get(label):
                print(f"equality: {label}: {what}: {d[label]} steps differ from the plain version")
    res.update(differing_steps=diffs, exact_only_differing_steps=exact_diffs, fast_rows=paths)
    print(f"equality: {len(calls)} calls, {sum(1 for v in diffs.values() if v)} differ, "
          f"exact-path-only {sum(1 for v in exact_diffs.values() if v)} differ "
          f"({time.perf_counter() - t0:.1f} s)")
    if has_stats:
        print("paths: rows walked on the fast path: "
              + "; ".join(f"{k} {v[0]}/{v[1]}" for k, v in paths.items()))
    if bad:
        print(f"paths: fast-path calls that left the fast path: {bad}")

    # --- times ------------------------------------------------------------------------
    rows = []
    for label in ("captured level 19", "every length", "seeded mm 3 cap 64",
                  "seeded mm 4 cap 16"):
        args, kw = calls[label]
        run = lambda: opt.opt_steps(*args, **kw)  # noqa: E731
        b_ms, b_by = cs.opt_bound_ms(*args, kw["lit_bits"], kw["cost_bank"])
        row = {"input": label, "shape": list(args[0].shape), "mm": args[1], "cap": args[2],
               "ms": cs._time_ms(run, 20), "queued_ms": cs._queued_ms(run, 20),
               "device_ms": cs._device_ms(run, 10, "opt_"), "bound_ms": b_ms, "bound_by": b_by}
        if exact_lib is not None:
            both = [(cs._time_ms(run, 20), cs._time_ms(lambda: exact_only(*args, **kw), 20))
                    for _ in range(ROUNDS)]
            row["rounds_ms"] = [t for t, _ in both]
            row["exact_only_rounds_ms"] = [t for _, t in both]
        if label == "captured level 19":
            row["plain_ms"] = cs._time_ms(lambda: opt.opt_steps_plain(*args, **kw), 1)
        rows.append(row)
        print(f"time [{card}]: K10 {label} {tuple(args[0].shape)} mm {args[1]} cap {args[2]}: "
              f"{row['ms']:.4f} ms, queued {row['queued_ms']:.4f}, on the device "
              f"{cs._fmt_ms(row['device_ms'])}; bound {b_ms:.4f} ms ({b_by})"
              + (f"; plain {row['plain_ms']:.3f} ms" if "plain_ms" in row else ""))
        if exact_lib is not None:
            print(f"time [{card}]: K10 {label}: rounds shipped / exact path only (ms): "
                  + ", ".join(f"{f:.4f} / {e:.4f}" for f, e in both))
    res["rows"] = rows
    if a.out:
        out = pathlib.Path(a.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "opt_bench.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 1 if any(diffs.values()) or any(exact_diffs.values()) or bad else 0


if __name__ == "__main__":
    sys.exit(main())
