#!/usr/bin/env python3
"""K12 (`sort_rows`) and K13 (`match_windows`) of the PyTorch port on one
CUDA card: equality with their plain versions, then times and bounds.

    python3 tools/torch_sort_bench.py [--tree DIR] [--out DIR]

Builds the port's kernels (seconds and the assembler's report for K12 and
K13), holds both kernels against their plain versions (exact equality) on
the hard sets of tests/torch_cases.py (`SORT_HARD`, `MATCH_HARD`) at widths
1024, 8192, 16384, 32768 and 65536, on one K12 row of 2^20 columns, on
seeded K12 rows with 0-3 payloads and on low-entropy K13 windows at the
three level shapes, and with 33 and 35 payloads (two launches: 32 payloads
a launch); then times each kernel by CUDA events over back-to-back
calls, by CUDA events with the calls queued behind a spin kernel, and on
the device (torch.profiler), at the shapes of `chip_smoke.py` phase 2: K12
with 1 and 3 operands at 2048 x 8192, 512 x 32768 and 256 x 65536 beside
`torch.sort` + `torch.gather`, K13 at the level-1/3/5 shapes (2048 x 8192)
and at 256 x 65536. Each time stands beside its bound, the larger of the
bytes the function must move (each operand read once, each output written
once, over 3.35 TB/s) and, for K13, the int32 operations its depth compares
need on these inputs; "network ops" is the int32 operations of one bitonic
network (4 a compare-exchange) over the card's int32 rate, the bound the
port used before. With --tree DIR the kernels are the checkout in DIR (an
earlier commit unpacked with `git archive`, say); the inputs always come
from this checkout. The last line is one JSON object of the numbers; --out
also writes it to DIR/sort_bench.json.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--out", default=None)
    ap.add_argument("--times-only", action="store_true", help="skip the equality checks")
    a = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sort_bench: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "tests"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs  # timing helpers and the card's rates
    import torch_cases as tc

    sys.path.insert(0, str(pathlib.Path(a.tree).resolve()))
    for m in [m for m in sys.modules if m.startswith("tpu_zstd_torch")]:
        del sys.modules[m]
    from tpu_zstd_torch.ops import _kernels, match, sort

    card = cs._card_line()
    dev = torch.device("cuda")
    res = {"card": card, "tree": a.tree, "kernels_file": _kernels.__file__}
    print(f"card: {card} | torch {torch.__version__} | kernels from {_kernels.__file__}")
    t0 = time.perf_counter()
    _kernels.library()
    info = _kernels.build_info
    res["build_s"] = info.get("seconds")
    print(f"build: nvcc {res['build_s']} s, load {time.perf_counter() - t0:.2f} s")
    lines = info["ptxas"].splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line and ("sort" in line or "match" in line or "merge" in line
                                          or "wide" in line):
            used = next((x for x in lines[i + 1:i + 5] if "Used" in x), "")
            print("ptxas:", line.split(":")[-1].strip()[:90], "|",
                  used.split("ptxas info    :")[-1].strip())

    def cu(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def equal(kern, plain, args, label):
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        for x, y in zip(got, want):
            if not torch.equal(x, y):
                bad = int((x != y).sum())
                raise SystemExit(f"torch_sort_bench: FAIL {label}: {bad} elements differ")

    def by_kernel(fn, iters=10):
        """Device milliseconds a call, by kernel name (torch.profiler)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").split("(")[0]
                name = name.split("<")[0].removeprefix("void ")[-40:]
                out[name] = out.get(name, 0.0) + e.device_time_total / iters / 1e3
        return {k: round(v, 4) for k, v in sorted(out.items(), key=lambda kv: -kv[1])}

    # --- equality -----------------------------------------------------------------------
    t0 = time.perf_counter()
    n_checked = 0
    rng = np.random.default_rng(5)
    for W in (() if a.times_only else (1024, 8192, 16384, 32768, 65536)):
        for c, (kinds, P, _) in enumerate(tc.SORT_HARD):
            ops = [cu(x) for x in tc.sort_hard_ops(W, kinds, P, c)]
            equal(sort.sort_rows, sort.sort_rows_plain, ops, f"K12 hard {kinds} P {P} W {W}")
            n_checked += 1
        for c, (kinds, depth, nw, _) in enumerate(tc.MATCH_HARD):
            m = tc.match_hard_inputs(W, kinds, depth, nw, c)
            args = (cu(m["key"]), cu(m["words"]), depth, m["sentinel"])
            equal(match.match_windows, match.match_windows_plain, args,
                  f"K13 hard {kinds} depth {depth} words {nw} W {W}")
            n_checked += 1
    if not a.times_only:
        big = [cu(x) for x in tc.sort_hard_ops(1 << 20, ("extremes_random",), 1, 9)]
        equal(sort.sort_rows, sort.sort_rows_plain, big, "K12 one row of 2^20")
        del big
    seeded_sort = ((2, 1024, 0), (2, 2048, 1), (3, 4096, 2), (64, 8192, 3), (4, 16384, 3),
                   (2, 32768, 0), (2, 131072, 2), (3, 1024, 35), (2, 16384, 33))
    for R, W, P in () if a.times_only else seeded_sort:
        key = rng.permuted(np.tile(np.arange(W, dtype=np.int32), (R, 1)), axis=1) * 3 - W
        ops = [cu(key)] + [cu(rng.integers(-2**31, 2**31, (R, W)).astype(np.int32))
                           for _ in range(P)]
        equal(sort.sort_rows, sort.sort_rows_plain, ops, f"K12 seeded ({R}, {W}) P {P}")
        n_checked += 1
    seeded_match = ((2, 1024, 2, 2, 12), (2, 4096, 8, 3, 13), (2048, 8192, 3, 4, 15),
                    (2048, 8192, 8, 2, 17), (2048, 8192, 8, 16, 17), (4, 16384, 8, 2, 14),
                    (4, 65536, 8, 4, 14))
    for R, W, depth, nw, hl in () if a.times_only else seeded_match:
        k, w = tc.lowent_windows(rng, R, W, nw, hl)
        equal(match.match_windows, match.match_windows_plain, (cu(k), cu(w), depth, 1 << hl),
              f"K13 seeded ({R}, {W}) depth {depth} words {nw}")
        n_checked += 1
    print(f"equality: {n_checked} calls and the 2^20 row, kernel == plain "
          f"({time.perf_counter() - t0:.1f} s)")

    # --- times ----------------------------------------------------------------------------
    rows = []
    for R, W, P in ((2048, 8192, 0), (2048, 8192, 2), (512, 32768, 0), (512, 32768, 2),
                    (256, 65536, 0), (256, 65536, 2)):
        key = rng.permuted(np.tile(np.arange(W, dtype=np.int32), (R, 1)), axis=1) * 3 - W
        ops = [cu(key)] + [cu(rng.integers(-2**31, 2**31, (R, W)).astype(np.int32))
                           for _ in range(P)]
        run = lambda: sort.sort_rows(*ops)  # noqa: E731
        row = {"kernel": "sort", "shape": [R, W], "operands": P + 1,
               "ms": cs._time_ms(run, 20), "queued_ms": cs._queued_ms(run, 20),
               "device_ms": cs._device_ms(run, 10,
                                          cs.SORT_KERNELS + ("gather_payloads", "wide_")),
               "library_ms": cs._time_ms(lambda: cs.sort_library(*ops), 20),
               "bound_ms": cs.sort_bound_ms(ops), "bound_by": "bytes",
               "network_ops_ms": cs.network_ms(R, W), "by_kernel": by_kernel(run)}
        rows.append(row)
        print(f"time [{card}]: K12 ({R}, {W}) x {P + 1} operands {row['ms']:.4f} ms, queued "
              f"{row['queued_ms']:.4f}, on the device {cs._fmt_ms(row['device_ms'])}; library "
              f"{row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms (bytes), network ops "
              f"{row['network_ops_ms']:.4f} ms; by kernel {row['by_kernel']}")
        del ops
    for R, W, depth, nw, hl, label in ((2048, 8192, 3, 4, 15, "level 1"),
                                       (2048, 8192, 8, 2, 17, "level 3"),
                                       (2048, 8192, 8, 16, 17, "level 5"),
                                       (256, 65536, 8, 2, 14, "tiled")):
        k, w = tc.lowent_windows(rng, R, W, nw, hl)
        args = (cu(k), cu(w), depth, 1 << hl)
        run = lambda: match.match_windows(*args)  # noqa: E731
        b_ms, b_by = cs.match_bound_ms(*args)
        row = {"kernel": "match", "shape": [R, W], "label": label, "depth": depth, "words": nw,
               "ms": cs._time_ms(run, 20), "queued_ms": cs._queued_ms(run, 20),
               "device_ms": cs._device_ms(run, 10, cs.MATCH_KERNELS + ("wide_",)),
               "plain_ms": (None if a.times_only else
                            cs._time_ms(lambda: match.match_windows_plain(*args), 2)),
               "bound_ms": b_ms, "bound_by": b_by, "network_ops_ms": cs.network_ms(R, W),
               "by_kernel": by_kernel(run)}
        rows.append(row)
        print(f"time [{card}]: K13 {label} ({R}, {W}) depth {depth} words {nw} {row['ms']:.4f} "
              f"ms, queued {row['queued_ms']:.4f}, on the device {cs._fmt_ms(row['device_ms'])}; "
              f"plain {cs._fmt_ms(row['plain_ms'])}; bound {row['bound_ms']:.4f} ms "
              f"({b_by}), network ops {row['network_ops_ms']:.4f} ms; by kernel {row['by_kernel']}")
        del args
    res["rows"] = rows
    if a.out:
        out = pathlib.Path(a.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "sort_bench.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
