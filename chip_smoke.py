#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (tpu_zstd_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card and build: the card's name and power limit, the nvcc build of the
   four kernels in tpu_zstd_torch/csrc (seconds, registers, shared memory).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes (B = 128) on seeded inputs: exact equality.
3. The main path at full width: the 16 MiB bench batch (128 x 128 KB) through
   `compress_blocks_staged_many` at SLICE_CONFIG, with every kernel's launch
   count set to 0 just before and read just after; every block's
   (type, length, sha256) and the 4-block `compress` frame against
   tests/golden/torch_slice1.json (made by tools/make_torch_goldens.py from
   the JAX reference). The inputs each kernel received in that run are
   captured, and each kernel is held against its plain version on them.
4. Times on the card: the pipelined batch (5 batches, best of 2), peak
   device memory, the parse and encode stages, and per kernel its time by
   CUDA events, its bound and its plain version's time.

The last two lines are one JSON object of per-kernel numbers and one JSON
object {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
B, N = 128, 131072


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call by CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tpu_zstd_torch.corpus import make_corpus
    from tpu_zstd_torch.ops import _kernels, bitpack, concat, greedy, lz77, rep, roll
    from tpu_zstd_torch.ops.fse import encode_sequences_predefined
    from tpu_zstd_torch.ops.pipeline import (
        SLICE_CONFIG,
        _parse_prep_stage,
        _pick_bucket,
        compress,
        compress_blocks_staged,
        compress_blocks_staged_many,
    )

    golden = json.loads((ROOT / "tests" / "golden" / "torch_slice1.json").read_text())
    dev = torch.device("cuda")
    cfg = SLICE_CONFIG
    card = _card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # --- 1. build ------------------------------------------------------------------
    t0 = time.perf_counter()
    _kernels.library()
    info = _kernels.build_info
    built = f"nvcc {info['seconds']:.2f} s" if "seconds" in info else "library already built"
    print(f"build: {built}; load {time.perf_counter() - t0:.2f} s -> {info['library']}")
    for line in info["ptxas"].splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("ptxas:", line.split("ptxas info    :")[-1].strip())

    # Kernel table: name -> (wrapper, plain, source, TPU kernel it replaces).
    K = {
        "roll": (roll.roll_rows, roll.roll_rows_plain, "tpu_zstd_torch/csrc/roll.cu",
                 "tpu_zstd/ops/pallas_roll.py:98 roll_rows"),
        "concat": (concat.concat_varlen, concat.concat_varlen_plain,
                   "tpu_zstd_torch/csrc/concat.cu", "tpu_zstd/ops/pallas_concat.py:129 concat_varlen"),
        "greedy": (greedy.greedy_segments, greedy.greedy_segments_plain,
                   "tpu_zstd_torch/csrc/greedy.cu", "tpu_zstd/ops/pallas_greedy.py:79 greedy_segments"),
        "rep": (rep.rep_codes, rep.rep_codes_plain, "tpu_zstd_torch/csrc/rep.cu",
                "tpu_zstd/ops/pallas_rep.py:137 rep_codes"),
    }
    max_err = {k: 0 for k in K}

    def hold(name: str, args: tuple, label: str) -> None:
        kern, plain = K[name][0], K[name][1]
        a = kern(*args)
        b = plain(*args)
        torch.cuda.synchronize()
        if a.shape != b.shape or a.dtype != b.dtype:
            _fail(f"{name} {label}: kernel {a.shape}/{a.dtype} vs plain {b.shape}/{b.dtype}")
        err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
        max_err[name] = max(max_err[name], err)
        if err != 0:
            _fail(f"{name} {label}: kernel differs from plain version (max abs err {err})")

    # --- 2. kernels vs plain, seeded inputs ---------------------------------------------
    rng = np.random.default_rng(1234)

    def cu(a):
        return torch.from_numpy(np.array(a)).to(dev)

    t0 = time.perf_counter()
    hold("roll", (cu(rng.integers(0, 256, (B, N), dtype=np.uint8)),
                  cu(rng.integers(0, N, B))), "u8 (128, 131072)")
    hold("roll", (cu(rng.integers(-2**31, 2**31, (B, 32768), dtype=np.int32)),
                  cu(rng.integers(0, 32768, B))), "i32 (128, 32768)")
    for W, out_len in ((2048, N), (512, 32768), (512, 16384)):
        off = rng.integers(0, W, (B, 64))
        cnt = rng.integers(0, W - off + 1)
        hold("concat", (cu(rng.integers(0, 1 << 30, (B, 64, W), dtype=np.int32)),
                        cu(off.astype(np.int32)), cu(cnt.astype(np.int32)), out_len),
             f"(128, 64, {W}) -> {out_len}")
    seg, S = 1024, B * N // 1024
    step = rng.integers(1, 40, (S, seg))
    step = np.minimum(step, seg - np.arange(seg))
    matched = (rng.random((S, seg)) < 0.4) & (step >= 4)
    defer = (rng.random((S, seg)) < 0.1) & matched
    hold("greedy", (cu((step | matched << 11 | defer << 12).astype(np.int32)),), "(16384, 1024)")
    rows = 32768
    offs = np.where(rng.random((B, rows)) < 0.5, rng.integers(1, 6, (B, rows)),
                    rng.integers(1, 1 << 21, (B, rows)))
    valid = np.arange(rows)[None, :] < rng.integers(0, rows + 1, (B, 1))
    packed = np.where(valid, offs | (rng.integers(0, 2, (B, rows)) << 21) | (1 << 22), 0)
    hold("rep", (cu(packed.astype(np.int32)),), "(128, 32768)")
    print(f"phase 2: kernels == plain versions on seeded inputs ({time.perf_counter() - t0:.1f} s)")

    # --- 3. main path at full width ---------------------------------------------------
    data = make_corpus(B * N)
    blocks = cu(np.frombuffer(data, dtype=np.uint8).reshape(B, N))
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)

    captured: dict[str, dict] = {k: {} for k in K}
    sites = {"roll": (bitpack, "roll_rows"), "concat": (lz77, "concat_varlen"),
             "greedy": (lz77, "greedy_segments"), "rep": (lz77, "rep_codes")}
    originals = {k: getattr(mod, attr) for k, (mod, attr) in sites.items()}

    def recorder(name):
        fn = originals[name]

        def call(*args):
            key = tuple((tuple(a.shape), str(a.dtype)) if torch.is_tensor(a) else a for a in args)
            if key not in captured[name]:
                captured[name][key] = [tuple(a.clone() if torch.is_tensor(a) else a for a in args), 0]
            captured[name][key][1] += 1
            return fn(*args)

        return call

    for k, (mod, attr) in sites.items():
        setattr(mod, attr, recorder(k))
    t0 = time.perf_counter()
    _kernels.reset_launches()
    outs = compress_blocks_staged_many([(blocks, lengths)], cfg)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    t_first = time.perf_counter() - t0
    for k, (mod, attr) in sites.items():
        setattr(mod, attr, originals[k])
    print(f"phase 3: main path launches {launches} (first batch {t_first:.2f} s)")
    for k, n_launch in launches.items():
        if n_launch <= 0:
            _fail(f"kernel {k} was not launched on the main path")

    contents, clens, btypes = (t.cpu().numpy() for t in outs[0])
    gb = golden["batch"]["blocks"]
    if len(gb) != B:
        _fail(f"golden has {len(gb)} blocks")
    bad = [
        b for b in range(B)
        if (int(btypes[b]), int(clens[b]),
            hashlib.sha256(contents[b, : int(clens[b])].tobytes()).hexdigest())
        != (gb[b]["btype"], gb[b]["clen"], gb[b]["sha256"])
    ]
    if bad:
        _fail(f"{len(bad)} of {B} blocks differ from the JAX golden (first: {bad[:8]})")
    body = int(clens.sum())
    counts = {t: int((btypes == t).sum()) for t in (0, 1, 2)}
    print(f"phase 3: all {B} blocks == JAX golden; btypes raw/rle/comp {counts}; "
          f"block-body ratio {B * N / body:.4f}")

    small = make_corpus(4 * N)
    frame = compress(small, cfg, device="cuda")
    sha = hashlib.sha256(frame).hexdigest()
    if (len(frame), sha) != (golden["frame"]["len"], golden["frame"]["sha256"]):
        _fail(f"4-block frame differs from the JAX golden ({len(frame)} bytes, {sha})")
    print(f"phase 3: compress(make_corpus(4 * 131072)) frame == JAX golden ({len(frame)} bytes)")

    t0 = time.perf_counter()
    n_real = 0
    for k, inputs in captured.items():
        for key, (args, _) in inputs.items():
            hold(k, args, f"real {key}")
            n_real += 1
    print(f"phase 3: kernels == plain versions on {n_real} captured main-path inputs "
          f"({time.perf_counter() - t0:.1f} s)")

    # --- 4. times ----------------------------------------------------------------------
    REPS = 5
    compress_blocks_staged(blocks, lengths, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        outs = compress_blocks_staged_many([(blocks, lengths)] * REPS, cfg)
        torch.stack([o[1] for o in outs]).cpu()
        dt = min(dt, (time.perf_counter() - t0) / REPS)
    peak = torch.cuda.max_memory_allocated()
    print(f"time [{card}]: batch 128x128KB {dt * 1e3:.3f} ms = {B * N / dt / 1e9:.4f} GB/s "
          f"(pipelined over {REPS} batches, best of 2); peak device memory {peak / 2**30:.3f} GiB")

    seqs, nseq = _parse_prep_stage(blocks, lengths, cfg)
    msb = _pick_bucket(int(nseq.max()), cfg.max_seqs)
    parse_ms = _time_ms(lambda: _parse_prep_stage(blocks, lengths, cfg), 3)
    enc_ms = _time_ms(lambda: encode_sequences_predefined(
        seqs.ll[:, :msb], seqs.ml[:, :msb], seqs.ob[:, :msb], seqs.nseq, msb,
        cfg.seq_cap_for(msb)), 3)
    print(f"time [{card}]: parse stage {parse_ms:.3f} ms; sequence encode (bucket {msb}, "
          f"state chains + deposit) {enc_ms:.3f} ms")

    def nbytes(t):
        return t.numel() * t.element_size()

    def bound(name, args, out_numel_bytes):
        if name == "concat":
            x, off, cnt, out_len = args
            c = cnt.to(torch.int64)
            start = torch.clamp(torch.cumsum(c, 1) - c, max=out_len)
            moved = int(torch.minimum(c, out_len - start).sum())
            return (moved * 4 + nbytes(off) + nbytes(cnt) + out_numel_bytes) / HBM_BYTES_PER_S * 1e3
        return (sum(nbytes(a) for a in args if torch.is_tensor(a)) + out_numel_bytes) \
            / HBM_BYTES_PER_S * 1e3

    # Every captured main-path shape is timed; `ms_per_batch` sums the
    # kernel's time over its launches in one batch. The JSON row reports the
    # representative shape: K1's byte roll at the block width, else the
    # largest input.
    rows_out = []
    for name, (kern, plain, source, replaces) in K.items():
        per_batch = 0.0
        row = None
        for key, (args, n_calls) in sorted(captured[name].items(),
                                            key=lambda kv: -nbytes(kv[1][0][0])):
            out = kern(*args)
            ms = _time_ms(lambda: kern(*args), 20)
            plain_ms = _time_ms(lambda: plain(*args), 1 if name == "rep" else 3)
            b_ms = bound(name, args, nbytes(out))
            per_batch += n_calls * ms
            print(f"kernel [{card}] {name} {key[0]} x{n_calls}/batch: {ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms, plain {plain_ms:.3f} ms")
            if row is None or key[0] == ((B, N), "torch.uint8"):
                row = {
                    "name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": max_err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes",
                    "library_ms": None, "shape": f"{key[0][0]} {key[0][1]}",
                }
        row["ms_per_batch"] = per_batch
        rows_out.append(row)
        print(f"kernel [{card}] {name}: {per_batch:.4f} ms per batch over {launches[name]} launches")
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
