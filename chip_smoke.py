#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (tpu_zstd_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card and build: the card's name and power limit, the nvcc build of the
   kernels in tpu_zstd_torch/csrc (seconds, registers, shared memory).
2. Each kernel (K1-K5) against its plain PyTorch version on the card, at the
   main paths' shapes (B = 128) on seeded inputs: exact equality (K5 on its
   live range: 1 <= t < nseq and the flush state).
3. The first slice's path at full width: the 16 MiB bench batch
   (128 x 128 KB) through `compress_blocks_staged_many` at SLICE_CONFIG, the
   launch counts set to 0 just before and read just after; every block's
   (type, length, sha256) and the 4-block `compress` frame against
   tests/golden/torch_slice1.json; each kernel against its plain version on
   the inputs it received in that run. Then the batch time.
4. The DEFAULT_CONFIG path (Huffman literals, custom FSE tables, K5) at full
   width, counts set to 0 just before and read just after: every block
   against tests/golden/torch_slice2.json, the 4-block `compress` frame with
   checksum=True and the frames of `BatchManager(level=3).compress_batch`
   over 16 items of 64-256 KB against the same file, each frame decoded by
   stock libzstd (`zstandard`) where it is installed; each kernel against
   its plain version on the inputs it received in that run.
5. Times on the card at DEFAULT_CONFIG: the pipelined batch (5 batches, best
   of 2), peak device memory, the parse and encode stages, and per kernel
   its time by CUDA events at every captured shape, its bound and its plain
   version's time.

The goldens come from tools/make_torch_goldens.py (the JAX package on the
CPU). The last two lines are one JSON object of per-kernel numbers and one
JSON object {"ok": true, "device": {...}}.
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
REPS = 5


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


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from tpu_zstd_torch.api.manager import BatchManager
    from tpu_zstd_torch.constants import BLOCK_RLE
    from tpu_zstd_torch.corpus import make_corpus
    from tpu_zstd_torch.format.frame import write_frame_header
    from tpu_zstd_torch.format.xxhash import content_checksum
    from tpu_zstd_torch.ops import (
        _kernels, bitpack, chain, concat, fse, greedy, huffman, lz77, rep, roll,
    )
    from tpu_zstd_torch.ops.pipeline import (
        DEFAULT_CONFIG,
        SLICE_CONFIG,
        _encode_stage,
        _parse_prep_stage,
        _pick_bucket,
        compress,
        compress_blocks_staged,
        compress_blocks_staged_many,
    )

    try:
        import zstandard
    except ImportError:
        zstandard = None
    golden1 = json.loads((ROOT / "tests" / "golden" / "torch_slice1.json").read_text())
    golden2 = json.loads((ROOT / "tests" / "golden" / "torch_slice2.json").read_text())
    dev = torch.device("cuda")
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
        "chain": (chain.state_chain3, chain.state_chain3_plain, "tpu_zstd_torch/csrc/chain.cu",
                  "tpu_zstd/ops/pallas_chain.py:108 state_chain3_pallas"),
    }
    # What plain_ms times: K4's plain version walks Python integers on the
    # host (copy to the host included), the others run torch ops on the card.
    PLAIN_KIND = {"rep": "host loop over Python integers"}
    max_err = {k: 0 for k in K}

    def chain_live(out, nseq):
        """K5 outputs on their live range: pre, nb for 1 <= t < nseq; fin."""
        pre, fin, nb = (x.to(torch.int64) for x in out)
        t = torch.arange(pre.shape[1], device=pre.device)
        live = (t >= 1) & (t < nseq.to(torch.int64)[:, None])
        return torch.where(live, pre, 0), torch.where(live, nb, 0), fin

    def hold(name: str, args: tuple, label: str) -> None:
        kern, plain = K[name][0], K[name][1]
        a = kern(*args)
        b = plain(*args)
        torch.cuda.synchronize()
        if name == "chain":
            a, b = chain_live(a, args[7]), chain_live(b, args[7])
        else:
            a, b = (a,), (b,)
        for x, y in zip(a, b):
            if x.shape != y.shape or x.dtype != y.dtype:
                _fail(f"{name} {label}: kernel {x.shape}/{x.dtype} vs plain {y.shape}/{y.dtype}")
            err = int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
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
    from tpu_zstd_torch.ops.fse_tables import build_cf_tables, normalize_64

    for R, nsym, msb in ((3 * B, 53, 21760), (2 * B, 13, 128)):
        cnt = np.stack([np.bincount(np.minimum(rng.geometric(rng.uniform(0.05, 0.5), 500),
                                               nsym - 1), minlength=nsym) for _ in range(R)])
        norm = normalize_64(cu(cnt), cu(cnt.sum(1)))
        st, dnb, dfs, init = build_cf_tables(norm)
        p = (norm / norm.sum(1, keepdim=True)).float()
        gen = torch.Generator(device=dev).manual_seed(R)
        rsym = torch.multinomial(p, msb, replacement=True, generator=gen)
        nseq = cu(rng.integers(0, msb + 1, R))
        rle = cu(rng.random(R) < 0.05)
        hold("chain", (st, dnb, dfs, init, torch.full((R,), 6, device=dev), rle, rsym, nseq),
             f"({R}, {msb})")
    print(f"phase 2: kernels == plain versions on seeded inputs ({time.perf_counter() - t0:.1f} s)")

    # --- running a main path with counts ---------------------------------------------
    data = make_corpus(B * N)
    blocks = cu(np.frombuffer(data, dtype=np.uint8).reshape(B, N))
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    sites = [("roll", bitpack, "roll_rows"), ("concat", lz77, "concat_varlen"),
             ("greedy", lz77, "greedy_segments"), ("rep", lz77, "rep_codes"),
             ("chain", fse, "state_chain3"), ("chain", huffman, "state_chain3")]

    def drive(run):
        """Run `run()` with every kernel's launch count set to 0 just before
        and read just after; capture each distinct input a kernel received."""
        captured: dict[str, dict] = {k: {} for k in K}
        originals = {(mod, attr): getattr(mod, attr) for _, mod, attr in sites}

        def recorder(name, fn):
            def call(*args):
                key = tuple((tuple(a.shape), str(a.dtype)) if torch.is_tensor(a) else a
                            for a in args)
                if key not in captured[name]:
                    captured[name][key] = [tuple(a.clone() if torch.is_tensor(a) else a
                                                 for a in args), 0]
                captured[name][key][1] += 1
                return fn(*args)

            return call

        for name, mod, attr in sites:
            setattr(mod, attr, recorder(name, originals[(mod, attr)]))
        try:
            torch.cuda.synchronize()
            _kernels.reset_launches()
            out = run()
            torch.cuda.synchronize()
            launches = dict(_kernels.launches)
        finally:
            for (mod, attr), fn in originals.items():
                setattr(mod, attr, fn)
        return out, launches, captured

    def check_blocks(outs, golden, label):
        contents, clens, btypes = (t.cpu().numpy() for t in outs)
        gb = golden["batch"]["blocks"]
        if len(gb) != B:
            _fail(f"{label}: golden has {len(gb)} blocks")
        bad = [b for b in range(B)
               if (int(btypes[b]), int(clens[b]), _sha(contents[b, : int(clens[b])].tobytes()))
               != (gb[b]["btype"], gb[b]["clen"], gb[b]["sha256"])]
        if bad:
            _fail(f"{label}: {len(bad)} of {B} blocks differ from the JAX golden "
                  f"(first: {bad[:8]})")
        counts = {t: int((btypes == t).sum()) for t in (0, 1, 2)}
        print(f"{label}: all {B} blocks == JAX golden; btypes raw/rle/comp {counts}; "
              f"block-body ratio {B * N / int(clens.sum()):.4f}")
        return contents, clens, btypes

    def decodes(frame: bytes, expect: bytes, what: str) -> None:
        if zstandard is None:
            return
        got = zstandard.ZstdDecompressor().decompress(frame, max_output_size=max(len(expect), 1))
        if got != expect:
            _fail(f"libzstd decodes {what} to other bytes")

    def hold_captured(captured, label):
        t0 = time.perf_counter()
        n_real = 0
        for k, inputs in captured.items():
            for key, (args, _) in inputs.items():
                hold(k, args, f"{label} {key}")
                n_real += 1
        print(f"{label}: kernels == plain versions on {n_real} captured inputs "
              f"({time.perf_counter() - t0:.1f} s)")

    def batch_ms(cfg):
        compress_blocks_staged(blocks, lengths, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dt = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            outs = compress_blocks_staged_many([(blocks, lengths)] * REPS, cfg)
            torch.stack([o[1] for o in outs]).cpu()
            dt = min(dt, (time.perf_counter() - t0) / REPS)
        return dt, torch.cuda.max_memory_allocated()

    # --- 3. the first slice's path (SLICE_CONFIG) ----------------------------------------
    t0 = time.perf_counter()
    outs, launches1, captured1 = drive(
        lambda: compress_blocks_staged_many([(blocks, lengths)], SLICE_CONFIG))
    print(f"phase 3: SLICE_CONFIG path launches {launches1} "
          f"(first batch {time.perf_counter() - t0:.2f} s)")
    for k in ("roll", "concat", "greedy", "rep"):
        if launches1[k] <= 0:
            _fail(f"kernel {k} was not launched on the SLICE_CONFIG path")
    check_blocks(outs[0], golden1, "phase 3")
    frame = compress(make_corpus(4 * N), SLICE_CONFIG, device="cuda")
    if (len(frame), _sha(frame)) != (golden1["frame"]["len"], golden1["frame"]["sha256"]):
        _fail(f"SLICE_CONFIG 4-block frame differs from the JAX golden ({len(frame)} bytes)")
    print(f"phase 3: compress(make_corpus(4 * 131072), SLICE_CONFIG) frame == JAX golden "
          f"({len(frame)} bytes)")
    hold_captured(captured1, "phase 3")
    dt, peak = batch_ms(SLICE_CONFIG)
    print(f"time [{card}]: SLICE_CONFIG batch 128x128KB {dt * 1e3:.3f} ms = "
          f"{B * N / dt / 1e9:.4f} GB/s (pipelined over {REPS} batches, best of 2); "
          f"peak device memory {peak / 2**30:.3f} GiB")
    del captured1

    # --- 4. the DEFAULT_CONFIG path -------------------------------------------------------
    cfg = DEFAULT_CONFIG
    t0 = time.perf_counter()
    outs, launches, captured = drive(lambda: compress_blocks_staged_many([(blocks, lengths)], cfg))
    print(f"phase 4: DEFAULT_CONFIG path launches {launches} "
          f"(first batch {time.perf_counter() - t0:.2f} s)")
    for k, n_launch in launches.items():
        if n_launch <= 0:
            _fail(f"kernel {k} was not launched on the DEFAULT_CONFIG path")
    contents, clens, btypes = check_blocks(outs[0], golden2, "phase 4")
    parts = [write_frame_header(B * N)]
    for b in range(B):
        last = int(b == B - 1)
        clen = 1 if int(btypes[b]) == BLOCK_RLE else int(clens[b])
        size = N if int(btypes[b]) == BLOCK_RLE else clen
        parts += [((size << 3) | (int(btypes[b]) << 1) | last).to_bytes(3, "little"),
                  contents[b, :clen].tobytes()]
    decodes(b"".join(parts), data, "the DEFAULT_CONFIG batch frame")

    small = make_corpus(4 * N)
    t0 = time.perf_counter()
    content_checksum(small)
    print(f"phase 4: content checksum (pure-Python XXH64, host) of {len(small)} bytes: "
          f"{time.perf_counter() - t0:.3f} s")
    frame = compress(small, cfg, checksum=True, device="cuda")
    gf = golden2["frame"]
    if (len(frame), _sha(frame)) != (gf["len"], gf["sha256"]) or not gf["checksum"]:
        _fail(f"DEFAULT_CONFIG 4-block checksummed frame differs from the JAX golden "
              f"({len(frame)} bytes)")
    decodes(frame, small, "the 4-block frame")
    print(f"phase 4: compress(make_corpus(4 * 131072), checksum=True) frame == JAX golden "
          f"({len(frame)} bytes)")

    gi = golden2["items"]
    base = make_corpus(sum(gi["sizes"]))
    starts = np.cumsum([0] + gi["sizes"][:-1])
    items = [base[s : s + n] for s, n in zip(starts, gi["sizes"])]
    t0 = time.perf_counter()
    mgr = BatchManager(level=gi["level"])
    res = mgr.compress_batch(items)
    t_mgr = time.perf_counter() - t0
    for k, (r, g) in enumerate(zip(res, gi["frames"])):
        if (len(r.output), _sha(r.output)) != (g["len"], g["sha256"]):
            _fail(f"BatchManager(level=3) frame {k} differs from the JAX golden")
        decodes(r.output, items[k], f"BatchManager frame {k}")
    print(f"phase 4: BatchManager(level=3).compress_batch: {len(items)} frames == JAX golden "
          f"({sum(gi['sizes'])} bytes in, ratio {mgr.stats.ratio:.4f}, {t_mgr:.2f} s)")
    print("phase 4: libzstd decode: " + ("every frame decoded to its input" if zstandard
          else "zstandard is not installed here; the frames equal goldens that libzstd "
               "decoded when they were made"))
    hold_captured(captured, "phase 4")

    # --- 5. times at DEFAULT_CONFIG -------------------------------------------------------
    dt, peak = batch_ms(cfg)
    body = int(clens.sum())
    print(f"time [{card}]: DEFAULT_CONFIG batch 128x128KB {dt * 1e3:.3f} ms = "
          f"{B * N / dt / 1e9:.4f} GB/s (pipelined over {REPS} batches, best of 2); "
          f"peak device memory {peak / 2**30:.3f} GiB; block-body ratio {B * N / body:.4f}")
    seqs, nseq = _parse_prep_stage(blocks, lengths, cfg)
    msb = _pick_bucket(int(nseq.max()), cfg.max_seqs)
    parse_ms = _time_ms(lambda: _parse_prep_stage(blocks, lengths, cfg), 3)
    enc_ms = _time_ms(lambda: _encode_stage(blocks, lengths, seqs, cfg, msb), 3)
    print(f"time [{card}]: DEFAULT_CONFIG parse stage {parse_ms:.3f} ms; encode stage (bucket "
          f"{msb}: tables, K5 chains, deposit, Huffman literals, assembly) {enc_ms:.3f} ms")

    def nbytes(t):
        return t.numel() * t.element_size()

    def bound(name, args, out):
        if name == "concat":
            x, off, cnt, out_len = args
            c = cnt.to(torch.int64)
            start = torch.clamp(torch.cumsum(c, 1) - c, max=out_len)
            moved = int(torch.minimum(c, out_len - start).sum())
            return (moved * 4 + nbytes(off) + nbytes(cnt) + nbytes(out)) / HBM_BYTES_PER_S * 1e3
        if name == "chain":  # int32 operands as the kernel reads them
            n_in = sum(a.numel() for a in args)
            n_out = sum(o.numel() for o in out)
            return (n_in + n_out) * 4 / HBM_BYTES_PER_S * 1e3
        return (sum(nbytes(a) for a in args if torch.is_tensor(a)) + nbytes(out)) \
            / HBM_BYTES_PER_S * 1e3

    # Every captured shape is timed; `ms_per_batch` sums the kernel's time over
    # its launches in one batch. The JSON row reports the representative
    # shape: K1's byte roll at the block width, else the largest input.
    rows_out = []
    for name, (kern, plain, source, replaces) in K.items():
        per_batch = 0.0
        row = None
        for key, (args, n_calls) in sorted(captured[name].items(),
                                            key=lambda kv: -sum(nbytes(a) for a in kv[1][0]
                                                               if torch.is_tensor(a))):
            if name == "chain":  # the wrapper's int32 copies are not the kernel's time
                args = tuple(a.to(torch.int32).contiguous() for a in args)
            out = kern(*args)
            ms = _time_ms(lambda: kern(*args), 20)
            plain_ms = _time_ms(lambda: plain(*args), 1 if name == "rep" else 3)
            b_ms = bound(name, args, out)
            per_batch += n_calls * ms
            shape = f"{key[0][0]} {key[0][1]}" if name != "chain" else f"rows x msb {key[6][0]}"
            print(f"kernel [{card}] {name} {shape} x{n_calls}/batch: {ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms, plain {plain_ms:.3f} ms")
            if row is None or key[0] == ((B, N), "torch.uint8"):
                row = {
                    "name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": launches[name], "max_abs_err": max_err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": "bytes",
                    "library_ms": None, "shape": shape, "launches_slice1": launches1[name],
                    "plain_kind": PLAIN_KIND.get(name, "torch ops on the card"),
                }
        row["ms_per_batch"] = per_batch
        rows_out.append(row)
        print(f"kernel [{card}] {name}: {per_batch:.4f} ms per batch over {launches[name]} "
              f"launches")
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
