"""Where the PyTorch port's batch time goes, on one CUDA GPU.

    python3 tools/torch_profile.py [--config default|slice|level19] [--path compress|decode]
                                   [--out DIR]

Runs the bench batch (make_corpus(128 * 131072), 128 x 128 KB blocks) at
DEFAULT_CONFIG (or SLICE_CONFIG, or the level-19 pipeline config) through
`compress_blocks_staged` and reports, each beside the card's name and power
limit:

1. Stage times by CUDA events. The inputs each pipeline function receives in
   one batch are captured, then each function is timed alone on them:
   find_matches, greedy_parse, parse_block (whole parse); at DEFAULT_CONFIG
   the table selection (prepare_sequences_auto), the K5 state chains, the
   sequence bit deposit, encode_prepared (whole sequence encode), the Huffman
   literals (compress_literals_huffman, and within it build_lengths,
   weights_fse_payload, encode_literals_4stream and its deposit tree); at
   SLICE_CONFIG the predefined state chains, the deposit and
   encode_sequences_predefined; at level 19 also the long-range pass
   (find_matches_long), the pass-1 pricing (optimal_prices, K3 included)
   and the segment DP (opt_steps, K10); and the block assembly (which holds
   the Huffman literals).
2. A torch.profiler trace of one steady batch, written with a JSON summary
   to DIR/torch_profile_trace.json: the device activities in it
   (kernels, copies, sets), their busy time (union of intervals) against the
   batch's time (the device's idle share), and device time by kernel name.

With --path decode the batch is the decode of the bench batch's 128 level-3
decode_accel frames (bench.py's decode): `prepare_decompress_batch(frames)`
once, then the stages are the decode kernels' wrappers (K7
decode_sequences_lanes, K6 decode_huffman_lanes, K8/K9 execute_sequences,
each timed alone on every input one execute() hands it, summed) and the
batch is one `execute()` with its lengths fetched.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
B, N = 128, 131072


def _time_ms(fn, iters: int = 5) -> float:
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


def _device_activity(trace_path: pathlib.Path, top: int = 20) -> dict:
    """Device activities of a chrome trace: count, busy time (union of their
    intervals, ms) and the `top` kernel names by summed time."""
    doc = json.loads(trace_path.read_text())
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy, end = 0.0, None
    for ts, dur in sorted((e["ts"], e["dur"]) for e in dev):
        if end is None or ts >= end:
            busy += dur
            end = ts + dur
        elif ts + dur > end:
            busy += ts + dur - end
            end = ts + dur
    by_name: dict[str, list] = {}
    for e in dev:
        r = by_name.setdefault(e["name"], [0, 0.0])
        r[0] += 1
        r[1] += e["dur"] / 1e3
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "device_activities": len(dev),
        "device_busy_ms": busy / 1e3,
        "top": [{"name": n, "count": c, "ms": ms} for n, (c, ms) in rows],
    }


def _card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def _trace_summary(out_dir: pathlib.Path, card: str, prof, batch_ms: float, wall_ms: float,
                   summary: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    trace_path = out_dir / "torch_profile_trace.json"
    prof.export_chrome_trace(str(trace_path))
    summary.update(_device_activity(trace_path))
    busy = summary["device_busy_ms"]
    print(f"profile [{card}]: {summary['device_activities']} device activities (kernels, copies, "
          f"sets), device busy {busy:.3f} ms; idle share {1 - busy / batch_ms:.3f} of the "
          f"unprofiled batch ({batch_ms:.3f} ms), {1 - busy / wall_ms:.3f} of the profiled one "
          f"({wall_ms:.3f} ms)")
    for row in summary["top"]:
        print(f"profile [{card}]   {row['ms']:9.3f} ms  x{row['count']:5d}  {row['name'][:110]}")
    (out_dir / "torch_profile.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps({"batch_ms": batch_ms, "device_busy_ms": busy, "wall_ms": wall_ms}))


def _decode_profile(opts) -> int:
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_zstd_torch.api import decompress
    from tpu_zstd_torch.api.config import CompressionConfig
    from tpu_zstd_torch.api.manager import compress_items
    from tpu_zstd_torch.corpus import make_corpus

    card = _card()
    data = make_corpus(B * N)
    cfg = dataclasses.replace(CompressionConfig.from_level(3), decode_accel=True)
    frames = compress_items([data[i * N : (i + 1) * N] for i in range(B)], cfg, device="cuda")
    plan = decompress.prepare_decompress_batch(frames, max_block=N)
    plan.execute()
    torch.cuda.synchronize()
    sites = ("decode_sequences_lanes", "decode_huffman_lanes", "execute_sequences")
    captured: dict = {a: [] for a in sites}
    originals = {a: getattr(decompress, a) for a in sites}

    def recorder(attr):
        def call(*args, **kw):
            captured[attr].append((args, kw))
            return originals[attr](*args, **kw)

        return call

    for a in sites:
        setattr(decompress, a, recorder(a))
    plan.execute()
    torch.cuda.synchronize()
    for a in sites:
        setattr(decompress, a, originals[a])
    stage = {a: sum(_time_ms(lambda: originals[a](*args, **kw)) for args, kw in calls)
             for a, calls in captured.items()}

    def one_batch():
        plan.execute()[1].cpu()

    batch_ms = _time_ms(one_batch)
    for attr, ms in stage.items():
        print(f"stage [{card}] {attr} ({len(captured[attr])} calls): {ms:.3f} ms")
    print(f"stage [{card}] execute() with lengths fetched: {batch_ms:.3f} ms")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_batch()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _trace_summary(pathlib.Path(opts.out), card, prof, batch_ms, wall_ms,
                   {"card": card, "path": "decode", "stage_ms": stage, "batch_ms": batch_ms,
                    "wall_ms_profiled": wall_ms})
    return 0


def main() -> int:
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(ROOT / "profile_out"), help="trace and summary directory")
    ap.add_argument("--config", choices=("default", "slice", "level19"), default="default")
    ap.add_argument("--path", choices=("compress", "decode"), default="compress")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 2
    if opts.path == "decode":
        return _decode_profile(opts)
    from tpu_zstd_torch.api.config import CompressionConfig
    from tpu_zstd_torch.api.manager import _pipeline_config
    from tpu_zstd_torch.corpus import make_corpus
    from tpu_zstd_torch.ops import fse, huffman, lz77, pipeline
    from tpu_zstd_torch.ops.pipeline import DEFAULT_CONFIG, SLICE_CONFIG, compress_blocks_staged

    card = _card()
    cfg = {"default": DEFAULT_CONFIG, "slice": SLICE_CONFIG,
           "level19": _pipeline_config(CompressionConfig.from_level(19))}[opts.config]
    data = make_corpus(B * N)
    blocks = torch.from_numpy(np.frombuffer(data, dtype=np.uint8).reshape(B, N).copy()).cuda()
    lengths = torch.full((B,), N, dtype=torch.int32, device="cuda")
    compress_blocks_staged(blocks, lengths, cfg)  # builds the kernels, warms up
    torch.cuda.synchronize()

    # --- 1. stage times ----------------------------------------------------------------
    sites = [(lz77, "find_matches"), (lz77, "greedy_parse"), (pipeline, "parse_block")]
    if cfg.ldm:
        sites += [(lz77, "find_matches_long")]
    if cfg.optimal:
        sites += [(lz77, "optimal_prices"), (lz77, "opt_steps")]
    if cfg.custom_fse:
        sites += [(pipeline, "prepare_sequences_auto"), (fse, "state_chain3"),
                  (fse, "deposit_bits"), (pipeline, "encode_prepared")]
    else:
        sites += [(fse, "_state_chain"), (fse, "deposit_bits"),
                  (pipeline, "encode_sequences_predefined")]
    if cfg.huffman_literals:
        sites += [(pipeline, "compress_literals_huffman"), (huffman, "build_lengths"),
                  (huffman, "weights_fse_payload"), (huffman, "encode_literals_4stream"),
                  (huffman, "deposit_bits_tree")]
    sites += [(pipeline, "_assemble_one")]
    captured = {}
    originals = {(m, a): getattr(m, a) for m, a in sites}

    def recorder(mod, attr):
        fn = originals[(mod, attr)]

        def call(*args, **kw):
            captured.setdefault(attr, (fn, args, kw))
            return fn(*args, **kw)

        return call

    for m, a in sites:
        setattr(m, a, recorder(m, a))
    compress_blocks_staged(blocks, lengths, cfg)
    torch.cuda.synchronize()
    for m, a in sites:
        setattr(m, a, originals[(m, a)])
    stage = {}
    for attr, (fn, args, kw) in captured.items():
        stage[attr] = _time_ms(lambda: fn(*args, **kw))
    batch_ms = _time_ms(lambda: compress_blocks_staged(blocks, lengths, cfg))
    for attr, ms in stage.items():
        print(f"stage [{card}] {attr}: {ms:.3f} ms")
    print(f"stage [{card}] compress_blocks_staged (one batch, host read of nseq included): "
          f"{batch_ms:.3f} ms")

    # --- 2. profiler trace -------------------------------------------------------------
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        compress_blocks_staged(blocks, lengths, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    _trace_summary(pathlib.Path(opts.out), card, prof, batch_ms, wall_ms,
                   {"card": card, "config": opts.config, "stage_ms": stage,
                    "batch_ms": batch_ms, "wall_ms_profiled": wall_ms})
    return 0


if __name__ == "__main__":
    sys.exit(main())
