#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (tpu_zstd_torch) on one CUDA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Card and build: the card's name and power limit, the nvcc build of the
   kernels in tpu_zstd_torch/csrc (seconds, registers, shared memory).
2. Each kernel (K1-K13) against its plain PyTorch version on the card, at the
   main paths' shapes (B = 128) on seeded inputs: exact equality (K5 on its
   live range: 1 <= t < nseq and the flush state; the decode kernels K6, K7
   and K8/K9 up to nsym, nseq and out_len, K7's final rep triples whole). K6
   and K7 take the inputs the decode plan stages for 16 seeded 128 KB
   decode_accel frames (made by the port on the card), with K6's counters
   (lanes that met their speculative walk, symbols before meeting, fix-up
   rounds) and K7's (sequences a chunk walked, stream words read outside
   the staged words); K7 also the hard inputs of tests/torch_cases.py
   `seq_hard_inputs` (16 + 31 + 16 extra bits a sequence, offsets past
   2^31, FSE tables of table_log 9/8/9, RLE tables, nseq 1 and 3 strides, a
   stream that is its end-marker byte, chunks without records, a record past
   its stream's end, max_seqs below nseq, a 71 KB serial stream, a block
   without sequences) and `seq_garbage_inputs` (scrambled records), with
   their times; K6 also the hard streams of
   tests/torch_cases.py `huf_hard_inputs` (256 codes of 8 bits, table_log 1
   and 11, nsym on and off a chunk boundary, 1-symbol and empty streams, a
   forward-filled 0 start record, a record 3 bits off; with records and with
   K = 0); K1 also the hard rows of `roll_hard_rows` (int64 rows of widths
   2, 3 and 11 with 10^6 rows and of width 16384, byte rows of widths 110600
   and 160, int32 rows of odd width; shifts 0, W, -1, +-3W and beyond), with
   their times and byte bounds; K2 through its fused entry (one launch for
   every operand, the casts in the kernel) on tests/torch_cases.py
   `concat_fused_hard` operands (full windows, prefixes past out_len, empty
   windows, pk at and past 2^31 and 2^32 and negative, literal offsets at
   every residue mod 16) at the tier-1 case's shape, at the parse's and at
   widths and lengths off 16 bytes, and from sources that do not start on
   16 bytes, and with one int32 operand (`concat_varlen`); K7 also serially
   (one chunk a block, as the multi-block plan runs it) from seeded rep
   triples that are not the initial one, on every hard set; K8/K9 seeded
   valid sequences, literals front-compacted or read from 4-stream rows,
   without and with a 4 KB window, with the multi-block plan's history
   windows of 128 KB and 512 KB and with decompress_batch_tpu's at 8 MiB (2
   blocks; offsets to the window's first byte), and the hard
   lists of tests/torch_cases.py `exec_hard_inputs` (overlapping matches at
   off 1-3, a chain of matches each copying the one before, window reads, no
   sequences, output filling N); K4 also the hard rows of `rep_hard_rows`
   (a block alternating two offsets, ll == 0 repcode 3, invalid rows
   scattered, nseq 0, row counts off the chunk), with the counters each
   redesigned kernel keeps (doubling rounds, chunks that met); K3 also the
   hard segments of tests/torch_cases.py `greedy_hard_packed` (whole-segment
   matches, every position matched, all literals, defer on every match,
   walks that never meet) at 16384 + 13 segments of 1024 and at segment
   widths 64, 100, 1000 and 7, with their times; K5 also the hard calls of
   `chain_hard_inputs` (msb 128 to 32768, nseq 0-2, 128-130, msb - 1 and
   msb, RLE rows, table logs 5 and 6, S = 1 and 64, a 63-state symbol whose
   walks never meet, alone too) and `chain_garbage_inputs` (tables outside
   the encoder's contract), with the passes a row (max and mean), rows that
   took the transfer maps or the 64-bit walk, and times; K10 on the calls
   of tests/torch_cases.py `opt_card_calls`: its hard calls (`OPT_HARD`,
   `OPT_HARD_WIDE`: rows that offer every length, none, all prices zero, a
   cost-to-go past BIG, prices near 2^30, negative and full-range int32,
   prices at 4095, a bank a row; S 130 and 16397, seg 1, 33, 300, 1000,
   1024 and 4096, cap 127 at mm 32, mm = cap), the calls of fast-path kinds
   alone (`OPT_FAST_WIDE`, each row of which must take the fast path), seeded
   segment rows at min_match 3 / cap 64 (16384 x 1024, one bank per 128
   rows) and at min_match 4 / cap 16 with 16 segments a block (one bank per
   16 rows), and rows that offer every length at 16384 x 1024, timed beside
   their bound, with the rows of each call walked on the fast path; K12 on unique keys spanning
   negative values with 0-3 payloads and with 35 (two launches), K13 on low-entropy windows at 2 x
   1024 and at the three level shapes (2048 x 8192); both on their hard sets
   (tests/torch_cases.py `SORT_HARD`: rows sorted, reversed, organ-pipe and
   random, keys at and next to INT32_MIN and INT32_MAX, 1 and 3 rows, 0 and 3
   payloads; `MATCH_HARD`: one hash a window, all-sentinel windows, two
   alternating hashes, equal words everywhere, hashes at the ends of the key
   range, depth 0, 5, 8 and 127, nwords 0, 1 and 16) at widths 1024, 8192,
   16384, 32768 and 65536, and K12 on one row of 2^20 columns; then K12 with
   1 and 3 operands at 2048 x 8192, 512 x 32768 and 256 x 65536 beside
   torch.sort + torch.gather, and K13 at the level-1/3/5 shapes and at 256 x
   65536, each timed by CUDA events, queued behind a spin kernel and on the
   device, beside commit d0443a2's time, its bound (bytes; K13 also its
   compares) and "network ops" (one bitonic network's int32 operations, the
   bound used before); K11 on the reference test's fields, its sparse case
   and fields running past the padded width.
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
4b. The decode path: the bench batch as 128 single-block items through
   `compress_items` at level 3 with decode_accel=True (bench.py's frames),
   every frame (sidecar included) and 4 checksummed ones against
   tests/golden/torch_slice3.json; `prepare_decompress_batch(frames,
   max_block=131072).execute()` with the counts set to 0 just before and read
   just after: every row equals its item and is 131072 bytes long, and K6, K7
   and K8/K9 were launched; `execute(verify_checksum=True)` on the
   checksummed frames; each decode kernel against its plain version on the
   inputs it received; then 8 of phase 4's blocks as frames without metadata
   (K7's serial mode, literals decoded on the host) back to their bytes.
   Then multi-block frames through the chained-round plan (K7 serially from
   the rep triple the round before left, K8 against the carried history),
   the counts set to 0 just before and read just after each: the
   SLICE_CONFIG and DEFAULT_CONFIG 4-block frames, the 16 level-3
   BatchManager frames (timed: 3 `execute()` calls with their lengths
   fetched, best of 2) and a mixed batch (the first 32 blocks of the
   DEFAULT_CONFIG batch as one 4 MiB frame, whose history grows to 4 MiB,
   the 4-block frames, libzstd's multi-block frames of
   tests/golden/multiblock_frames.json with repeat offsets and matches across
   blocks, two single-block decode_accel frames), each row equal to its
   input with the checksums verified, K7 and K8 against their plain versions
   on the inputs the mixed batch gave them.
4c. The optimal-parse path at the level-19 pipeline config (min_match 3,
   depth 48, cap 64, 64 KB match windows, LDM, the segment DP K10): the
   bench batch through `compress_blocks_staged_many`, the counts set to 0
   just before and read just after; each block's pass-1 prices (the literal
   price and the sha256 of its cost-bank row, as K10 received them) and then
   its (type, length, sha256) against tests/golden/torch_slice4.json; the
   frames of `BatchManager(level=19).compress_batch` over the 16 items
   against the same file; each kernel (K1-K5, K10) against its plain version
   on the inputs it received in that run; K10 launched at least once; the
   16 level-19 frames decoded by the multi-block plan to their items
   (timed as the level-3 ones).
4d. The fused match route (K13) at the pipeline configs of levels 1, 3 and 5:
   `find_matches(..., use_pallas_match=True)` on the inputs `parse_block`
   hands `find_matches` for the bench batch, the counts set to 0 just before
   and read just after (one K13 launch a call, nothing else), equal to the
   plain route at every live position and 0 at dead ones; K13 against its
   plain version and K12 against its plain version on the inputs K13
   received (the window keys and their suffix words). The same at hash_log
   14 and 64 KB windows (K13's tiled path, one launch) on level 3's inputs,
   against the sort route at those knobs; and two_band on the fused route,
   which returns the fused (ml, off). Then K11 on the
   DEFAULT_CONFIG batch's sequence deposits (the calls that take the deposit
   tree; offsets the exclusive cumsum, M padded to 128 with zero-length
   fields at the last offset): its first num_words words equal the tree's,
   and it equals its plain version. The main path keeps the tree.
4e. The public surface: `Manager(level=3).compress` of the bench corpus as
   one 16 MiB item (past cpu_threshold, so on the card; counts set to 0
   just before and read just after) against tests/golden/torch_slice5.json;
   `prepare_decompress_batch` refuses its 16 MiB window;
   `Manager(execution_path=ExecutionPath.TPU_BATCH).decompress` of it
   (`decompress_batch_tpu`: 128 rounds of K7 serially and K8 against a
   history that grows to 16 MiB, counts set to 0 just before and read just
   after) returns the input, timed (wall, the host parse, the device half
   best of 2, K7's and K8's device time, K7's serial cost a round and a
   sequence), K7 and K8 against their plain versions on the inputs it gave
   them; `BatchManager(level=3).decompress_batch(use_tpu=True)` over phase
   4's 16 frames, libzstd's multi-block frames of
   tests/golden/multiblock_frames.json and the 16 MiB frame: every status
   SUCCESS, every output its input, K7 and K8 launched (nothing fell through
   to the host); `tpu_zstd_torch.compress` of 256 KB with a checksum takes
   the host route (no launch) and round-trips through
   `tpu_zstd_torch.decompress` on the host and `decompress_batch_tpu` on
   the card; `StreamingDecompressor` fed phase 3's and phase 4's 4-block
   frames in 4 KB chunks returns their inputs.
4f. Cross-block windows, on the inputs of tests/golden/torch_slice6.json
   (tests/torch_cases.py `slice6_inputs`, from the bench corpus), each path
   driven once through its entry point with the counts set to 0 just before
   and read just after, its kernels held against their plain versions on
   the inputs it gave them, its peak device memory printed:
   `compress_items` with enable_ldm over 16 items of 1 MiB (128 rows of a
   64 KB window and a 128 KB block), against the golden, decoded by the
   prepared plan and timed as the multi-block decodes are, with the
   compress time beside it; `StreamingManager(level=3)` over the corpus in
   16 chunks of 1 MiB (the 64 KB history, the search over the whole row),
   against the golden, decoded by `decompress_batch_tpu` (128 rounds; the
   host parse and the device half timed) and by the manager's decompress
   half on the host; `compress_items` at level 19 of 8 blocks behind a 64
   KB history (K10 on rows of 192 segments), against the golden and
   decoded on the card behind its history; `train_dictionary` (64 KB) on
   1024 records and `compress_with_dict` of 256 others, against the
   golden, decoded by `decompress_with_dict` on the host; a
   `StreamingManager(window_log=20)` stream over a 1 MiB history whose
   next chunk repeats it at offset 2^20 and past it (rows of 1,179,648),
   decoded on the card. Phase 2 also holds K1 at rows of 196,608 and
   1,179,648 bytes, K2 on hard operands of 96 windows of 2048 a row and K3
   on 192 segments a row, each timed beside its bound; phase 5 times K1,
   K2 and K3 on the largest input each window path gave them, and the
   kernel line gives each kernel's launches on every window path
   (`launches_windows`).
4g. The last modules, on the inputs of tests/golden/torch_slice7.json
   (tests/torch_cases.py `slice7_inputs`), each device path driven once
   through its entry point with the counts set to 0 just before and read
   just after (the kernel line's `launches_4g`), with its peak device
   memory: the native host library built by g++ from the port's copies
   into tpu_zstd_torch/_build/ (XXH64 / XXH32 of seeded buffers against the
   golden; `NativeEngine` frames at levels 1, 3 and 19 of make_corpus(4
   MiB) against the golden, decoded by the engine and by the port's host
   decoder, MB/s on the host CPU whose model lscpu gives); the 16 MiB frame
   of phase 4e through `decompress_batch_tpu` (the host parse now with
   native Huffman literals, the device half) and the one-shot host
   `decompress`; `compress_items` of the 16 level-3 items (the native frame
   assembler where its condition holds; it and the Python join timed on
   that batch's blocks, their frames equal); `HybridEngine` on the card
   (`decide_route` against the golden; AUTO on the 16 MiB corpus as host
   bytes to the card, its frame torch_slice5.json's; on 64 KB to the native
   engine, its frame the golden's; a 1 MiB uint8 CUDA tensor as DEVICE to
   the card; FORCE_TPU decode of the 128 decode_accel frames through the
   prepared plan and of a multi-block frame re-headed to an 8 MiB window
   through `decompress_batch_tpu`; ADAPTIVE switching once both histories
   hold samples; `hybrid_compress` / `hybrid_decompress`);
   `NvcompV5BatchManager(level=3)` over the 16 items (the metadata frame
   against the golden, the chunks against torch_slice2.json, `decompress`
   and `decompress_chunk(7)`); `BatchManager(level=3)` over the 16 items
   under `torch.cuda.set_per_process_memory_fraction` (the resident memory
   plus 0.75 of the unconstrained peak; the error injected at the call if
   the cap does not bite), at least one split, no item finished on the host
   and every frame the golden's;
   `select_adaptive_level` against the golden and
   `AdaptiveLevelSelector(RATIO).config_for` feeding a `Manager` on the card
   (level 19, K10); the profiler's report over the hybrid, nvCOMP and OOM
   steps; `compress_blocks_sharded` of the bench batch in an NCCL group of
   one rank (every block against torch_slice2.json) and
   `compress_batch_distributed` of the 16 items.
5. Times on the card at DEFAULT_CONFIG: the pipelined batch (5 batches, best
   of 2), peak device memory, the parse and encode stages; at level 19 the
   pipelined batch (best of 2) and its peak device memory; the decode as
   bench.py times it (3 `execute()` calls with their lengths fetched, best of
   2, GB/s = 16 MiB over that time) with its peak device memory; and per
   kernel its time by CUDA events at every captured shape, its bound and its
   plain version's time (K2 on the operands the DEFAULT_CONFIG parse gave
   its one launch, with the old kernel's time on the same operands from
   tools/torch_concat_bench.py beside it; K12 also `torch.sort` + `torch.gather`, its
   library call; K13 beside the plain route's `find_matches`, K11 beside the
   deposit tree, both in phase 4d; K12 and K13 also their device time and
   "network ops"), and its bound summed over its launches
   in one batch (`bound_ms_per_batch`); K4's, K6's, K7's and K8/K9's
   counters on the main paths' inputs (chunks or lanes that met their
   speculative walk, fix-up rounds; sequences a chunk walked and words not
   staged; pointer-doubling rounds a tile), K5's (passes a row); K1's,
   K3's, K5's, K6's and K7's device time (torch.profiler) beside their
   CUDA-event time, and K3's and K5's time by CUDA events with the calls
   queued behind a spin kernel (no host cost between them); K5 also as the
   path calls it (int64 operands).

Stock libzstd (`zstandard`) decodes the frames where it is installed; where
it is not, the run says so once and golden identity stands in for it.

The goldens come from tools/make_torch_goldens.py (the JAX package on the
CPU). The last three lines are the card's name and power limit, one JSON
object of per-kernel numbers and one JSON object {"ok": true, "device":
{...}}.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import subprocess
import sys
import time
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (NVIDIA data sheet)
# int32 operations a second: 132 SMs x 64 INT32 lanes (Hopper white paper)
# x the 1.98 GHz boost clock of the H100 SXM.
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# K10 bound: int32 operations the function needs per (position, length) the
# data offers (a 3-input add and a min, the band chosen once a position) and
# per position (four field extractions, lmax = min(cap, max(ml, ml2)), the
# two-band limit min(ml, ml2), min(mc, mc2), the longer band's mc by a compare
# and a select, the literal's add and its min).
OPT_OPS_PER_LENGTH, OPT_OPS_PER_POSITION = 2, 12
# K13 bound: int32 operations per (position, predecessor) pair its data
# compares and per position. "Network ops" (K12's and K13's former bound):
# int32 operations per compare-exchange of one bitonic network (partner
# index, compare, direction, select).
MATCH_OPS_PER_PAIR, MATCH_OPS_PER_POSITION = 6, 4
SORT_OPS_PER_CE = 4
# K2's stage as commit 2d2f9bf ran it (three launches of its one-operand
# kernel around int32 casts, the window-base add and three zeroed outputs) on
# the operands the DEFAULT_CONFIG parse gives the fused launch, on NVIDIA H100
# 80GB HBM3 at 700.00 W (`tools/torch_concat_bench.py --tree` on that commit;
# PERF.md section 6): printed beside this run's fused launch.
CONCAT_PARENT_MS = {"three launches on the device": 0.0617, "the stage on the device": 0.3988,
                    "three launches by events": 0.2494, "the stage by events": 0.5176}
# K12's and K13's times before their register network (commit d0443a2) at
# the shapes that phase 2 times, by CUDA events over back-to-back calls on
# NVIDIA H100 80GB HBM3 at 700.00 W (`tools/torch_sort_bench.py --tree` on
# that commit's kernels; PERF.md section 6): printed beside this run's.
SORT_MATCH_PARENT_MS = {
    ("sort", "(2048, 8192) x 1 operands"): 1.2185,
    ("sort", "(2048, 8192) x 3 operands"): 1.3539,
    ("sort", "(512, 32768) x 1 operands"): 2.3711,
    ("sort", "(512, 32768) x 3 operands"): 2.7739,
    ("sort", "(256, 65536) x 1 operands"): 2.7119,
    ("sort", "(256, 65536) x 3 operands"): 3.0073,
    ("match", "level 1"): 0.9656,
    ("match", "level 3"): 1.0239,
    ("match", "level 5"): 1.0297,
    ("match", "tiled"): 4.6189,
}
# K12's and K13's kernels, for their device time (torch.profiler).
SORT_KERNELS = ("sort_rows_kernel", "merge_pass_kernel")
MATCH_KERNELS = ("match_windows_kernel", "match_wide_kernel", "merge_pass_kernel",
                 "unpack_kernel")
B, N = 128, 131072
REPS = 5
# A level-19 batch takes ~1 s: its pipelined time is taken over fewer batches.
REPS_L19 = 3


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


def _queued_ms(fn, iters: int) -> float:
    """Mean milliseconds per call by CUDA events, with the calls queued
    behind a ~5 ms spin kernel so that the host's cost of a call does not
    space them out: the device's time for back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(10**7)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(fn, iters: int, kernel):
    """Mean device milliseconds a call of the kernels whose name contains
    `kernel` (or one of the names in a tuple), from a torch.profiler (CUPTI)
    trace of `iters` calls after one warm-up call: the kernel's own time,
    without the host's launch cost that back-to-back CUDA-event timing of a
    short kernel measures. None if the trace holds no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total for e in prof.events()
          if e.device_type == DeviceType.CUDA
          and any(k in e.name for k in ((kernel,) if isinstance(kernel, str) else kernel))]
    return sum(us) / iters / 1e3 if us else None


def _device_ms_by_name(fn, patterns: dict) -> dict:
    """Device milliseconds of one call of fn (after a warm-up call) from one
    torch.profiler (CUPTI) trace: per label the kernels whose name contains
    its pattern ("" matches every kernel); None where none ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {}
    for label, pat in patterns.items():
        us = [e.device_time_total for e in events if pat in e.name]
        out[label] = sum(us) / 1e3 if us else None
    return out


def _fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def sort_library(*ops):
    """K12's function in one PyTorch call: torch.sort, then torch.gather of
    each payload (the yardstick `library_ms`; the port never calls it)."""
    import torch

    k, order = torch.sort(ops[0], dim=-1)
    return (k, *(torch.gather(p, -1, order) for p in ops[1:]))


def network_ms(R: int, W: int) -> float:
    """Milliseconds for the int32 operations of one bitonic network over
    (R, W) rows at the card's int32 rate: K12's and K13's former bound, kept
    as "network ops" so that rows compare with earlier measurements."""
    lw = W.bit_length() - 1
    return R * (W // 2) * (lw * (lw + 1) // 2) * SORT_OPS_PER_CE / INT32_OPS_PER_S * 1e3


def sort_bound_ms(ops) -> float:
    """K12's bound: every operand read once and written once."""
    return 2 * sum(o.numel() * o.element_size() for o in ops) / HBM_BYTES_PER_S * 1e3


def opt_bound_ms(packed, mm: int, cap: int, lit_bits, bank):
    """K10's bound and what sets it: the bytes of packed, the literal prices
    and the banks read once and of the steps written once, or the int32
    operations for the lengths this input offers (up to max(ml, ml2), at
    most cap) and per position, whichever is larger."""
    import torch

    x = packed.to(torch.int64)
    lmax = torch.clamp(torch.maximum(x & 127, (x >> 12) & 127), max=cap)
    tried = int(torch.clamp(lmax - mm + 1, min=0).sum())
    ops = tried * OPT_OPS_PER_LENGTH + packed.numel() * OPT_OPS_PER_POSITION
    nb = 2 * packed.numel() * 4 + lit_bits.numel() * 4 + bank.numel() * 4
    b_ms, o_ms = nb / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (o_ms, "operations") if o_ms >= b_ms else (b_ms, "bytes")


def match_bound_ms(key, words, depth: int, sentinel: int):
    """K13's bound and what sets it: the bytes of the key and the words read
    once and of ml and off written once, or the int32 operations of the depth
    compares these inputs need (each live sorted position against its
    predecessors of the same hash, up to depth), whichever is larger."""
    import torch

    R, W = key.shape
    sh = torch.sort(key, dim=-1)[0] >> (W.bit_length() - 1)
    idx = torch.arange(W, device=sh.device).expand(R, W)
    new = torch.ones_like(sh, dtype=torch.bool)
    new[:, 1:] = sh[:, 1:] != sh[:, :-1]
    start = torch.cummax(torch.where(new, idx, 0), dim=1)[0]
    pairs = int(torch.where(sh < sentinel, torch.clamp(idx - start, max=depth), 0).sum())
    ops = pairs * MATCH_OPS_PER_PAIR + R * W * MATCH_OPS_PER_POSITION
    nb = 3 * key.numel() * 4 + words.numel() * 4
    b_ms, o_ms = nb / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (o_ms, "operations") if o_ms >= b_ms else (b_ms, "bytes")


def _host_cpu() -> str:
    """The host CPU as lscpu (else /proc/cpuinfo) reports it: model name,
    vendor, family / model / stepping, and the cores this process sees."""
    import os

    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        out = ""
    fields = {k.strip(): v.strip() for k, _, v in (ln.partition(":") for ln in out.splitlines())}
    if "Model name" not in fields:  # no lscpu: the kernel's cpuinfo
        try:
            info = pathlib.Path("/proc/cpuinfo").read_text().split("\n\n")[0]
        except OSError:
            info = ""
        cpu = {k.strip(): v.strip() for k, _, v in (ln.partition(":") for ln in info.splitlines())}
        fields = {"Model name": cpu.get("model name"), "Vendor ID": cpu.get("vendor_id"),
                  "CPU family": cpu.get("cpu family"), "Model": cpu.get("model"),
                  "Stepping": cpu.get("stepping")}
    ident = "/".join(str(fields.get(k)) for k in ("CPU family", "Model", "Stepping"))
    return (f"{fields.get('Model name') or 'model not reported'} ({fields.get('Vendor ID')} "
            f"family/model/stepping {ident}), {len(os.sched_getaffinity(0))} cores")


def _host_decode_timed(frame: bytes, one_shot: bool) -> tuple[bytes, float]:
    """One host decode in a worker process and its seconds: the one-shot
    `tpu_zstd_torch.decompress` (its host route, on the CPU) or the port's
    host decoder (format/frame.py)."""
    import tpu_zstd_torch
    from tpu_zstd_torch.format import frame as host_frame

    t0 = time.perf_counter()
    out = (tpu_zstd_torch.decompress(frame, device="cpu") if one_shot
           else host_frame.decompress(frame))
    return out, time.perf_counter() - t0


def _same_golden(got: bytes, g: dict, what: str) -> None:
    if (len(got), _sha(got)) != (g["len"], g["sha256"]):
        _fail(f"phase 4g: {what} differs from the JAX golden ({len(got)} bytes)")


def phase_4g(h) -> dict:
    """Phase 4g: the last modules. `h` carries main()'s helpers and data.
    Returns each path's launches by kernel."""
    import concurrent.futures
    import multiprocessing

    import torch

    from tpu_zstd_torch.api import manager
    from tpu_zstd_torch.api.decompress import decode_parsed, parse_batch
    from tpu_zstd_torch.utils import native

    t4g = time.perf_counter()
    card, data, g7, tc, dev = h.card, h.data, h.golden7, h.torch_cases, h.dev
    cpu = _host_cpu()
    where = f"[{card} | host {cpu}]"
    inp = tc.slice7_inputs(data)
    if g7["corpus"] != f"make_corpus({B} * {N})" or g7["seed"] != tc.SLICE7_SEED:
        _fail("phase 4g: torch_slice7.json is not made from the bench corpus")
    paths: dict = {}

    # 1. The native host library from the port's copies: XXH64/32, the engine's
    # frames at levels 1, 3 and 19 of make_corpus(4 MiB), their decode by the
    # engine and by the port's host decoder. The host decodes (pure Python:
    # these three frames and step 2's one-shot decode of the 16 MiB frame)
    # run in four worker processes at once.
    if native.get_native() is None:
        _fail("phase 4g: no C++ compiler for the native host library")
    so = native.library_path()
    if not so.is_relative_to(ROOT / "tpu_zstd_torch" / "_build"):
        _fail(f"phase 4g: the native library is {so}")
    print(f"phase 4g: native host library {so.name} (built in phase 1); host CPU {cpu}")
    for b, g in zip(inp["xxh"], g7["xxh"]):
        got = [native.xxh64(b), native.xxh64(b, 7), native.xxh32(b), native.xxh32(b, 7)]
        if len(b) != g["len"] or got != [g["xxh64"], g["xxh64_seed"], g["xxh32"], g["xxh32_seed"]]:
            _fail(f"phase 4g: XXH64/XXH32 of {len(b)} bytes differ from the JAX golden")
    print(f"phase 4g: XXH64 / XXH32 of {len(inp['xxh'])} seeded buffers (0 B - 1 MiB, seeds 0 "
          f"and 7) == JAX golden")
    d4 = inp["native"]
    rows = []
    for level, g in zip(tc.SLICE7_LEVELS, g7["native"]["frames"]):
        eng = native.NativeEngine.create(level)
        t0 = time.perf_counter()
        f = eng.compress(d4)
        t_c = time.perf_counter() - t0
        _same_golden(f, g, f"the native level-{level} frame")
        t0 = time.perf_counter()
        back = eng.decompress(f, len(d4))
        t_d = time.perf_counter() - t0
        if back != d4:
            _fail(f"phase 4g: NativeEngine.decompress of the level-{level} frame failed")
        h.decodes(f, d4, f"the native level-{level} frame")
        rows.append((level, f, t_c, t_d))
    frame16 = h.frame16
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=4, mp_context=multiprocessing.get_context("spawn")) as ex:
        host_runs = [ex.submit(_host_decode_timed, f, False) for _, f, _, _ in rows]
        one_shot = ex.submit(_host_decode_timed, frame16, True)
        host_runs = [r.result() for r in host_runs]
        host16, t_h16 = one_shot.result()
    t_pool = time.perf_counter() - t0
    for (level, f, t_c, t_d), (host_back, t_h) in zip(rows, host_runs):
        if host_back != d4:
            _fail(f"phase 4g: the port's host decoder returned other bytes for the level-{level} "
                  f"frame")
        print(f"time {where}: NativeEngine level {level}, make_corpus(4 MiB) == JAX golden "
              f"({len(f)} bytes, ratio {len(d4) / len(f):.4f}): compress {t_c * 1e3:.1f} ms = "
              f"{len(d4) / t_c / 1e6:.2f} MB/s, NativeEngine.decompress {t_d * 1e3:.1f} ms = "
              f"{len(d4) / t_d / 1e6:.2f} MB/s, the port's host decoder {t_h:.2f} s = "
              f"{len(d4) / t_h / 1e6:.3f} MB/s (one of 4 decodes in parallel processes, "
              f"{t_pool:.1f} s for all)")

    # 2. The host parse with native Huffman literals: decompress_batch_tpu on
    # the 16 MiB level-3 frame (torch_slice5.json), then the one-shot host
    # decode of the same frame.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    parsed = parse_batch([frame16])
    t_parse = time.perf_counter() - t0
    base = h.peak_base()
    (out16,), paths["long_window_decode"], _ = h.record(
        [], lambda: decode_parsed(parsed, device=dev), True)
    peak16 = h.peak_gib(base)
    if out16 != data:
        _fail("phase 4g: decompress_batch_tpu of the 16 MiB frame returned other bytes")
    h.must_launch(paths["long_window_decode"], ("decode_seq", "exec"), "phase 4g 16 MiB decode")
    t_dev = h.best_of(lambda: decode_parsed(parsed, device=dev))
    del parsed
    print(f"time {where}: 16 MiB level-3 frame, decompress_batch_tpu: host parse (parse_batch, "
          f"native Huffman literals) {t_parse:.3f} s (pure-Python literals: 3.581 s at commit "
          f"2298cfb; 1.790-1.956 s for the 16 MiB stream at commit 04f5e05), device half "
          f"{t_dev:.3f} s (best of 2), wall {t_parse + t_dev:.3f} s = "
          f"{len(data) / (t_parse + t_dev) / 1e6:.2f} MB/s; peak device memory {peak16}")
    if host16 != data:
        _fail("phase 4g: the host decode of the 16 MiB frame returned other bytes")
    print(f"time {where}: tpu_zstd_torch.decompress(16 MiB frame) on the host {t_h16:.2f} s = "
          f"{len(data) / t_h16 / 1e6:.3f} MB/s (in a worker process beside step 1's three; "
          f"0.309-0.407 MB/s at commits 2298cfb and 04f5e05)")

    joins: list[bool] = []
    join_args: list = []
    orig_join = manager._assemble_native

    def counted(*a):
        out = orig_join(*a)
        joins.append(out is not None)
        join_args[:] = [a]
        return out

    manager._assemble_native = counted  # until step 6 ends
    try:
        return _phase_4g_device(h, paths, joins, (orig_join, join_args), cpu, where, inp, t4g)
    finally:
        manager._assemble_native = orig_join


def _phase_4g_device(h, paths, joins, join_last, cpu, where, inp, t4g) -> dict:
    """Phase 4g, steps 3-9 (the device paths); `joins` records each call of
    the native frame assembler (True where it joined the batch);
    `join_last` is the unwrapped assembler and the arguments of its last
    call."""
    import torch
    import torch.distributed as dist

    import tpu_zstd_torch
    from tpu_zstd_torch.api import adaptive, hybrid, manager, nvcomp
    from tpu_zstd_torch.api.config import CompressionConfig
    from tpu_zstd_torch.ops.pipeline import DEFAULT_CONFIG
    from tpu_zstd_torch.parallel import compress_batch_distributed, compress_blocks_sharded
    from tpu_zstd_torch.parallel import make_mesh
    from tpu_zstd_torch.utils.profiler import get_profiler

    data, g7, tc, dev = h.data, h.golden7, h.torch_cases, h.dev
    bm3_frames, items16 = h.bm3
    gi = h.golden2["items"]

    def joined(since: int) -> str:
        new = joins[since:]
        if not all(new):
            _fail("phase 4g: the native frame assembler returned nothing")
        return f"{len(new)} of its batches joined by the native assembler"

    # 3. compress_items of the 16 level-3 items: the native frame assembler
    # wherever its condition holds (no trim, no empty item).
    base = h.peak_base()
    n0 = len(joins)
    frames_i, paths["items"], _ = h.record(
        [], lambda: manager.compress_items(items16, CompressionConfig.from_level(3), device=dev),
        True)
    peak_i = h.peak_gib(base)
    h.same_frames(frames_i, gi["frames"], "phase 4g compress_items")
    print(f"phase 4g: compress_items(16 items, level 3) == JAX golden; {joined(n0)}; launches "
          f"{paths['items']}; peak device memory {peak_i}")
    # The two joins of the host on that batch's blocks, the same frames.
    native_join, (args,) = join_last[0], join_last[1]
    t_join, joined_by = {}, {}
    for name, fn in (("native", native_join), ("Python", manager._assemble_python)):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            joined_by[name] = fn(*args)
            best = min(best, time.perf_counter() - t0)
        t_join[name] = best * 1e3
    if joined_by["native"] != joined_by["Python"] or not all(
            f.startswith(j) for f, j in zip(frames_i, joined_by["native"])):
        _fail("phase 4g: the native and the Python joins gave other frames")
    print(f"time {where}: the frame join of the 16 items ({sum(map(len, frames_i))} bytes), "
          f"best of 3 on the host: native assembler {t_join['native']:.3f} ms, Python join "
          f"{t_join['Python']:.3f} ms")

    prof = get_profiler()
    prof.reset()
    prof.enable()

    # 4. HybridEngine on the card.
    def show(label, res):
        print(f"phase 4g: {label}: HybridResult(backend={res.backend.name}, "
              f"reason={res.routing_reason!r}, in {res.input_size}, out {res.output_size}, "
              f"{res.total_time_s * 1e3:.2f} ms = {res.throughput_mbps:.2f} MB/s)")

    def route_of(mode, size, loc, is_c):
        eng = hybrid.HybridEngine(hybrid.HybridConfig(mode=hybrid.RoutingMode(mode)), device=dev)
        b, why = eng.decide_route(size, hybrid.DataLocation(loc), is_c)
        return {"call": [mode, size, loc, is_c], "backend": int(b), "reason": why}

    if [route_of(*c) for c in tc.SLICE7_ROUTES] != g7["routes"]:
        _fail("phase 4g: HybridEngine.decide_route differs from the JAX golden")
    eng = hybrid.HybridEngine(device=dev)
    res = hybrid.HybridResult()
    n0 = len(joins)
    with prof.scope("4g hybrid AUTO 16 MiB", len(data)):
        f16, paths["hybrid_auto"], _ = h.record([], lambda: eng.compress(data, result=res), True)
    if not joins[n0:]:
        _fail("phase 4g: the 16 MiB item did not take the native frame assembler")
    if res.backend != hybrid.Backend.TPU_KERNELS:
        _fail(f"phase 4g: AUTO routed 16 MiB of host bytes to {res.backend.name}")
    _same_golden(f16, h.golden5, "HybridEngine AUTO's 16 MiB frame")
    h.must_launch(paths["hybrid_auto"], ("roll", "concat", "greedy", "rep", "chain"),
                  "phase 4g HybridEngine AUTO")
    show(f"AUTO, 16 MiB host bytes (frame == torch_slice5.json; {joined(n0)})", res)
    res = hybrid.HybridResult()
    with prof.scope("4g hybrid AUTO 64 KB", len(inp["host"])):
        f64, l64, _ = h.record([], lambda: eng.compress(inp["host"], result=res), True)
    if res.backend != hybrid.Backend.CPU_LIBZSTD or any(l64.values()):
        _fail(f"phase 4g: AUTO on 64 KB took {res.backend.name} with launches {l64}")
    _same_golden(f64, g7["host_frame"], "HybridEngine AUTO's 64 KB frame (native engine)")
    show("AUTO, 64 KB host bytes (native engine frame == JAX golden)", res)
    t1m = torch.frombuffer(bytearray(data[: 1 << 20]), dtype=torch.uint8).to(dev)
    if hybrid.detect_location(t1m) != hybrid.DataLocation.DEVICE:
        _fail("phase 4g: a CUDA tensor is not DEVICE")
    res = hybrid.HybridResult()
    base = h.peak_base()
    with prof.scope("4g hybrid AUTO 1 MiB CUDA tensor", 1 << 20, sync=t1m):
        ft, paths["hybrid_device"], _ = h.record([], lambda: eng.compress(t1m, result=res), True)
    peak_t = h.peak_gib(base)
    if res.backend != hybrid.Backend.TPU_KERNELS:
        _fail(f"phase 4g: a CUDA tensor was routed to {res.backend.name}")
    h.must_launch(paths["hybrid_device"], ("roll", "concat", "greedy", "rep", "chain"),
                  "phase 4g HybridEngine CUDA tensor")
    show(f"AUTO, 1 MiB uint8 CUDA tensor (DEVICE; peak device memory {peak_t})", res)
    eng_t = hybrid.HybridEngine(hybrid.HybridConfig(mode=hybrid.RoutingMode.FORCE_TPU), device=dev)
    if eng_t.decompress(ft) != data[: 1 << 20]:
        _fail("phase 4g: the CUDA tensor's frame does not decode on the card")
    acc_frames, acc_items = h.accel
    t0 = time.perf_counter()
    with prof.scope("4g hybrid FORCE_TPU decode 128 accel frames", B * N):
        outs, paths["hybrid_decode_accel"], _ = h.record(
            [], lambda: [eng_t.decompress(f) for f in acc_frames], True)
    t_acc = time.perf_counter() - t0
    if outs != acc_items:
        _fail("phase 4g: FORCE_TPU decode of the 128 accel frames returned other bytes")
    h.must_launch(paths["hybrid_decode_accel"], ("decode_huf", "decode_seq", "exec"),
                  "phase 4g FORCE_TPU accel decode")
    wide = tc.rehead_wide(bm3_frames[0])
    res = hybrid.HybridResult()
    with prof.scope("4g hybrid FORCE_TPU decode wide frame", len(items16[0])):
        outw, paths["hybrid_decode_wide"], _ = h.record(
            [], lambda: eng_t.decompress(wide, result=res), True)
    if outw != items16[0] or res.backend != hybrid.Backend.TPU_KERNELS:
        _fail("phase 4g: FORCE_TPU decode of the re-headed multi-block frame failed")
    h.must_launch(paths["hybrid_decode_wide"], ("decode_seq", "exec"),
                  "phase 4g FORCE_TPU wide decode")
    print(f"phase 4g: FORCE_TPU decompress of the 128 decode_accel frames, one call a frame "
          f"(the prepared plan: launches {paths['hybrid_decode_accel']}) == the items, "
          f"{t_acc:.2f} s; of "
          f"a 2-block frame re-headed to an 8 MiB window (decompress_batch_tpu: launches "
          f"{paths['hybrid_decode_wide']}) == its item")
    show("FORCE_TPU decode of the re-headed frame", res)
    ada = hybrid.HybridEngine(hybrid.HybridConfig(mode=hybrid.RoutingMode.ADAPTIVE), device=dev)
    seen = []
    for label, x in (("64 KB", inp["host"]), ("16 MiB", data)):
        res = hybrid.HybridResult()
        ada.compress(x, result=res)
        seen.append(res.backend)
        show(f"ADAPTIVE before both histories hold samples (AUTO's route), {label}", res)
    # Both histories hold samples: the input whose AUTO route the averages overrule.
    cpu_avg, tpu_avg = ada._avg(hybrid.Backend.CPU_LIBZSTD), ada._avg(hybrid.Backend.TPU_KERNELS)
    wins = (hybrid.Backend.TPU_KERNELS if tpu_avg > cpu_avg * ada.config.adaptive_hysteresis
            else hybrid.Backend.CPU_LIBZSTD)
    label, x = ("64 KB", inp["host"]) if wins == hybrid.Backend.TPU_KERNELS else ("16 MiB", data)
    res = hybrid.HybridResult()
    ada.compress(x, result=res)
    show(f"ADAPTIVE with both histories, {label}", res)
    if seen != [hybrid.Backend.CPU_LIBZSTD, hybrid.Backend.TPU_KERNELS] or \
            res.backend != wins or not res.routing_reason.startswith("adaptive"):
        _fail(f"phase 4g: ADAPTIVE did not switch backend once both histories held samples "
              f"({[b.name for b in seen]}, then {res.backend.name}: {res.routing_reason})")
    hf = tpu_zstd_torch.hybrid_compress(inp["host"], device=dev)
    if tpu_zstd_torch.hybrid_decompress(hf, device=dev) != inp["host"]:
        _fail("phase 4g: hybrid_compress / hybrid_decompress do not round-trip")
    print(f"phase 4g: ADAPTIVE switched {label} to {wins.name} once both histories held samples "
          f"(CPU {cpu_avg:.1f}, card {tpu_avg:.1f} MB/s); hybrid_compress / hybrid_decompress "
          f"round-trip ({len(hf)} bytes)")

    # 5. NvcompV5BatchManager over the 16 items.
    nv = nvcomp.NvcompV5BatchManager(level=3, device=dev)
    base = h.peak_base()
    with prof.scope("4g nvcomp compress 16 items", sum(map(len, items16))):
        box, paths["nvcomp"], _ = h.record([], lambda: nv.compress(items16), True)
    peak_nv = h.peak_gib(base)
    meta, pos = nv.get_metadata(box)
    _same_golden(box[:pos], g7["nvcomp_meta"], "the nvCOMP metadata frame")
    chunks = []
    for c in meta.compressed_sizes:
        chunks.append(box[pos : pos + c])
        pos += c
    h.same_frames(chunks, gi["frames"], "phase 4g nvCOMP container chunks")
    t0 = time.perf_counter()
    if nv.decompress(box) != items16 or nv.decompress_chunk(box, 7) != items16[7]:
        _fail("phase 4g: the nvCOMP container does not decode to the items")
    t_nvd = time.perf_counter() - t0
    print(f"phase 4g: NvcompV5BatchManager(level=3): the container ({len(box)} bytes) is the "
          f"metadata frame == JAX golden and the 16 frames == JAX golden; decompress (host "
          f"decoder) and decompress_chunk(7) == the items ({t_nvd:.2f} s); launches "
          f"{paths['nvcomp']}; peak device memory {peak_nv}")

    # 6. The OOM ladder: BatchManager(level=3) over the 16 items under a
    # memory cap. The caching allocator checks its cap against the memory it
    # holds from the card (reserved), and earlier phases leave tensors whose
    # segments' free space serves part of a new call, so the cap is the
    # reserved memory plus 0.75 of the reserved growth the same call needs
    # unconstrained (its allocated peak is printed beside).
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = h.peak_base()
    reserved0 = torch.cuda.memory_reserved()
    manager.compress_items(items16, CompressionConfig.from_level(3), device=dev)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    grow = torch.cuda.max_memory_reserved() - reserved0
    torch.cuda.empty_cache()
    total = torch.cuda.get_device_properties(0).total_memory
    reserved0 = torch.cuda.memory_reserved()
    cap = reserved0 + int(0.75 * grow)
    bm = manager.BatchManager(level=3, device=dev)
    how = (f"cap {cap / 2**30:.3f} GiB of {total / 2**30:.1f} (reserved {reserved0 / 2**30:.3f} "
           f"+ 0.75 x the unconstrained call's reserved growth {grow / 2**30:.3f}; its "
           f"allocated peak {peak / 2**30:.3f})")
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        with prof.scope("4g BatchManager under the cap", sum(map(len, items16))):
            res_o, paths["oom_ladder"], _ = h.record([], lambda: bm.compress_batch(items16), True)
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    if bm.degradations == 0:
        # The cap did not bite: inject the error at the call, as the CPU test does.
        orig = manager.compress_items

        def oom(its, *a, **k):
            if len(its) > 1:
                raise torch.cuda.OutOfMemoryError("injected")
            return orig(its, *a, **k)

        manager.compress_items = oom
        try:
            bm = manager.BatchManager(level=3, device=dev)
            res_o, paths["oom_ladder"], _ = h.record([], lambda: bm.compress_batch(items16), True)
        finally:
            manager.compress_items = orig
        how += "; it did not bite, so the error was injected at the call"
    h.same_frames([r.output for r in res_o], gi["frames"], "phase 4g OOM ladder")
    if bm.degradations < 1:
        _fail("phase 4g: the OOM ladder counted no split")
    if bm.host_fallbacks:
        _fail(f"phase 4g: the OOM ladder finished {bm.host_fallbacks} items on the host")
    print(f"phase 4g: BatchManager(level=3) over the 16 items, {how}: {bm.degradations} splits, "
          f"{bm.host_fallbacks} items finished on the host, every frame == JAX golden; "
          f"launches {paths['oom_ladder']}")
    prof.disable()

    # 7. Adaptive levels; AdaptiveLevelSelector.config_for feeds a Manager on the card.
    got = [[adaptive.select_adaptive_level(d, p) for p in adaptive.Preference]
           for d in inp["adaptive"]]
    if got != g7["adaptive"]:
        _fail(f"phase 4g: select_adaptive_level gave {got}, the JAX golden {g7['adaptive']}")
    sel = adaptive.AdaptiveLevelSelector(adaptive.Preference.RATIO)
    cfg_a = sel.config_for(inp["adaptive"][0])
    base = h.peak_base()
    fa, paths["adaptive_manager"], _ = h.record(
        [], lambda: manager.Manager(config=cfg_a, device=dev).compress(inp["adaptive"][0]), True)
    peak_a = h.peak_gib(base)
    h.must_launch(paths["adaptive_manager"], ("roll", "greedy", "rep", "chain", "opt"),
                  "phase 4g adaptive Manager")
    if eng_t.decompress(fa) != inp["adaptive"][0]:
        _fail("phase 4g: the adaptive-level frame does not decode on the card")
    print(f"phase 4g: select_adaptive_level (corpus, random, one byte) x (SPEED, BALANCED, "
          f"RATIO) == JAX golden {got}; config_for(corpus, RATIO) -> level {cfg_a.level}: "
          f"Manager.compress(1 MiB) on the card, {len(fa)} bytes, decoded on the card; "
          f"launches {paths['adaptive_manager']}; peak device memory {peak_a}")

    # 8. The profiler's report over steps 4-6.
    print(f"phase 4g: profiler report (steps 4-6): {json.dumps(prof.report())}")

    # 9. Sharding in an NCCL group of one rank.
    dist.init_process_group("nccl" if torch.device(dev).type == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh(device=dev)
        blocks_np = np.frombuffer(data, np.uint8).reshape(B, N)
        lens_np = np.full(B, N, np.int32)
        base = h.peak_base()
        (cont, clen, btyp), paths["sharded"], _ = h.record(
            [], lambda: compress_blocks_sharded(blocks_np, lens_np, DEFAULT_CONFIG, mesh), True)
        peak_s = h.peak_gib(base)
        gb = h.golden2["batch"]["blocks"]
        bad = [b for b in range(B)
               if (int(btyp[b]), int(clen[b]), _sha(cont[b, : clen[b]].tobytes()))
               != (gb[b]["btype"], gb[b]["clen"], gb[b]["sha256"])]
        if bad:
            _fail(f"phase 4g: compress_blocks_sharded: {len(bad)} blocks differ from the JAX "
                  f"golden (first {bad[:8]})")
        fd, paths["distributed"], _ = h.record(
            [], lambda: compress_batch_distributed(items16, DEFAULT_CONFIG, device=dev), True)
        h.same_frames(fd, gi["frames"], "phase 4g compress_batch_distributed")
        h.must_launch(paths["sharded"], ("roll", "concat", "greedy", "rep", "chain"),
                      "phase 4g sharded")
        t_sh = h.best_of(lambda: compress_blocks_sharded(blocks_np, lens_np, DEFAULT_CONFIG, mesh))
    finally:
        dist.destroy_process_group()
    print(f"phase 4g: NCCL group of one rank ({mesh}): compress_blocks_sharded(128 x 128 KB, "
          f"DEFAULT_CONFIG) == every block of the JAX golden ({t_sh * 1e3:.1f} ms, best of 2; "
          f"peak device memory {peak_s}); compress_batch_distributed(16 items) == JAX golden; "
          f"the gather across ranks is shown only by the 2-rank gloo test on the CPU "
          f"(tests/test_torch_parallel.py)")
    print(f"phase 4g: done ({time.perf_counter() - t4g:.1f} s)")
    return paths


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tests"))
    import torch_cases  # the seeded hard inputs of K4 and K8/K9
    from tpu_zstd_torch.api import decompress
    from tpu_zstd_torch.api.config import ChecksumPolicy, CompressionConfig, ExecutionPath, Status
    from tpu_zstd_torch import dictionary
    from tpu_zstd_torch.api.manager import (
        BatchManager,
        Manager,
        StreamingDecompressor,
        StreamingManager,
        _pipeline_config,
        _strip_frame_to_blocks,
        compress_items,
    )
    from tpu_zstd_torch.constants import BLOCK_RAW, BLOCK_RLE
    from tpu_zstd_torch.corpus import make_corpus
    from tpu_zstd_torch.format.frame import parse_frame_header, write_frame_header
    from tpu_zstd_torch.format.xxhash import content_checksum
    from tpu_zstd_torch.ops import (
        _kernels, bitpack, chain, concat, decode, decode_lanes, deposit, fse, greedy, huffman,
        lz77, match, opt, rep, roll, sort,
    )
    from tpu_zstd_torch.ops import exec as execmod
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
    golden3 = json.loads((ROOT / "tests" / "golden" / "torch_slice3.json").read_text())
    golden4 = json.loads((ROOT / "tests" / "golden" / "torch_slice4.json").read_text())
    golden5 = json.loads((ROOT / "tests" / "golden" / "torch_slice5.json").read_text())
    golden6 = json.loads((ROOT / "tests" / "golden" / "torch_slice6.json").read_text())
    golden7 = json.loads((ROOT / "tests" / "golden" / "torch_slice7.json").read_text())
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = _card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # --- 1. build ------------------------------------------------------------------
    # The kernels (nvcc) and the native host library (g++) build side by side.
    import concurrent.futures

    from tpu_zstd_torch.utils import native

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        host_lib = ex.submit(native.get_native)
        _kernels.library()
        if host_lib.result() is None:
            _fail("build: no C++ compiler for the native host library")
    info = _kernels.build_info
    built = f"nvcc {info['seconds']:.2f} s" if "seconds" in info else "library already built"
    print(f"build: {built}; load {time.perf_counter() - t0:.2f} s -> {info['library']}")
    hinfo = native.build_info
    print(f"build: native host library "
          + (f"{hinfo['compiler']} {hinfo['seconds']:.2f} s" if hinfo else "already built")
          + f" -> {native.library_path()}")
    for line in info["ptxas"].splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("ptxas:", line.split("ptxas info    :")[-1].strip())

    def k7_plain(*a, rep_fin=False):
        """K7's plain version, with its final rep triple as the kernel gives it."""
        ll, ml, off, rows = decode.decode_sequences_chunks(*a)
        return (ll, ml, off, decode.final_rep(rows, a[3], a[8], a[9])) if rep_fin else (
            ll, ml, off)

    # Kernel table: name -> (wrapper, plain, source, TPU kernel it replaces).
    K = {
        "roll": (roll.roll_rows, roll.roll_rows_plain, "tpu_zstd_torch/csrc/roll.cu",
                 "tpu_zstd/ops/pallas_roll.py:98 roll_rows"),
        "concat": (concat.concat_fused, concat.concat_fused_plain,
                   "tpu_zstd_torch/csrc/concat.cu", "tpu_zstd/ops/pallas_concat.py:129 concat_varlen"),
        "greedy": (greedy.greedy_segments, greedy.greedy_segments_plain,
                   "tpu_zstd_torch/csrc/greedy.cu", "tpu_zstd/ops/pallas_greedy.py:79 greedy_segments"),
        "rep": (rep.rep_codes, rep.rep_codes_plain, "tpu_zstd_torch/csrc/rep.cu",
                "tpu_zstd/ops/pallas_rep.py:137 rep_codes"),
        "chain": (chain.state_chain3, chain.state_chain3_plain, "tpu_zstd_torch/csrc/chain.cu",
                  "tpu_zstd/ops/pallas_chain.py:108 state_chain3_pallas"),
        "decode_huf": (decode_lanes.decode_huffman_lanes, decode.decode_huffman_device,
                       "tpu_zstd_torch/csrc/decode_huf.cu",
                       "tpu_zstd/ops/pallas_decode.py:112 decode_huffman_lanes"),
        "decode_seq": (decode_lanes.decode_sequences_lanes, k7_plain,
                       "tpu_zstd_torch/csrc/decode_seq.cu",
                       "tpu_zstd/ops/pallas_decode.py:391 decode_sequences_lanes"),
        "exec": (execmod.execute_sequences,
                 lambda *a, **k: (lambda o, n: (o, n.to(torch.int32)))(
                     *decode.execute_sequences_device(*a, **k)),
                 "tpu_zstd_torch/csrc/exec.cu",
                 "tpu_zstd/ops/pallas_exec.py:416 execute_sequences_pallas"),
        "opt": (opt.opt_steps, opt.opt_steps_plain, "tpu_zstd_torch/csrc/opt.cu",
                "tpu_zstd/ops/pallas_opt.py:232 opt_steps"),
        "deposit": (deposit.deposit_bits_pallas, deposit.deposit_bits_pallas_plain,
                    "tpu_zstd_torch/csrc/deposit.cu",
                    "tpu_zstd/ops/pallas_deposit.py:101 deposit_bits_pallas"),
        "sort": (sort.sort_rows, sort.sort_rows_plain, "tpu_zstd_torch/csrc/sort.cu",
                 "tpu_zstd/ops/pallas_sort.py:125 sort_rows"),
        "match": (match.match_windows, match.match_windows_plain, "tpu_zstd_torch/csrc/match.cu",
                  "tpu_zstd/ops/pallas_match.py:133 match_windows"),
    }
    # K8 and K9 are one CUDA kernel (csrc/exec.cu); the kernels line gives
    # each TPU kernel its row.
    K9_REPLACES = "tpu_zstd/ops/pallas_exec.py:512 execute_sequences_pallas_mb"
    # What plain_ms times: K4's plain version walks Python integers on the
    # host (copy to the host included), the others run torch ops on the card.
    PLAIN_KIND = {"rep": "host loop over Python integers"}
    # The kernels whose device time (torch.profiler) the table adds beside the
    # CUDA-event time: their short launches run back to back no faster than
    # the host issues them.
    KERNEL_SYMBOL = {"roll": "roll_kernel", "decode_huf": "decode_huffman_kernel",
                     "decode_seq": "decode_sequences_kernel", "greedy": "greedy_segments_kernel",
                     "chain": "state_chain3_kernel"}
    max_err = {k: 0 for k in K}

    def chain_live(out, nseq):
        """K5 outputs on their live range: pre, nb for 1 <= t < nseq; fin."""
        pre, fin, nb = (x.to(torch.int64) for x in out)
        t = torch.arange(pre.shape[1], device=pre.device)
        live = (t >= 1) & (t < nseq.to(torch.int64)[:, None])
        return torch.where(live, pre, 0), torch.where(live, nb, 0), fin

    def live_cols(x, n):
        """x (rows, cols) with the columns at or past n[row] set to 0."""
        col = torch.arange(x.shape[1], device=x.device)
        return torch.where(col < n.to(torch.int64)[:, None], x, 0)

    def hold(name: str, args: tuple, label: str, kw=None, fns=None) -> None:
        """The kernel (or fns = (wrapper, plain) of the same kernel) against
        its plain version on args: exact equality, dtypes and shapes too."""
        kw = kw or {}
        if name == "decode_seq":  # the final rep triple too
            kw = {**kw, "rep_fin": True}
        kern, plain = fns or (K[name][0], K[name][1])
        a = kern(*args, **kw)
        b = plain(*args, **kw)
        torch.cuda.synchronize()
        if name == "chain":
            a, b = chain_live(a, args[7]), chain_live(b, args[7])
        elif name == "decode_huf":  # live up to nsym
            a, b = (live_cols(a, args[4]),), (live_cols(b, args[4]),)
        elif name == "decode_seq":  # live up to nseq; the final rep triples whole
            a, b = ((*(live_cols(x, args[3]) for x in y[:3]), y[3]) for y in (a, b))
        elif name == "exec":  # live up to out_len
            a, b = (live_cols(a[0], a[1]), a[1]), (live_cols(b[0], b[1]), b[1])
        elif name in ("sort", "match") or fns is None and name == "concat":  # tuples of outputs
            pass
        else:
            a, b = (a,), (b,)
        for x, y in zip(a, b):
            if x.shape != y.shape or x.dtype != y.dtype:
                _fail(f"{name} {label}: kernel {x.shape}/{x.dtype} vs plain {y.shape}/{y.dtype}")
            err = int((x.to(torch.int64) - y.to(torch.int64)).abs().max()) if x.numel() else 0
            max_err[name] = max(max_err[name], err)
            if err != 0:
                _fail(f"{name} {label}: kernel differs from plain version (max abs err {err})")

    def kernel_stats(name, args, kw):
        """The counters K4 (per block: chunks, chunks whose re-walk met no
        earlier walk, fix-up rounds, rows re-walked, tiles one thread
        finished), K8/K9 (per block: tiles, doubling rounds, most rounds in
        a tile), K6 (per stream chunk: lanes that met their speculative
        walk, symbols they re-walked before meeting, lanes that never met,
        fix-up rounds, symbols re-walked in all rounds, symbols decoded in
        series past the last lane) or K7 (per chunk: stream words read
        outside its CTA's staged words, sequences decoded) or K5 (per row:
        passes, steps walked, transfer maps, 64-bit walk) keep when handed a
        stats tensor."""
        if name == "rep":
            shape = (args[0].shape[0], 5)
        elif name == "chain":
            shape = (args[6].shape[0], chain.STATS)
        elif name == "decode_seq":
            shape = (args[0].shape[0] * args[9], decode_lanes.SEQ_STATS)
        elif name == "exec":
            shape = (args[2].shape[0], 3)
        else:
            shape = (args[0].shape[0] * args[6], decode_lanes.HUF_STATS)
        st = torch.zeros(shape, dtype=torch.int32, device=dev)
        K[name][0](*args, **kw, stats=st)
        return st.cpu()

    def chain_counters(st):
        """K5's counters over the rows: passes a row (max, mean), steps
        walked, rows that took the transfer maps or the 64-bit walk."""
        st = st.to(torch.int64)
        return {"rows": st.shape[0], "passes_max": int(st[:, 0].max()),
                "passes_mean": round(float(st[:, 0].double().mean()), 3),
                "steps": int(st[:, 1].sum()), "map_rows": int(st[:, 2].sum()),
                "slow_rows": int(st[:, 3].sum())}

    def seq_counters(st):
        """K7's counters summed over the chunks."""
        st = st.to(torch.int64)
        return {"chunks_walked": int((st[:, 1] > 0).sum()), "sequences": int(st[:, 1].sum()),
                "longest_chain": int(st[:, 1].max()) if st.numel() else 0,
                "words_not_staged": int(st[:, 0].sum())}

    def huf_counters(args, st):
        """K6's counters summed over the chunks with symbols."""
        st = st.to(torch.int64)
        nsym_a, stride_a, nc_a = args[4].to(torch.int64).cpu(), args[5], args[6]
        chunks = int(torch.clamp((nsym_a + stride_a - 1) // stride_a, 0, nc_a).sum())
        return {"chunks": chunks, "lanes_met": int(st[:, 0].sum()),
                "symbols_before_meeting": int(st[:, 1].sum()),
                "lanes_unmet": int(st[:, 2].sum()), "fixup_rounds_max": int(st[:, 3].max()),
                "fixup_rounds": int(st[:, 3].sum()), "symbols_rewalked": int(st[:, 4].sum()),
                "tail_symbols": int(st[:, 5].sum())}

    # --- 2. kernels vs plain, seeded inputs ---------------------------------------------
    rng = np.random.default_rng(1234)

    def cu(a):
        return torch.from_numpy(np.array(a)).to(dev)

    t0 = time.perf_counter()
    hold("roll", (cu(rng.integers(0, 256, (B, N), dtype=np.uint8)),
                  cu(rng.integers(0, N, B))), "u8 (128, 131072)")
    hold("roll", (cu(rng.integers(-2**31, 2**31, (B, 32768), dtype=np.int32)),
                  cu(rng.integers(0, 32768, B))), "i32 (128, 32768)")
    # K1's hard inputs (tests/torch_cases.py roll_hard_rows): int64 word rows
    # of widths 2, 3 and 11 with 10^6 rows and of width 16384, byte rows
    # whose width is no multiple of 16 (110600) or is one (160), int32 rows
    # of odd width; shifts 0, W, -1, +-3W, W - 1, 1, -W - 5, 2^40 + 7, then
    # drawn from [-3W, 3W].
    for k, (dt, R, W) in enumerate(((np.int64, 10**6, 2), (np.int64, 10**6, 3),
                                    (np.int64, 10**6, 11), (np.int64, 256, 16384),
                                    (np.uint8, B, 110600), (np.uint8, 4096, 160),
                                    (np.int32, B, 32767))):
        x, s = (cu(a) for a in torch_cases.roll_hard_rows(k, dt, R, W))
        hold("roll", (x, s), f"hard {x.dtype} ({R}, {W})")
        nb = 2 * x.numel() * x.element_size() + s.numel() * 8
        print(f"time [{card}]: K1 hard {x.dtype} ({R}, {W}) "
              f"{_time_ms(lambda: roll.roll_rows(x, s), 20):.4f} ms, on the device "
              f"{_fmt_ms(_device_ms(lambda: roll.roll_rows(x, s), 20, KERNEL_SYMBOL['roll']))}, "
              f"bound {nb / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del x, s
    for W, out_len in ((2048, N), (512, 32768), (512, 16384)):
        off = rng.integers(0, W, (B, 64))
        cnt = rng.integers(0, W - off + 1)
        hold("concat", (cu(rng.integers(0, 1 << 30, (B, 64, W), dtype=np.int32)),
                        cu(off.astype(np.int32)), cu(cnt.astype(np.int32)), out_len),
             f"one int32 operand (128, 64, {W}) -> {out_len}",
             fns=(concat.concat_varlen, concat.concat_varlen_plain))
    # K2's fused entry (every operand in one launch, the casts in the
    # kernel) on tests/torch_cases.py concat_fused_hard operands: full
    # windows, prefixes past out_len, empty windows, pk at and past 2^31 and
    # 2^32 and negative, literal offsets at every residue mod 16; at the
    # tier-1 case's shape, at the parse's (128 x 64 x 2048 -> 131072 bytes
    # and 32768 rows), at widths and lengths off 16 bytes, and from sources
    # that do not start on 16 bytes (element reads).
    def fused_ops(**kw):
        return torch_cases.concat_fused_operands(torch_cases.concat_fused_hard(**kw), cu)

    for label, kw in (("the tier-1 shape", {}),
                      ("the parse's shape", dict(seed=386, B=B, NW=64, W=2048, lit_len=N,
                                                 seq_len=32768)),
                      ("W 100, odd lengths", dict(seed=387, B=4, NW=5, W=100, lit_len=1001,
                                                  seq_len=333))):
        kops = fused_ops(**kw)
        hold("concat", (kops,), f"fused hard operands, {label}")
    run_k2 = lambda: concat.concat_fused(kops)  # noqa: E731
    print(f"time [{card}]: K2 fused hard operands, W 100: {_time_ms(run_k2, 20):.4f} ms")
    kops = fused_ops(seed=386, B=B, NW=64, W=2048, lit_len=N, seq_len=32768)
    run_k2 = lambda: concat.concat_fused(kops)  # noqa: E731
    print(f"time [{card}]: K2 fused hard operands, the parse's shape: "
          f"{_time_ms(run_k2, 20):.4f} ms, queued {_queued_ms(run_k2, 20):.4f} ms")
    hi = torch_cases.concat_fused_hard(seed=388, B=2, NW=8, W=256, lit_len=777, seq_len=131)
    kops = torch_cases.concat_fused_operands(hi, cu)
    shifted = cu(np.concatenate([hi["pk"], hi["pk"][..., :1]], -1))[..., 1:]
    kops[0] = kops[0]._replace(src=shifted)
    kops[2] = kops[2]._replace(src=shifted[..., : hi["SC"]])
    hold("concat", (kops,), "fused hard operands, sources off 16 bytes")
    del kops, shifted, run_k2
    # K1, K2 and K3 at the widths of phase 4f's rows: a 64 KB window before a
    # 128 KB block (196,608; K2 joins 96 windows of 2048, K3 walks 192
    # segments a row) and, for K1, a 1 MiB window (1,179,648).
    for R, W in ((B, 196608), (8, 1179648)):
        xw = cu(rng.integers(0, 256, (R, W), dtype=np.uint8))
        sw_ = cu(rng.integers(0, W + 1, R))
        hold("roll", (xw, sw_), f"u8 ({R}, {W})")
        print(f"time [{card}]: K1 u8 ({R}, {W}) {_time_ms(lambda: roll.roll_rows(xw, sw_), 20):.4f}"
              f" ms, bound {(2 * xw.numel() + 8 * R) / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del xw, sw_
    kops = fused_ops(seed=389, B=B, NW=96, W=2048, lit_len=196608, seq_len=32768)
    hold("concat", (kops,), "fused hard operands, the enable_ldm rows' shape (128, 96, 2048)")
    run_k2 = lambda: concat.concat_fused(kops)  # noqa: E731
    print(f"time [{card}]: K2 fused hard operands (128, 96, 2048) -> 196608 bytes and 32768 rows:"
          f" {_time_ms(run_k2, 20):.4f} ms")
    del kops, run_k2
    S192 = B * 192
    stepw = np.minimum(rng.integers(1, 40, (S192, 1024)), 1024 - np.arange(1024))
    matchw = (rng.random((S192, 1024)) < 0.4) & (stepw >= 4)
    deferw = (rng.random((S192, 1024)) < 0.1) & matchw
    gw = cu((stepw | matchw << 11 | deferw << 12).astype(np.int32))
    hold("greedy", (gw,), f"({S192}, 1024)")
    print(f"time [{card}]: K3 ({S192}, 1024) {_time_ms(lambda: greedy.greedy_segments(gw), 20):.4f}"
          f" ms, bound {5 * gw.numel() / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del gw, stepw, matchw, deferw
    seg, S = 1024, B * N // 1024
    step = rng.integers(1, 40, (S, seg))
    step = np.minimum(step, seg - np.arange(seg))
    matched = (rng.random((S, seg)) < 0.4) & (step >= 4)
    defer = (rng.random((S, seg)) < 0.1) & matched
    hold("greedy", (cu((step | matched << 11 | defer << 12).astype(np.int32)),), "(16384, 1024)")
    # K3's hard segments (tests/torch_cases.py greedy_hard_packed): at the
    # main shape plus a CTA that is not full, and at segment widths that
    # take its byte stores (100, 1000) and 4-byte copies (7).
    for nseg, sw in ((S + 13, seg), (77, 64), (9, 100), (5, 1000), (3, 7)):
        gh = cu(torch_cases.greedy_hard_packed(22, nseg, sw))
        hold("greedy", (gh,), f"hard ({nseg}, {sw})")
        if nseg > S:
            run_g = lambda: greedy.greedy_segments(gh)  # noqa: E731
            print(f"time [{card}]: K3 hard segments ({nseg}, {sw}) {_time_ms(run_g, 20):.4f} ms, "
                  f"queued {_queued_ms(run_g, 20):.4f} ms, "
                  f"on the device {_fmt_ms(_device_ms(run_g, 20, KERNEL_SYMBOL['greedy']))}, "
                  f"bound {5 * gh.numel() / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del gh
    rows = 32768
    offs = np.where(rng.random((B, rows)) < 0.5, rng.integers(1, 6, (B, rows)),
                    rng.integers(1, 1 << 21, (B, rows)))
    valid = np.arange(rows)[None, :] < rng.integers(0, rows + 1, (B, 1))
    packed = np.where(valid, offs | (rng.integers(0, 2, (B, rows)) << 21) | (1 << 22), 0)
    hold("rep", (cu(packed.astype(np.int32)),), "(128, 32768)")
    # K4's hard rows: repeats across chunk boundaries, a block alternating
    # between two offsets (no re-walked chunk meets its speculative walk),
    # ll == 0 rows taking repcode 3, invalid rows scattered between valid
    # ones, nseq 0, and row counts that are no multiple of a chunk.
    for rows_h in (32768 + 77, 2100):
        hard = cu(torch_cases.rep_hard_rows(rows_h, rows_h))
        hold("rep", (hard,), f"hard rows (6, {rows_h})")
        print(f"phase 2: K4 hard rows (6, {rows_h}) per block [chunks, unmet, rounds, rows "
              f"re-walked, serial tiles]: {kernel_stats('rep', (hard,), {}).tolist()}")
        print(f"time [{card}]: K4 hard rows (6, {rows_h}) "
              f"{_time_ms(lambda: rep.rep_codes(hard), 3):.4f} ms")
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
        cargs = (st, dnb, dfs, init, torch.full((R,), 6, device=dev), rle, rsym, nseq)
        hold("chain", cargs, f"({R}, {msb})")
        print(f"phase 2: K5 seeded ({R}, {msb}) counters: "
              f"{chain_counters(kernel_stats('chain', cargs, {}))}")
    # K5's hard calls (tests/torch_cases.py chain_hard_inputs) and tables
    # outside the encoder's contract (chain_garbage_inputs); the 63-state row
    # whose walks never meet (row 4 of the first call) also alone, at the
    # cap and at the bench batch's bucket width.
    hard_calls = [("hard", c) for c in torch_cases.chain_hard_inputs()]
    lone = {k: v[4:5] for k, v in hard_calls[0][1].items()}
    hard_calls.append(("non-contracting row alone", lone))
    hard_calls.append(("non-contracting row alone",
                       {**lone, "rsym": lone["rsym"][:, :21760], "nseq": np.array([21760])}))
    hard_calls += [("garbage", c) for c in torch_cases.chain_garbage_inputs()]
    for label, c in hard_calls:
        cargs = tuple(cu(c[k]) for k in torch_cases.CHAIN_KEYS)
        shape = f"({cargs[6].shape[0]}, {cargs[6].shape[1]}) S {cargs[1].shape[1]}"
        hold("chain", cargs, f"{label} {shape}")
        run_c = lambda: chain.state_chain3(*cargs)  # noqa: E731
        print(f"phase 2: K5 {label} {shape} counters: "
              f"{chain_counters(kernel_stats('chain', cargs, {}))}; {_time_ms(run_c, 10):.4f} ms, "
              f"queued {_queued_ms(run_c, 10):.4f} ms, "
              f"on the device {_fmt_ms(_device_ms(run_c, 10, KERNEL_SYMBOL['chain']))}")
    del cargs

    # --- recording the inputs a path hands the kernels ---------------------------------
    def key_of(x):
        if torch.is_tensor(x):
            return (tuple(x.shape), str(x.dtype))
        if isinstance(x, (tuple, list)):
            return tuple(key_of(v) for v in x)
        return x

    def clone(x):
        if torch.is_tensor(x):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(clone(v) for v in x))
        if isinstance(x, (tuple, list)):
            return type(x)(clone(v) for v in x)
        return x

    def record(sites, run, count: bool):
        """Run `run()` with the call sites patched to capture each distinct
        input (args, kwargs, calls) a kernel wrapper received; with count,
        every kernel's launch count is set to 0 just before and read just
        after."""
        captured: dict[str, dict] = {k: {} for k in [*K, *(s[0] for s in sites)]}
        originals = {(mod, attr): getattr(mod, attr) for _, mod, attr in sites}

        def recorder(name, fn):
            def call(*args, **kw):
                key = (key_of(args), key_of(sorted(kw.items())))
                if key not in captured[name]:
                    captured[name][key] = [clone(args), clone(kw), 0]
                captured[name][key][2] += 1
                return fn(*args, **kw)

            return call

        for name, mod, attr in sites:
            setattr(mod, attr, recorder(name, originals[(mod, attr)]))
        try:
            torch.cuda.synchronize()
            if count:
                _kernels.reset_launches()
            out = run()
            torch.cuda.synchronize()
            launches = dict(_kernels.launches)
        finally:
            for (mod, attr), fn in originals.items():
                setattr(mod, attr, fn)
        return out, launches, captured

    def hold_captured(captured, label):
        t0 = time.perf_counter()
        n_real = 0
        for k, inputs in captured.items():
            for key, (args, kw, _) in inputs.items():
                hold(k, args, f"{label} {key[0][0]}", kw)
                n_real += 1
        print(f"{label}: kernels == plain versions on {n_real} captured inputs "
              f"({time.perf_counter() - t0:.1f} s)")

    dec_sites = [("decode_huf", decompress, "decode_huffman_lanes"),
                 ("decode_seq", decompress, "decode_sequences_lanes"),
                 ("exec", decompress, "execute_sequences")]
    accel_cfg = CompressionConfig.from_level(3)
    accel_cfg = dataclasses.replace(accel_cfg, decode_accel=True)

    # K6 and K7 on the inputs the decode plan stages for seeded accel frames:
    # 16 items of 128 KB drawn from a vocabulary of seeded words, with
    # seeded random stretches.
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(2, 12)), dtype=np.uint8)) + b" "
             for _ in range(600)]
    items_s = []
    for _ in range(16):
        words = rng.integers(0, len(vocab), N // 3)
        blob = b"".join(vocab[w] for w in words)
        noise = rng.integers(0, 256, N // 8, dtype=np.uint8).tobytes()
        at = int(rng.integers(0, N // 2))
        items_s.append((blob[:at] + noise + blob[at:])[:N])
    frames_s = compress_items(items_s, accel_cfg, device="cuda")
    (out_s, len_s), _, cap_s = record(
        dec_sites, lambda: decompress.prepare_decompress_batch(frames_s, N).execute(), False)
    out_h, len_h = out_s.cpu().numpy(), len_s.cpu().numpy()
    if any(int(len_h[i]) != N or out_h[i].tobytes() != items_s[i] for i in range(16)):
        _fail("seeded accel frames did not decode to their items")
    for name in ("decode_huf", "decode_seq"):
        for key, (args, kw, _) in cap_s[name].items():
            hold(name, args, f"seeded accel {key[0][0]}", kw)
            if name == "decode_huf":
                print(f"phase 2: K6 seeded accel {key[0][0]} counters: "
                      f"{huf_counters(args, kernel_stats(name, args, kw))}")
            else:
                print(f"phase 2: K7 seeded accel {key[0][0]} counters: "
                      f"{seq_counters(kernel_stats(name, args, kw))}")
    # K6's hard inputs (tests/torch_cases.py huf_hard_inputs, 8 copies of its
    # 5 blocks): 256 codes of 8 bits, table_log 1 and 11, nsym no multiple of
    # the stride and exactly on a chunk boundary, 1-symbol and empty streams,
    # a last chunk whose start record is forward-filled 0, a record 3 bits
    # off; and the same streams with no records (K = 0).
    hv = torch_cases.huf_hard_inputs(5, 1024, 8)
    for label, lck in (("records", hv["lck"]), ("K = 0", hv["lck"][:, :0])):
        hargs = (cu(hv["lstreams"]), cu(hv["ltbits"]), cu(hv["dtab"]), cu(hv["tlog"]),
                 cu(hv["lnsym"]), hv["CL"], hv["NCL"], cu(np.ascontiguousarray(lck)))
        hold("decode_huf", hargs, f"hard streams, {label}")
        print(f"phase 2: K6 hard streams ({hargs[0].shape[0]} x {hv['NCL']} chunks), {label}, "
              f"counters: {huf_counters(hargs, kernel_stats('decode_huf', hargs, {}))}")
        run_h = lambda: decode_lanes.decode_huffman_lanes(*hargs)  # noqa: E731
        print(f"time [{card}]: K6 hard streams, {label}: {_time_ms(run_h, 10):.4f} ms, on the "
              f"device {_fmt_ms(_device_ms(run_h, 10, KERNEL_SYMBOL['decode_huf']))}")

    # K7's hard inputs (tests/torch_cases.py seq_hard_inputs): 16 + 31 + 16
    # extra bits a sequence with offsets wrapping past 2^31, FSE tables of
    # table_log 9/8/9, RLE tables, nseq 1 and 3 strides exactly, a stream
    # that is its end-marker byte, chunks without records, a record past
    # its stream's end, max_seqs below nseq; serially, a 71 KB stream (more
    # than the 64 KB a CTA stages) and a block without sequences; then the
    # chunked set with scrambled records (seq_garbage_inputs).
    hard_seq = torch_cases.seq_hard_inputs()
    hard_seq["garbage"] = torch_cases.seq_garbage_inputs(hard_seq)
    for label, v in hard_seq.items():
        nb_ = len(v["nseq"])
        none = np.zeros((nb_, 0), np.int32)
        sargs = (cu(v["streams"]), cu(v["tbits"]),
                 decode.SeqTables(*(cu(v[k]) for k in ("sym", "nb", "ns", "logs"))),
                 cu(v["nseq"]), cu(np.tile(np.int32([1, 4, 8]), (nb_, 1))),
                 cu(v.get("ckb", none)), cu(v.get("cks", none)),
                 cu(v.get("ckr", none[..., None])), v["C"], v["NC"], v["max_seqs"])
        hold("decode_seq", sargs, f"hard sequences, {label}")
        run_s = lambda: decode_lanes.decode_sequences_lanes(*sargs)  # noqa: E731
        print(f"phase 2: K7 hard sequences, {label} ({nb_} blocks x {v['NC']} chunks of "
              f"{v['C']}), counters: {seq_counters(kernel_stats('decode_seq', sargs, {}))}; "
              f"{_time_ms(run_s, 5):.4f} ms, on the device "
              f"{_fmt_ms(_device_ms(run_s, 5, KERNEL_SYMBOL['decode_seq']))}")

    # K7 serially (one chunk a block, no records), as the multi-block plan
    # runs it, from a seeded rep triple that is not the initial one, with its
    # final triple: the hard sequences of every set.
    for label, v in hard_seq.items():
        nb_ = len(v["nseq"])
        none = np.zeros((nb_, 0), np.int32)
        sargs = (cu(v["streams"]), cu(v["tbits"]),
                 decode.SeqTables(*(cu(v[k]) for k in ("sym", "nb", "ns", "logs"))),
                 cu(v["nseq"]), cu(rng.integers(1, 1 << 20, (nb_, 3)).astype(np.int32)),
                 cu(none), cu(none), cu(none[..., None]),
                 max(decompress.MAX_SEQS_DEC, int(v["nseq"].max())), 1, v["max_seqs"])
        hold("decode_seq", sargs, f"hard sequences, {label}, serial from a carried rep triple")
    print("phase 2: K7 serial from carried rep triples == plain version, final triples too")

    # K8/K9 on seeded valid sequences at the main path's shape (128 blocks of
    # 128 KB): literals front-compacted and from 4-stream rows, no window;
    # and with a 4 KB window.
    def seq_case(W: int, rng=rng, far_end: bool = False, rows: int = B):
        MS = 24576
        ll = rng.integers(0, 24, (rows, MS))
        ll[:, 0] = np.maximum(ll[:, 0], 1)
        ml = rng.integers(3, 64, (rows, MS))
        end = np.cumsum(ll + ml, 1)
        nseq = np.minimum((end <= N - 64).sum(1), rng.integers(MS // 2, MS + 1, rows))
        mstart = end - ml  # the output position of each match
        far = np.floor(rng.random((rows, MS)) * (mstart + W)).astype(np.int64) + 1
        near = np.minimum(rng.integers(1, 9, (rows, MS)), mstart + W)
        off = np.where(rng.random((rows, MS)) < 0.3, near, far)
        if far_end:  # every 50th sequence copies from the window's first byte
            off[:, ::50] = mstart[:, ::50] + W
        live = np.arange(MS)[None, :] < nseq[:, None]
        ll, ml, off = (np.where(live, x, 0).astype(np.int32) for x in (ll, ml, off))
        nlit = ll.sum(1) + rng.integers(0, 32, rows)
        lits = rng.integers(0, 256, (rows, N), dtype=np.uint8)
        window = rng.integers(0, 256, (rows, W), dtype=np.uint8)
        return [cu(x) for x in (lits, nlit.astype(np.int32), ll, ml, off,
                                nseq.astype(np.int32), window)]

    for W in (4096, 0):
        args = seq_case(W)
        hold("exec", tuple(args) + (N, W), f"seeded sequences, window {W}")
    lits, nlit = args[0], args[1]  # the window-0 case
    # K8/K9 at the multi-block plan's history windows of 128 KB and 512 KB,
    # and at 8 MiB (2 blocks), a history decompress_batch_tpu carries past the
    # plan's 4 MiB, with offsets reaching the window's first byte.
    rng_w = np.random.default_rng(15)
    for W, rows in ((131072, B), (524288, B), (1 << 23, 2)):
        wargs = tuple(seq_case(W, rng_w, far_end=True, rows=rows)) + (N, W)
        hold("exec", wargs, f"seeded sequences, {rows} blocks, window {W}, offsets to the "
             "window's first byte")
        print(f"time [{card}]: K8 seeded sequences, {rows} blocks, window {W}: "
              f"{_time_ms(lambda: execmod.execute_sequences(*wargs), 10):.4f} ms")
    del wargs
    seg = torch.clamp((nlit.to(torch.int64) + 3) // 4, min=1)
    col = torch.arange(N // 4 + 64, device=dev)
    rows = []
    for s4 in range(4):
        p = s4 * seg[:, None] + col
        ok = (col < seg[:, None]) & (p < nlit[:, None])
        rows.append(torch.where(ok, lits.gather(1, torch.clamp(p, max=N - 1)), 0))
    syms = torch.stack(rows, 1).reshape(4 * B, -1).to(torch.uint8).contiguous()
    hold("exec", tuple(args) + (N, 0), "seeded sequences, literals from 4-stream rows",
         {"lit_src": (syms, nlit)})
    # K8/K9's hard lists at the block width, one block per pattern: long
    # overlapping matches at off 1-3, a chain of matches each copying the one
    # before it (every doubling round), matches that read the 4 KB window,
    # no sequences (tail literals only, and nothing at all), output filling N
    # exactly; literals front-compacted and from 4-stream rows.
    for W in (4096, 1):
        h = torch_cases.exec_hard_inputs(W + 7, N, W)
        hargs = tuple(cu(x) for x in h) + (N, W)
        hsrc = {"lit_src": (cu(torch_cases.stream_rows(h[0], h[1], N // 4 + 64)), hargs[1])}
        hold("exec", hargs, f"hard lists, window {W}")
        hold("exec", hargs, f"hard lists, window {W}, literals from 4-stream rows", hsrc)
        print(f"phase 2: K8 hard lists, window {W}, per block [tiles, doubling rounds, most "
              f"in a tile]: {kernel_stats('exec', hargs, {}).tolist()}")
        print(f"time [{card}]: K8 hard lists (6, {h[2].shape[1]}), window {W}: "
              f"{_time_ms(lambda: execmod.execute_sequences(*hargs), 10):.4f} ms, from "
              f"4-stream rows {_time_ms(lambda: execmod.execute_sequences(*hargs, **hsrc), 10):.4f}"
              f" ms")
    # K10 (tests/torch_cases.py opt_card_calls): the hard calls, the calls its
    # fast path walks alone, seeded rows and rows that offer every length; the
    # rows each call walked on the fast path; the every-length rows timed
    # beside the bound.
    paths = []
    for label, c in torch_cases.opt_card_calls(B):
        oargs = (cu(c["packed"]), c["mm"], c["cap"])
        okw = {"lit_bits": cu(c["lit"]), "cost_bank": cu(c["bank"])}
        hold("opt", oargs, label, okw)
        st = torch.zeros(oargs[0].shape[0], dtype=torch.int32, device=dev)
        opt.opt_steps(*oargs, **okw, stats=st)
        nfast = int(st.sum())
        paths.append(f"{label}: {nfast}/{st.numel()}")
        if label.startswith("fast") and nfast != st.numel():
            _fail(f"opt {label}: {st.numel() - nfast} rows left the fast path")
    print(f"phase 2: K10 rows walked on the fast path: {'; '.join(paths)}")
    b_ms, b_by = opt_bound_ms(*oargs, okw["lit_bits"], okw["cost_bank"])
    print(f"time [{card}]: K10 rows that offer every length {tuple(oargs[0].shape)} mm 3 cap 64: "
          f"{_time_ms(lambda: opt.opt_steps(*oargs, **okw), 10):.4f} ms, bound {b_ms:.4f} ms "
          f"({b_by})")
    del oargs, okw, st
    # K12: unique keys spanning negative values, with 0-3 payloads.
    for R, W, P in ((2, 1024, 0), (2, 2048, 1), (1, 8192, 3)):
        key = rng.permuted(np.tile(np.arange(W, dtype=np.int32), (R, 1)), axis=1) * 3 - W
        hold("sort", tuple(cu(x.astype(np.int32)) for x in
                           [key] + [rng.integers(-2**31, 2**31, (R, W)) for _ in range(P)]),
             f"({R}, {W}) with {P} payloads")
    # K13: low-entropy windows (hashes collide as in text) at the reference
    # test's shape (2 x 1024) and at the three level shapes (2048 x 8192).
    def lowent_windows(R, W, nw, hl):
        return tuple(cu(a) for a in torch_cases.lowent_windows(rng, R, W, nw, hl))

    for R, W, depth, nw, hl in ((2, 1024, 2, 2, 12), (2, 1024, 8, 8, 12),
                                (2048, 8192, 3, 4, 15), (2048, 8192, 8, 2, 17),
                                (2048, 8192, 8, 16, 17)):
        hold("match", (*lowent_windows(R, W, nw, hl), depth, 1 << hl),
             f"({R}, {W}) depth {depth} words {nw}")
    # K12's and K13's hard sets (tests/torch_cases.py SORT_HARD, MATCH_HARD)
    # at the widths the kernels treat differently: 1024 (8 keys a thread),
    # 8192 (the widest window one CTA sorts), 16384 (one merge-path pass),
    # 32768 and 65536 (two and three); one K12 row of 2^20 columns (seven
    # passes); seeded K12 rows past one CTA at 32768 and 65536 columns, and
    # with 35 payloads (two launches of at most 32).
    for W in (1024, 8192, 16384, 32768, 65536):
        for c, (kinds, P, _) in enumerate(torch_cases.SORT_HARD):
            hold("sort", tuple(cu(x) for x in torch_cases.sort_hard_ops(W, kinds, P, c)),
                 f"hard {'/'.join(kinds)} x {P + 1} operands ({len(kinds)}, {W})")
        for c, (kinds, depth, nw, _) in enumerate(torch_cases.MATCH_HARD):
            mh = torch_cases.match_hard_inputs(W, kinds, depth, nw, c)
            hold("match", (cu(mh["key"]), cu(mh["words"]), depth, mh["sentinel"]),
                 f"hard {'/'.join(kinds)} depth {depth} words {nw} ({len(kinds)}, {W})")
    big = tuple(cu(x) for x in torch_cases.sort_hard_ops(1 << 20, ("extremes_random",), 3, 9))
    hold("sort", big, "hard one row of 2^20 x 4 operands")
    print(f"time [{card}]: K12 one row of 2^20 x 4 operands "
          f"{_time_ms(lambda: sort.sort_rows(*big), 5):.4f} ms, library "
          f"{_time_ms(lambda: sort_library(*big), 5):.4f} ms, bound "
          f"{sort_bound_ms(big):.4f} ms (bytes)")
    del big
    print(f"phase 2: K12 and K13 == their plain versions on the hard sets at widths 1024, "
          f"8192, 16384, 32768 and 65536 and on one K12 row of 2^20")
    for R, W, P in ((2, 32768, 0), (1, 65536, 3), (3, 1024, 35)):
        key = rng.permuted(np.tile(np.arange(W, dtype=np.int32), (R, 1)), axis=1) * 3 - W
        hold("sort", tuple(cu(x.astype(np.int32)) for x in
                           [key] + [rng.integers(-2**31, 2**31, (R, W)) for _ in range(P)]),
             f"wide ({R}, {W}) with {P} payloads")
    # Times: K12 with 1 and 3 operands at 2048 x 8192 (one CTA a row) and at
    # 512 x 32768 and 256 x 65536 (tiles and merge passes), beside torch.sort
    # + torch.gather; K13 at the three level shapes and at 256 x 65536 (its
    # tiled path). Each by CUDA events over back-to-back calls, queued behind
    # a spin kernel, and on the device (torch.profiler), beside d0443a2's
    # time, the bound (bytes, or K13's compares) and one network's int32
    # operations ("network ops", their former bound).
    for R, W, P in ((2048, 8192, 0), (2048, 8192, 2), (512, 32768, 0), (512, 32768, 2),
                    (256, 65536, 0), (256, 65536, 2)):
        key = rng.permuted(np.tile(np.arange(W, dtype=np.int32), (R, 1)), axis=1) * 3 - W
        wops = tuple(cu(x.astype(np.int32)) for x in
                     [key] + [rng.integers(-2**31, 2**31, (R, W)) for _ in range(P)])
        hold("sort", wops, f"({R}, {W}) with {P} payloads")
        run_s = lambda: sort.sort_rows(*wops)  # noqa: E731
        label = f"({R}, {W}) x {P + 1} operands"
        print(f"time [{card}]: K12 {label} {_time_ms(run_s, 20):.4f} ms, queued "
              f"{_queued_ms(run_s, 20):.4f} ms, on the device "
              f"{_fmt_ms(_device_ms(run_s, 10, SORT_KERNELS))}; d0443a2 "
              f"{_fmt_ms(SORT_MATCH_PARENT_MS.get(('sort', label)))}; library "
              f"{_time_ms(lambda: sort_library(*wops), 20):.4f} ms; bound "
              f"{sort_bound_ms(wops):.4f} ms (bytes), network ops {network_ms(R, W):.4f} ms")
    del wops, run_s
    for R, W, depth, nw, hl, label in ((2048, 8192, 3, 4, 15, "level 1"),
                                       (2048, 8192, 8, 2, 17, "level 3"),
                                       (2048, 8192, 8, 16, 17, "level 5"),
                                       (256, 65536, 8, 2, 14, "tiled")):
        margs_w = (*lowent_windows(R, W, nw, hl), depth, 1 << hl)
        hold("match", margs_w, f"{label} ({R}, {W}) depth {depth} words {nw}")
        run_m = lambda: match.match_windows(*margs_w)  # noqa: E731
        b_ms, b_by = match_bound_ms(*margs_w)
        plain_w = (f", plain {_time_ms(lambda: match.match_windows_plain(*margs_w), 3):.4f} ms"
                   if label == "tiled" else "")
        print(f"time [{card}]: K13 {label} ({R}, {W}) depth {depth} words {nw} "
              f"{_time_ms(run_m, 20):.4f} ms, queued {_queued_ms(run_m, 20):.4f} ms, on the "
              f"device {_fmt_ms(_device_ms(run_m, 10, MATCH_KERNELS))}; d0443a2 "
              f"{_fmt_ms(SORT_MATCH_PARENT_MS.get(('match', label)))}{plain_w}; bound "
              f"{b_ms:.4f} ms ({b_by}), network ops {network_ms(R, W):.4f} ms")
    del margs_w, run_m
    # K11: as tests/test_pallas_deposit.py builds its inputs, its sparse
    # case, and 32-bit fields running past the padded width.
    dep_cases = []
    for seed, maxlen in ((0, 20), (1, 32), (2, 6)):
        r2 = np.random.default_rng(seed)
        ln = r2.integers(0, maxlen + 1, (3, 1024)).astype(np.int32)
        dep_cases.append((r2.integers(0, 1 << 31, (3, 1024)).astype(np.int64), ln, None))
    ln = np.zeros((1, 256), np.int32)
    ln[0, 5], ln[0, 200] = 13, 32
    dep_cases.append((np.full((1, 256), 0xDEADBEEF, np.int64), ln, 200))
    dep_cases.append((rng.integers(0, 1 << 32, (2, 1152), dtype=np.uint64).astype(np.int64),
                      np.full((2, 1152), 32, np.int32), 400))
    for vals, ln, nwd in dep_cases:
        offs = (np.cumsum(ln, axis=1) - ln).astype(np.int32)
        nwd = nwd or int(offs.max() // 32) + 64
        hold("deposit", (cu(vals), cu(ln), cu(offs), nwd), f"{vals.shape} -> {nwd} words")
    print(f"phase 2: kernels == plain versions on seeded inputs ({time.perf_counter() - t0:.1f} s)")

    # --- running a main path with counts ---------------------------------------------
    data = make_corpus(B * N)
    blocks = cu(np.frombuffer(data, dtype=np.uint8).reshape(B, N))
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    sites = [("roll", bitpack, "roll_rows"), ("concat", lz77, "concat_fused"),
             ("greedy", lz77, "greedy_segments"), ("rep", lz77, "rep_codes"),
             ("chain", fse, "state_chain3"), ("chain", huffman, "state_chain3"),
             ("opt", lz77, "opt_steps")]

    def drive(run):
        return record(sites, run, True)

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

    def batch_frame(contents, clens, btypes, nblocks=B) -> bytes:
        """One frame of the batch's first nblocks blocks."""
        parts = [write_frame_header(nblocks * N)]
        for b in range(nblocks):
            last = int(b == nblocks - 1)
            clen = 1 if int(btypes[b]) == BLOCK_RLE else int(clens[b])
            size = N if int(btypes[b]) == BLOCK_RLE else clen
            parts += [((size << 3) | (int(btypes[b]) << 1) | last).to_bytes(3, "little"),
                      contents[b, :clen].tobytes()]
        return b"".join(parts)

    said_no_libzstd = []

    def decodes(frame: bytes, expect: bytes, what: str) -> None:
        if zstandard is None:
            if not said_no_libzstd:
                print("libzstd: zstandard is not installed here, so no frame is decoded by "
                      "libzstd; golden identity stands in (libzstd decoded every golden frame "
                      "when it was made)")
                said_no_libzstd.append(True)
            return
        got = zstandard.ZstdDecompressor().decompress(frame, max_output_size=max(len(expect), 1))
        if got != expect:
            _fail(f"libzstd decodes {what} to other bytes")

    def batch_ms(cfg, reps=REPS):
        compress_blocks_staged(blocks, lengths, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dt = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            outs = compress_blocks_staged_many([(blocks, lengths)] * reps, cfg)
            torch.stack([o[1] for o in outs]).cpu()
            dt = min(dt, (time.perf_counter() - t0) / reps)
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
    slice_frame = frame  # decoded in phase 4b
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
    for k in ("roll", "concat", "greedy", "rep", "chain"):
        if launches[k] <= 0:
            _fail(f"kernel {k} was not launched on the DEFAULT_CONFIG path")
    contents, clens, btypes = check_blocks(outs[0], golden2, "phase 4")
    decodes(batch_frame(contents, clens, btypes), data, "the DEFAULT_CONFIG batch frame")

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
    default_frame = frame  # decoded in phase 4b

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
    bm3 = ([r.output for r in res], items)  # decoded in phase 4b
    print("phase 4: libzstd decode: " + ("every frame decoded to its input" if zstandard
          else "zstandard is not installed here; the frames equal goldens that libzstd "
               "decoded when they were made"))
    hold_captured(captured, "phase 4")

    # --- 4b. the decode path --------------------------------------------------------------
    g3 = golden3
    items = [data[i * N : (i + 1) * N] for i in range(B)]
    if [(len(d), _sha(d)) for d in items] != [(g["len"], g["sha256"]) for g in g3["items"]]:
        _fail("phase 4b: the bench items differ from the golden's")
    t0 = time.perf_counter()
    frames = compress_items(items, accel_cfg, device="cuda")
    t_comp = time.perf_counter() - t0
    bad = [k for k, (f, g) in enumerate(zip(frames, g3["frames"]))
           if (len(f), _sha(f)) != (g["len"], g["sha256"])]
    if len(frames) != len(g3["frames"]) or bad:
        _fail(f"phase 4b: {len(bad)} accel frames differ from the JAX golden (first {bad[:8]})")
    ck_cfg = dataclasses.replace(accel_cfg, checksum=ChecksumPolicy.COMPUTE)
    ck_frames = compress_items(items[: len(g3["checksum_frames"])], ck_cfg, device="cuda")
    if [(len(f), _sha(f)) for f in ck_frames] != [(g["len"], g["sha256"])
                                                 for g in g3["checksum_frames"]]:
        _fail("phase 4b: the checksummed accel frames differ from the JAX golden")
    size = sum(len(f) for f in frames)
    print(f"phase 4b: compress_items(128 x 128 KB, level 3, decode_accel) {len(frames)} frames "
          f"== JAX golden ({size} bytes with sidecars, ratio {B * N / size:.4f}, "
          f"{t_comp:.2f} s); {len(ck_frames)} checksummed frames == JAX golden")
    t0 = time.perf_counter()
    (out, lens), dec_launches, dec_captured = record(
        dec_sites, lambda: (lambda plan: (plan, plan.execute()))(
            decompress.prepare_decompress_batch(frames, max_block=N))[1], True)
    print(f"phase 4b: prepare_decompress_batch + execute launches {dec_launches} "
          f"({time.perf_counter() - t0:.2f} s)")
    for k in ("decode_huf", "decode_seq", "exec"):
        if dec_launches[k] <= 0:
            _fail(f"kernel {k} was not launched on the decode path")
    out_h, len_h = out.cpu().numpy(), lens.cpu().numpy()
    wrong = [i for i in range(B) if int(len_h[i]) != N or out_h[i].tobytes() != items[i]]
    if wrong:
        _fail(f"phase 4b: {len(wrong)} of {B} decoded blocks differ from the input "
              f"(first {wrong[:8]})")
    print(f"phase 4b: all {B} decoded blocks == the input, each {N} bytes")
    t0 = time.perf_counter()
    ck_plan = decompress.prepare_decompress_batch(ck_frames, max_block=N)
    ck_out, ck_len = ck_plan.execute(verify_checksum=True)
    if any(ck_out[i, : int(ck_len[i])].cpu().numpy().tobytes() != items[i]
           for i in range(len(ck_frames))):
        _fail("phase 4b: checksummed frames decode to other bytes")
    print(f"phase 4b: execute(verify_checksum=True) on {len(ck_frames)} checksummed frames "
          f"passed ({time.perf_counter() - t0:.2f} s)")
    hold_captured(dec_captured, "phase 4b")

    # Frames without metadata: 8 of phase 4's blocks as single-block frames.
    plain_frames = []
    for b in range(8):
        clen = 1 if int(btypes[b]) == BLOCK_RLE else int(clens[b])
        hdr = ((N if int(btypes[b]) == BLOCK_RLE else clen) << 3) | (int(btypes[b]) << 1) | 1
        plain_frames.append(write_frame_header(N) + hdr.to_bytes(3, "little")
                            + contents[b, :clen].tobytes())
    t0 = time.perf_counter()
    (sout, slen), ser_launches, ser_captured = record(
        dec_sites, lambda: decompress.prepare_decompress_batch(plain_frames, N).execute(), True)
    t_ser = time.perf_counter() - t0
    if ser_launches["decode_seq"] <= 0 or ser_launches["decode_huf"] != 0:
        _fail(f"phase 4b: the serial decode launched {ser_launches}")
    if any(int(slen[i]) != N or sout[i].cpu().numpy().tobytes() != items[i] for i in range(8)):
        _fail("phase 4b: frames without metadata decode to other bytes")
    print(f"phase 4b: 8 frames without metadata (serial K7, host literals) == the input "
          f"(launches {ser_launches}; {t_ser:.2f} s with the host literal decode)")
    hold_captured(ser_captured, "phase 4b serial")

    # Multi-block frames (the chained-round plan: K7 serially from the rep
    # triple the round before left, K8 against the carried history): the
    # SLICE_CONFIG and DEFAULT_CONFIG 4-block frames, the 16 level-3
    # BatchManager frames (timed), and one mixed batch: the first 32 blocks
    # of the DEFAULT_CONFIG batch as one 4 MiB frame (history windows up to
    # 4 MiB), the two 4-block frames, libzstd's multi-block frames of
    # tests/golden/multiblock_frames.json (repeat offsets and matches across
    # blocks) and two single-block decode_accel frames; the kernels against
    # their plain versions on the inputs the mixed batch gave them.
    def decode_multi(label, frames_m, expect, checksum, hold_kernels=False, timed=False):
        t0 = time.perf_counter()
        (o, n), lm, cap_m = record(dec_sites, lambda: decompress.prepare_decompress_batch(
            frames_m, N).execute(verify_checksum=checksum), True)
        t_m = time.perf_counter() - t0
        if lm["decode_seq"] <= 0 or lm["exec"] <= 0 or lm["decode_huf"] != 0:
            _fail(f"{label}: the multi-block decode launched {lm}")
        n_h, o_h = n.cpu().numpy(), o.cpu().numpy()
        bad = [k for k, e in enumerate(expect)
               if int(n_h[k]) != len(e) or o_h[k, : len(e)].tobytes() != e]
        if bad:
            _fail(f"{label}: {len(bad)} of {len(expect)} frames decode to other bytes "
                  f"(first {bad[:8]})")
        print(f"{label}: {len(frames_m)} frames == their inputs ({sum(map(len, expect))} bytes, "
              f"rows {tuple(o.shape)}; K7 / K8 launches an execute() {lm['decode_seq']} / "
              f"{lm['exec']}{'; checksums verified' if checksum else ''}; {t_m:.2f} s with "
              f"the prepare)")
        if hold_kernels:
            hold_captured(cap_m, label)
        if timed:
            plan_m = decompress.prepare_decompress_batch(frames_m, N)
            plan_m.execute()
            torch.cuda.synchronize()
            best = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                pending = [plan_m.execute() for _ in range(3)]
                for _, ln in pending:
                    ln.cpu()
                best = min(best, (time.perf_counter() - t0) / 3)
            nb_m = sum(map(len, expect))
            run_m = plan_m.execute
            dev_m = {k: _device_ms(run_m, 3, sym) for k, sym in (
                ("K7", "decode_sequences_kernel"), ("K8", "exec_sequences_kernel"),
                ("every kernel", ""))}
            print(f"time [{card}]: {label} decode, prepare_decompress_batch(...).execute() "
                  f"{best * 1e3:.3f} ms = {nb_m / best / 1e9:.4f} GB/s (3 executes with lengths "
                  f"fetched, best of 2); K7 / K8 launches an execute() {lm['decode_seq']} / "
                  f"{lm['exec']}; on the device an execute(): "
                  + ", ".join(f"{k} {_fmt_ms(v)}" for k, v in dev_m.items()))

    decode_multi("phase 4b multi-block: SLICE_CONFIG 4-block frame", [slice_frame], [small],
                 False)
    decode_multi("phase 4b multi-block: DEFAULT_CONFIG 4-block checksummed frame",
                 [default_frame], [small], True)
    decode_multi("phase 4b multi-block: BatchManager(level=3) frames", *bm3, True, timed=True)
    zspecs, zframes = zip(*((s_, f_) for s_, f_ in zip(torch_cases.multiblock_specs(),
                                                        torch_cases.multiblock_frames())
                            if s_["by"] == "zstd"))
    mixed = [batch_frame(contents, clens, btypes, 32), slice_frame, default_frame, *zframes,
             frames[0], frames[1]]
    mixed_in = [data[: 32 * N], small, small, *(z["payload"] for z in zspecs), items[0], items[1]]
    decode_multi("phase 4b multi-block: mixed batch", mixed, mixed_in, True, hold_kernels=True)
    del mixed, zframes

    # --- 4c. the optimal-parse path (level 19) --------------------------------------------
    cfg19 = _pipeline_config(CompressionConfig.from_level(19))
    gcfg4 = {**golden4["config"], "of_gate": tuple(golden4["config"]["of_gate"])}
    if dataclasses.asdict(cfg19) != gcfg4:
        _fail(f"phase 4c: the level-19 pipeline config differs from the golden's: {cfg19}")
    t0 = time.perf_counter()
    outs19, launches19, captured19 = drive(
        lambda: compress_blocks_staged_many([(blocks, lengths)], cfg19))
    print(f"phase 4c: level-19 path launches {launches19} "
          f"(first batch {time.perf_counter() - t0:.2f} s)")
    for k in ("roll", "concat", "greedy", "rep", "chain", "opt"):
        if launches19[k] <= 0:
            _fail(f"kernel {k} was not launched on the level-19 path")
    (_, kw19, _), = captured19["opt"].values()
    lit19 = kw19["lit_bits"].reshape(B, -1)[:, 0].cpu().numpy()
    bank19 = kw19["cost_bank"].reshape(B, -1, 128)[:, 0].cpu().numpy()
    gb4 = golden4["batch"]["blocks"]
    bad = [(b, int(lit19[b]), g["lit_price"]) for b, g in enumerate(gb4)
           if (int(lit19[b]), _sha(bank19[b].astype("<i4").tobytes()))
           != (g["lit_price"], g["bank_sha256"])]
    if bad:
        _fail(f"phase 4c: the pass-1 prices of {len(bad)} blocks differ from the JAX golden "
              f"(block, port lit_price, golden lit_price; first: {bad[:8]})")
    print(f"phase 4c: pass-1 prices (literal price, cost-bank row) of all {len(gb4)} blocks "
          f"== JAX golden")
    contents19, clens19, btypes19 = check_blocks(outs19[0], golden4, "phase 4c")
    decodes(batch_frame(contents19, clens19, btypes19), data, "the level-19 batch frame")
    gi4 = golden4["items"]
    base4 = make_corpus(sum(gi4["sizes"]))
    starts4 = np.cumsum([0] + gi4["sizes"][:-1])
    items4 = [base4[s : s + n] for s, n in zip(starts4, gi4["sizes"])]
    t0 = time.perf_counter()
    mgr19 = BatchManager(level=gi4["level"])
    res19 = mgr19.compress_batch(items4)
    t_mgr19 = time.perf_counter() - t0
    for k, (r, g) in enumerate(zip(res19, gi4["frames"])):
        if (len(r.output), _sha(r.output)) != (g["len"], g["sha256"]):
            _fail(f"BatchManager(level=19) frame {k} differs from the JAX golden")
        decodes(r.output, items4[k], f"level-19 BatchManager frame {k}")
    print(f"phase 4c: BatchManager(level=19).compress_batch: {len(items4)} frames == JAX golden "
          f"({sum(gi4['sizes'])} bytes in, ratio {mgr19.stats.ratio:.4f}, {t_mgr19:.2f} s)")
    decode_multi("phase 4c multi-block: BatchManager(level=19) frames",
                 [r.output for r in res19], items4, True, timed=True)
    hold_captured(captured19, "phase 4c")

    # --- 4d. the fused match route (K13) at levels 1, 3 and 5; K11 on the deposits ----
    # find_matches(..., use_pallas_match=True) against the plain route on the
    # inputs that parse_block hands find_matches at each level's pipeline
    # config, K13 and K12 on the inputs K13 received, then K11 on the
    # sequence deposits of the DEFAULT_CONFIG batch.
    t0 = time.perf_counter()
    posN = torch.arange(N, device=dev)
    fused_t = {}
    fused_launches = 0
    for level in (1, 3, 5):
        cfgL = _pipeline_config(CompressionConfig.from_level(level))
        _, _, capL = record([("find_matches", lz77, "find_matches")],
                            lambda: _parse_prep_stage(blocks, lengths, cfgL), False)
        (fm_args, fm_kw, _), = capL["find_matches"].values()
        if not lz77.fused_route_ok(N, fm_kw["hash_log"], fm_kw["mf_win_log"]):
            _fail(f"phase 4d: the fused route does not apply at level {level}: {fm_kw}")
        (f_ml, f_off), lf, capF = record(
            [("match", lz77, "match_windows")],
            lambda: lz77.find_matches(*fm_args, **fm_kw, use_pallas_match=True), True)
        if lf["match"] != 1 or any(v for k, v in lf.items() if k != "match"):
            _fail(f"phase 4d: level {level} fused find_matches launched {lf}")
        fused_launches += lf["match"]
        p_ml, p_off = lz77.find_matches(*fm_args, **fm_kw)
        live = posN < fm_args[1].to(torch.int64)[:, None] - (fm_kw["min_match"] - 1)
        bad = int((live & ((f_ml != p_ml) | (f_off != p_off))).sum())
        dead = int((~live & ((f_ml != 0) | (f_off != 0))).sum())
        if bad or dead:
            _fail(f"phase 4d: level {level}: the fused route differs from the plain route at "
                  f"{bad} live positions; {dead} dead positions are not 0")
        (margs, mkw, _), = capF["match"].values()
        key_m, words_m = margs[:2]
        hold("match", margs, f"level {level} captured", mkw)
        hold("sort", (key_m, *words_m.unbind(0)), f"level {level} K13's sort operands")
        fused_t[level] = {  # K13's inputs kept on the host until the kernel table
            "key": (tuple(a.cpu() if torch.is_tensor(a) else a for a in margs),),
            "fused_ms": _time_ms(lambda: lz77.find_matches(*fm_args, **fm_kw,
                                                           use_pallas_match=True), 5),
            "plain_route_ms": _time_ms(lambda: lz77.find_matches(*fm_args, **fm_kw), 3),
        }
        print(f"phase 4d: level {level} ({fm_kw}): fused route == plain route at all "
              f"{int(live.sum())} live positions, 0 at the {int((~live).sum())} dead ones; "
              f"launches {lf}")
        print(f"time [{card}]: level {level} find_matches fused (K13) "
              f"{fused_t[level]['fused_ms']:.3f} ms, plain route "
              f"{fused_t[level]['plain_route_ms']:.3f} ms")
        if level == 3:
            fm3 = (fm_args, fm_kw)
        del f_ml, f_off, p_ml, p_off, capL, capF, margs, key_m, words_m

    # The fused route at hash_log 14 and 64 KB windows (K13's tiled path) on
    # the inputs level 3 hands find_matches, against the sort route at the
    # same knobs; then two_band on the fused route, which returns the fused
    # (ml, off) as the JAX package's fused route does.
    kw_w = {**fm3[1], "hash_log": 14, "mf_win_log": 16}
    if not lz77.fused_route_ok(N, kw_w["hash_log"], kw_w["mf_win_log"]):
        _fail(f"phase 4d: the fused route does not apply at {kw_w}")
    (f_ml, f_off), lf, _ = record(
        [], lambda: lz77.find_matches(*fm3[0], **kw_w, use_pallas_match=True), True)
    if lf["match"] != 1 or any(v for k, v in lf.items() if k != "match"):
        _fail(f"phase 4d: the 64 KB-window fused find_matches launched {lf}")
    fused_launches += lf["match"]
    p_ml, p_off = lz77.find_matches(*fm3[0], **kw_w)
    live = posN < fm3[0][1].to(torch.int64)[:, None] - (kw_w["min_match"] - 1)
    bad = int((live & ((f_ml != p_ml) | (f_off != p_off))).sum())
    dead = int((~live & ((f_ml != 0) | (f_off != 0))).sum())
    if bad or dead:
        _fail(f"phase 4d: 64 KB windows: the fused route differs from the plain route at {bad} "
              f"live positions; {dead} dead positions are not 0")
    print(f"phase 4d: {kw_w}: fused route (K13, tiled sort) == plain route at all "
          f"{int(live.sum())} live positions; launches {lf}")
    print(f"time [{card}]: 64 KB-window find_matches fused (K13) "
          f"{_time_ms(lambda: lz77.find_matches(*fm3[0], **kw_w, use_pallas_match=True), 3):.3f}"
          f" ms, plain route {_time_ms(lambda: lz77.find_matches(*fm3[0], **kw_w), 3):.3f} ms")
    del f_ml, f_off, p_ml, p_off
    tb = lz77.find_matches(*fm3[0], **{**fm3[1], "two_band": True}, use_pallas_match=True)
    one = lz77.find_matches(*fm3[0], **fm3[1], use_pallas_match=True)
    if len(tb) != 2 or not all(torch.equal(a, b) for a, b in zip(tb, one)):
        _fail("phase 4d: find_matches(two_band=True, use_pallas_match=True) is not the fused "
              "route's (ml, off)")
    print("phase 4d: two_band with use_pallas_match returns the fused route's (ml, off)")
    del tb, one

    # K11 on the sequence deposits of the DEFAULT_CONFIG batch (the calls that
    # take the deposit tree): offsets the exclusive cumsum of the lengths, M
    # padded to a multiple of 128 with zero-length fields at the last offset.
    _, _, cap_dep = record([("deposit_in", fse, "deposit_bits")],
                           lambda: compress_blocks_staged_many([(blocks, lengths)], cfg), False)
    dep_runs = {}
    for key, (dargs, _, n_calls) in cap_dep["deposit_in"].items():
        vals, lens, nwd = dargs
        if vals.shape[1] < 4096:
            continue
        tree_words, total = bitpack.deposit_bits_tree(vals, lens, nwd)
        if bool((total > 32 * nwd).any()):
            _fail("phase 4d: a captured deposit overflows its words")
        lens64 = lens.to(torch.int64)
        offs = torch.cumsum(lens64, 1) - lens64
        pad = -vals.shape[1] % deposit.CHUNK_F
        kargs = (torch.nn.functional.pad(vals.to(torch.int64), (0, pad)),
                 torch.nn.functional.pad(lens64, (0, pad)).to(torch.int32),
                 torch.cat([offs, offs[:, -1:].expand(-1, pad)], 1).to(torch.int32), nwd)
        torch.cuda.synchronize()
        _kernels.reset_launches()
        got = deposit.deposit_bits_pallas(*kargs)
        torch.cuda.synchronize()
        if _kernels.launches["deposit"] != 1:
            _fail(f"phase 4d: K11 launched {_kernels.launches['deposit']} times for one call")
        if not torch.equal(got[:, :nwd], tree_words):
            _fail(f"phase 4d: K11 differs from the deposit tree on {tuple(vals.shape)}")
        hold("deposit", kargs, f"DEFAULT_CONFIG deposit {tuple(vals.shape)}")
        dep_runs[(key_of(kargs), ())] = [tuple(a.cpu() if torch.is_tensor(a) else a
                                               for a in kargs), {}, n_calls]
        tree_ms = _time_ms(lambda: bitpack.deposit_bits_tree(vals, lens, nwd), 3)
        fused_t.setdefault("tree_ms", []).append(tree_ms)
        print(f"phase 4d: K11 == the deposit tree's {nwd} words on the DEFAULT_CONFIG batch's "
              f"{tuple(vals.shape)} deposit (x{n_calls} a batch); tree {tree_ms:.3f} ms")
    if not dep_runs:
        _fail("phase 4d: no deposit of the DEFAULT_CONFIG batch took the tree route")
    del cap_dep, got, kargs, tree_words, vals, lens, offs, lens64
    print(f"phase 4d: done ({time.perf_counter() - t0:.1f} s)")

    # --- 4e. the public surface: Manager, decompress_batch_tpu, BatchManager, host codec --
    # The bench corpus as one 16 MiB item through Manager(level=3) (past
    # cpu_threshold: the card), against tests/golden/torch_slice5.json; the
    # prepared plan refuses its 16 MiB window; decompress_batch_tpu decodes
    # it on the card (Manager on the TPU_BATCH path): 128 rounds of K7
    # serially and K8 against a history that grows to 16 MiB, timed, each
    # kernel against its plain version on the inputs it received; then
    # BatchManager.decompress_batch(use_tpu=True) over phase 4's 16 frames,
    # libzstd's multi-block frames and the 16 MiB frame; the host codec
    # (tpu_zstd_torch.compress of 256 KB, decoded on the host and on the
    # card) and the streaming decoder on the 4-block frames in 4 KB chunks.
    t4e = time.perf_counter()
    if golden5["size"] != len(data) or golden5["config"]["level"] != 3:
        _fail("phase 4e: torch_slice5.json is not the level-3 frame of the bench corpus")
    m3 = Manager(level=3)
    t0 = time.perf_counter()
    frame16, pub_c_launches, _ = record([], lambda: m3.compress(data), True)
    t_c16 = time.perf_counter() - t0
    if (len(frame16), _sha(frame16)) != (golden5["len"], golden5["sha256"]):
        _fail(f"phase 4e: Manager(level=3).compress of the 16 MiB corpus differs from the JAX "
              f"golden ({len(frame16)} bytes)")
    for k in ("roll", "concat", "greedy", "rep", "chain"):
        if pub_c_launches[k] <= 0:
            _fail(f"phase 4e: kernel {k} was not launched by Manager(level=3).compress")
    decodes(frame16, data, "the 16 MiB Manager frame")
    hdr16 = parse_frame_header(frame16)
    if hdr16.window_size != golden5["window_size"] or hdr16.window_size <= decompress.PLAN_WINDOW_CAP:
        _fail(f"phase 4e: the 16 MiB frame declares a window of {hdr16.window_size}")
    print(f"phase 4e: Manager(level=3).compress(16 MiB) on the card == JAX golden "
          f"({len(frame16)} bytes, window {hdr16.window_size}; launches {pub_c_launches}; "
          f"{t_c16:.2f} s)")
    try:
        decompress.prepare_decompress_batch([frame16])
    except ValueError as e:
        print(f"phase 4e: prepare_decompress_batch refuses the frame: {e}")
    else:
        _fail("phase 4e: prepare_decompress_batch accepted a 16 MiB window")

    mdec = Manager(execution_path=ExecutionPath.TPU_BATCH)
    t0 = time.perf_counter()
    out16, pub_launches, pub_captured = record(dec_sites, lambda: mdec.decompress(frame16), True)
    t_d16 = time.perf_counter() - t0
    if out16 != data:
        _fail("phase 4e: decompress_batch_tpu returned other bytes than the 16 MiB input")
    if pub_launches["decode_seq"] <= 0 or pub_launches["exec"] <= 0 or pub_launches["decode_huf"]:
        _fail(f"phase 4e: the long-window decode launched {pub_launches}")
    t0 = time.perf_counter()
    parsed16 = decompress.parse_batch([frame16])
    t_p16 = time.perf_counter() - t0
    nr16 = len(parsed16.rounds)
    nseq16 = sum(p.nbseq for r in parsed16.rounds for p in r.values()
                 if isinstance(p, decompress._BlockPlan))
    best16 = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        decompress.decode_parsed(parsed16)
        best16 = min(best16, time.perf_counter() - t0)
    dev16 = _device_ms_by_name(lambda: decompress.decode_parsed(parsed16), {
        "K7": "decode_sequences_kernel", "K8": "exec_sequences_kernel", "every kernel": ""})
    k7_round = None if dev16["K7"] is None else dev16["K7"] / nr16
    print(f"time [{card}]: 16 MiB frame, Manager(execution_path=TPU_BATCH).decompress "
          f"{t_d16:.3f} s = {len(data) / t_d16 / 1e9:.4f} GB/s, of which the host parse "
          f"(parse_batch, native Huffman literals) {t_p16:.3f} s; the device half "
          f"(decode_parsed: {nr16} "
          f"rounds staged, K7 serially, K8, history carried to {hdr16.window_size}, drained "
          f"{decompress.DRAIN_BEHIND} rounds behind) {best16:.3f} s = "
          f"{len(data) / best16 / 1e9:.4f} GB/s (best of 2); K7 / K8 launches "
          f"{pub_launches['decode_seq']} / {pub_launches['exec']}; on the device a decode: "
          + ", ".join(f"{k} {_fmt_ms(v)}" for k, v in dev16.items())
          + f"; K7 serial {_fmt_ms(k7_round)} a round, "
          + ("not measured" if dev16["K7"] is None else
             f"{dev16['K7'] * 1e6 / max(nseq16, 1):.1f} ns a sequence")
          + f" ({nseq16} sequences)")
    hold_captured(pub_captured, "phase 4e long-window decode")
    del pub_captured, parsed16

    gi_z = [(s_, f_) for s_, f_ in zip(torch_cases.multiblock_specs(),
                                       torch_cases.multiblock_frames()) if s_["by"] == "zstd"]
    b_frames = [*bm3[0], *(f_ for _, f_ in gi_z), frame16]
    b_items = [*bm3[1], *(s_["payload"] for s_, _ in gi_z), data]
    bmgr = BatchManager(level=3)
    t0 = time.perf_counter()
    res_b, b_launches, _ = record([], lambda: bmgr.decompress_batch(b_frames, use_tpu=True), True)
    t_b = time.perf_counter() - t0
    bad = [k for k, (r, d) in enumerate(zip(res_b, b_items))
           if r.status != Status.SUCCESS or r.output != d]
    if bad or len(res_b) != len(b_items):
        _fail(f"phase 4e: decompress_batch(use_tpu=True) returned {len(bad)} wrong items "
              f"(first {bad[:8]})")
    if b_launches["decode_seq"] <= 0 or b_launches["exec"] <= 0:
        _fail(f"phase 4e: decompress_batch(use_tpu=True) launched {b_launches}: it fell "
              f"through to the host")
    print(f"phase 4e: BatchManager(level=3).decompress_batch(use_tpu=True) over {len(b_frames)} "
          f"frames ({len(bm3[0])} BatchManager, {len(gi_z)} libzstd, the 16 MiB one): every "
          f"status SUCCESS, every output == its input; K7 / K8 launches "
          f"{b_launches['decode_seq']} / {b_launches['exec']}; {t_b:.2f} s")

    import tpu_zstd_torch

    small256 = make_corpus(256 * 1024)
    t0 = time.perf_counter()
    hframe, h_launches, _ = record([], lambda: tpu_zstd_torch.compress(small256, checksum=True),
                                   True)
    t_hc = time.perf_counter() - t0
    if any(h_launches.values()):
        _fail(f"phase 4e: tpu_zstd_torch.compress of 256 KB launched {h_launches}")
    decodes(hframe, small256, "the host codec's 256 KB frame")
    t0 = time.perf_counter()
    back = tpu_zstd_torch.decompress(hframe)
    t_hd = time.perf_counter() - t0
    on_card, hd_launches, _ = record([], lambda: decompress.decompress_batch_tpu([hframe]), True)
    if back != small256 or on_card != [small256]:
        _fail("phase 4e: the host codec's frame does not round-trip")
    if hd_launches["decode_seq"] <= 0 or hd_launches["exec"] <= 0:
        _fail(f"phase 4e: decompress_batch_tpu of the host frame launched {hd_launches}")
    print(f"phase 4e: tpu_zstd_torch.compress(256 KB, checksum=True) took the host route (no "
          f"launch): {len(hframe)} bytes in {t_hc:.2f} s ({len(small256) / t_hc / 1e6:.3f} MB/s); "
          f"tpu_zstd_torch.decompress on the host {t_hd:.2f} s "
          f"({len(small256) / t_hd / 1e6:.3f} MB/s); decompress_batch_tpu on the card (checksum "
          f"verified) == the input")
    sd = StreamingDecompressor()
    stream = slice_frame + default_frame
    t0 = time.perf_counter()
    got = b"".join(sd.decompress_chunk(stream[p : p + 4096])
                   for p in range(0, len(stream), 4096)) + sd.flush()
    t_sd = time.perf_counter() - t0
    if got != small + small or sd.frames_completed != 2:
        _fail("phase 4e: StreamingDecompressor did not return the 4-block frames' inputs")
    print(f"phase 4e: StreamingDecompressor fed phase 3's and phase 4's 4-block frames in 4 KB "
          f"chunks == their inputs ({len(got)} bytes, checksum verified incrementally, "
          f"{t_sd:.2f} s = {len(got) / t_sd / 1e6:.3f} MB/s on the host)")
    print(f"phase 4e: done ({time.perf_counter() - t4e:.1f} s)")

    # --- 4f. cross-block windows: enable_ldm items, the streaming compressor, level 19 with
    # a history, dictionaries, a 1 MiB history ---------------------------------------------
    # The inputs of tests/golden/torch_slice6.json (tests/torch_cases.py
    # slice6_inputs, from the bench corpus), each path driven once through its
    # entry point with the counts set to 0 just before and read just after,
    # its frames against the golden, decoded on the card (the dictionary
    # frames on the host decoder), the kernels against their plain versions
    # on the inputs each path gave them, the peak device memory of each.
    t4f = time.perf_counter()
    inp6 = torch_cases.slice6_inputs(data, N)
    if golden6["corpus"] != f"make_corpus({B} * {N})" or golden6["item"] != len(inp6["items"][0]):
        _fail("phase 4f: torch_slice6.json is not made from the bench corpus")
    win_launches: dict = {}
    win_captured: dict = {}

    def peak_base() -> int:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        return torch.cuda.memory_allocated()

    def peak_gib(base: int) -> str:
        return f"{(torch.cuda.max_memory_allocated() - base) / 2**30:.3f} GiB"

    def same_frames(frames_x, gold, label):
        bad = [k for k, (f_, g_) in enumerate(zip(frames_x, gold))
               if (len(f_), _sha(f_)) != (g_["len"], g_["sha256"])]
        if bad or len(frames_x) != len(gold):
            _fail(f"{label}: {len(bad)} of {len(gold)} frames differ from the JAX golden "
                  f"(first {bad[:8]})")

    def must_launch(launches_x, names, label):
        for k in names:
            if launches_x.get(k, 0) <= 0:
                _fail(f"{label}: kernel {k} was not launched ({launches_x})")

    def best_of(fn, reps=2):
        best = float("inf")
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    # 1. compress_items with enable_ldm: 16 items of 1 MiB, 128 rows of a 64
    # KB window and a 128 KB block (the windowed search on the payload, the
    # long-range pass over the row); decoded by the prepared plan.
    cfg_ldm = dataclasses.replace(CompressionConfig.from_level(3), enable_ldm=True)
    base = peak_base()
    frames_ldm, win_launches["ldm_items"], win_captured["ldm_items"] = drive(
        lambda: compress_items(inp6["items"], cfg_ldm))
    peak_ldm = peak_gib(base)
    same_frames(frames_ldm, golden6["ldm_items"]["frames"], "phase 4f enable_ldm items")
    must_launch(win_launches["ldm_items"], ("roll", "concat", "greedy", "rep", "chain"),
                "phase 4f enable_ldm items")
    for f_, d_ in zip(frames_ldm, inp6["items"]):
        decodes(f_, d_, "an enable_ldm item frame")
    t_ldm = best_of(lambda: compress_items(inp6["items"], cfg_ldm))
    nb_ldm = sum(map(len, frames_ldm))
    print(f"phase 4f: compress_items(16 x 1 MiB, level 3, enable_ldm) == JAX golden "
          f"({nb_ldm} bytes, ratio {len(data) / nb_ldm:.4f}; launches "
          f"{win_launches['ldm_items']}; peak device memory {peak_ldm})")
    print(f"time [{card}]: enable_ldm items compress_items {t_ldm * 1e3:.3f} ms = "
          f"{len(data) / t_ldm / 1e9:.4f} GB/s (best of 2, the frames in Python included)")
    hold_captured(win_captured["ldm_items"], "phase 4f enable_ldm items")
    decode_multi("phase 4f enable_ldm items", frames_ldm, inp6["items"], False,
                 hold_kernels=True, timed=True)

    # 2. StreamingManager(level=3): the corpus in 16 chunks of 1 MiB, each
    # block with a 64 KB history (the search over the whole row of 192 KB);
    # decoded by decompress_batch_tpu on the card (128 rounds) and by the
    # manager's decompress half on the host.
    def stream_run(cfg_s, chunks):
        sm_ = StreamingManager(config=cfg_s)
        return b"".join(sm_.compress_chunk(c) for c in chunks) + sm_.flush()

    cfg_s3 = CompressionConfig.from_level(3)
    base = peak_base()
    stream6, win_launches["stream"], win_captured["stream"] = drive(
        lambda: stream_run(cfg_s3, inp6["items"]))
    peak_st = peak_gib(base)
    if (len(stream6), _sha(stream6)) != (golden6["stream"]["len"], golden6["stream"]["sha256"]):
        _fail(f"phase 4f: the StreamingManager stream differs from the JAX golden "
              f"({len(stream6)} bytes)")
    must_launch(win_launches["stream"], ("roll", "greedy", "rep", "chain"), "phase 4f stream")
    decodes(stream6, data, "the level-3 stream")
    t_st = best_of(lambda: stream_run(cfg_s3, inp6["items"]))
    print(f"phase 4f: StreamingManager(level=3) over 16 chunks of 1 MiB == JAX golden "
          f"({len(stream6)} bytes, ratio {len(data) / len(stream6):.4f}; launches "
          f"{win_launches['stream']}; peak device memory {peak_st})")
    hold_captured(win_captured["stream"], "phase 4f stream")
    base = peak_base()
    out_st, st_dec_launches, st_dec_captured = record(
        dec_sites, lambda: decompress.decompress_batch_tpu([stream6]), True)
    peak_std = peak_gib(base)
    if out_st != [data]:
        _fail("phase 4f: decompress_batch_tpu returned other bytes than the stream's input")
    must_launch(st_dec_launches, ("decode_seq", "exec"), "phase 4f stream decode")
    # K7's plain version walks every round's blocks serially (~8 s an
    # input): hold each kernel on the largest input this decode gave it;
    # phase 4e holds both on every input of a 128-round decode.
    hold_captured({k: dict([max(v.items(), key=lambda kv: sum(
        a.numel() * a.element_size() for a in kv[1][0] if torch.is_tensor(a)))]) if v else {}
        for k, v in st_dec_captured.items()}, "phase 4f stream decode")
    del st_dec_captured
    t0 = time.perf_counter()
    parsed_st = decompress.parse_batch([stream6])
    t_pst = time.perf_counter() - t0
    t_dst = best_of(lambda: decompress.decode_parsed(parsed_st))
    dev_st = _device_ms_by_name(lambda: decompress.decode_parsed(parsed_st), {
        "K7": "decode_sequences_kernel", "K8": "exec_sequences_kernel", "every kernel": ""})
    del parsed_st
    print(f"time [{card}]: StreamingManager(level=3) compress {t_st:.3f} s = "
          f"{len(data) / t_st / 1e9:.4f} GB/s (best of 2, 16 compress_chunk calls and flush); "
          f"decompress_batch_tpu: the host parse {t_pst:.3f} s, the device half "
          f"{t_dst:.3f} s = {len(data) / t_dst / 1e9:.4f} GB/s (best of 2; K7 / K8 launches "
          f"{st_dec_launches['decode_seq']} / {st_dec_launches['exec']}; peak device memory "
          f"{peak_std}); on the device a decode: "
          + ", ".join(f"{k} {_fmt_ms(v)}" for k, v in dev_st.items()))
    sm_dec = StreamingManager(level=3)
    t0 = time.perf_counter()
    back = b"".join(sm_dec.decompress_chunk(stream6[p : p + (1 << 20)])
                    for p in range(0, len(stream6), 1 << 20)) + sm_dec.decompress_flush()
    t_sdec = time.perf_counter() - t0
    if back != data:
        _fail("phase 4f: StreamingManager.decompress_chunk did not return the stream's input")
    print(f"phase 4f: StreamingManager.decompress_chunk (its StreamingDecompressor, on the host) "
          f"fed the stream in 1 MiB chunks == the input ({t_sdec:.2f} s = "
          f"{len(data) / t_sdec / 1e6:.3f} MB/s)")

    # 3. compress_items at level 19 with a 64 KB history: 8 blocks, K10 on
    # rows of 192 segments; decoded on the card as one frame of the history
    # (a Raw block) and the item's blocks.
    cfg19h = CompressionConfig.from_level(19)
    base = peak_base()
    (f19h,), win_launches["history19"], win_captured["history19"] = drive(
        lambda: compress_items([inp6["item19"]], cfg19h, history=[inp6["history"]]))
    peak_19h = peak_gib(base)
    g19 = golden6["history19"]
    if (len(f19h), _sha(f19h)) != (g19["len"], g19["sha256"]):
        _fail(f"phase 4f: the level-19 history frame differs from the JAX golden ({len(f19h)} "
              f"bytes)")
    must_launch(win_launches["history19"], ("roll", "greedy", "rep", "chain", "opt"),
                "phase 4f level-19 history")
    opt_rows = sorted(k[0][0][0] for k in win_captured["history19"]["opt"])
    if opt_rows != [(8 * (N + len(inp6["history"])) // 1024, 1024)]:
        _fail(f"phase 4f: K10 ran on {opt_rows}, not 8 rows of 192 segments")
    t_19h = best_of(lambda: compress_items([inp6["item19"]], cfg19h,
                                           history=[inp6["history"]]))
    hold_captured(win_captured["history19"], "phase 4f level-19 history")
    joined = (write_frame_header(len(inp6["history"]) + len(inp6["item19"]), window_log=20)
              + ((len(inp6["history"]) << 3) | (BLOCK_RAW << 1)).to_bytes(3, "little")
              + inp6["history"] + _strip_frame_to_blocks(f19h, clear_last=False))
    out19h, l19d, _ = record([], lambda: decompress.decompress_batch_tpu([joined]), True)
    if out19h != [inp6["history"] + inp6["item19"]]:
        _fail("phase 4f: the level-19 history frame does not decode on the card")
    print(f"phase 4f: compress_items(1 MiB, level 19, 64 KB history) == JAX golden "
          f"({len(f19h)} bytes; K10 on {opt_rows[0]}; launches {win_launches['history19']}; "
          f"peak device memory {peak_19h}); decoded on the card behind its history (K7 / K8 "
          f"launches {l19d['decode_seq']} / {l19d['exec']})")
    print(f"time [{card}]: level-19 history compress_items {t_19h * 1e3:.3f} ms = "
          f"{len(inp6['item19']) / t_19h / 1e9:.4f} GB/s (best of 2)")

    # 4. Dictionaries: train_dictionary (64 KB) on 1024 records, then
    # compress_with_dict of 256 others on the card (256 rows of a 64 KB
    # dictionary tail and a 128 KB block, searched over the whole row);
    # decompress_with_dict on the host decoder.
    t0 = time.perf_counter()
    dct = dictionary.train_dictionary(inp6["train"], dict_size=64 * 1024)
    t_train = time.perf_counter() - t0
    gd = golden6["dictionary"]
    if (len(dct.content), _sha(dct.content), dct.dict_id) != (gd["content_len"],
                                                             gd["content_sha256"], gd["dict_id"]):
        _fail("phase 4f: train_dictionary differs from the JAX golden")
    base = peak_base()
    frames_d, win_launches["dict"], win_captured["dict"] = drive(
        lambda: dictionary.compress_with_dict(inp6["records"], dct))
    peak_d = peak_gib(base)
    same_frames(frames_d, gd["frames"], "phase 4f dictionary frames")
    must_launch(win_launches["dict"], ("roll", "greedy", "rep", "chain"), "phase 4f dictionary")
    t_d = best_of(lambda: dictionary.compress_with_dict(inp6["records"], dct))
    hold_captured(win_captured["dict"], "phase 4f dictionary")
    t0 = time.perf_counter()
    bad = [k for k, (f_, r_) in enumerate(zip(frames_d, inp6["records"]))
           if dictionary.decompress_with_dict(f_, dct) != r_]
    t_dd = time.perf_counter() - t0
    if bad:
        _fail(f"phase 4f: decompress_with_dict returned other bytes for {len(bad)} records")
    nrec = sum(map(len, inp6["records"]))
    print(f"phase 4f: train_dictionary(1024 records, 64 KB) == JAX golden ({t_train:.2f} s on "
          f"the host); compress_with_dict of {len(frames_d)} records ({nrec} bytes) == JAX "
          f"golden ({sum(map(len, frames_d))} bytes; launches {win_launches['dict']}; peak "
          f"device memory {peak_d}); decompress_with_dict == every record ({t_dd:.2f} s on "
          f"the host)")
    print(f"time [{card}]: compress_with_dict of 256 records {t_d * 1e3:.3f} ms = "
          f"{nrec / t_d / 1e6:.3f} MB/s of records (best of 2)")

    # 5. A 1 MiB history (window_log 20): rows of 1 MiB + 128 KB searched
    # whole; the second chunk repeats the history's first 64 KB at offset
    # 2^20 and again past it (offsets beyond the 20-bit field, which the
    # port leaves unmatched); decoded on the card.
    rng6 = np.random.default_rng(620)
    chunks20 = [data[: 1 << 20], data[:65536] + rng6.bytes(65536) + data[:65536]]
    cfg20 = dataclasses.replace(CompressionConfig.from_level(3), window_log=20)
    base = peak_base()
    stream20, win_launches["history_1mib"], _ = drive(lambda: stream_run(cfg20, chunks20))
    peak_20 = peak_gib(base)
    t_20 = best_of(lambda: stream_run(cfg20, chunks20))
    out20, l20d, _ = record([], lambda: decompress.decompress_batch_tpu([stream20]), True)
    if out20 != [b"".join(chunks20)]:
        _fail("phase 4f: the window_log-20 stream does not decode to its input on the card")
    decodes(stream20, b"".join(chunks20), "the window_log-20 stream")
    print(f"phase 4f: StreamingManager(window_log=20) over 1 MiB + 192 KB: {len(stream20)} "
          f"bytes, decoded on the card == the input (K7 / K8 launches {l20d['decode_seq']} / "
          f"{l20d['exec']}); launches {win_launches['history_1mib']}; peak device memory "
          f"{peak_20} (8 rows of {(1 << 20) + N} positions)")
    print(f"time [{card}]: StreamingManager(window_log=20), 2 chunks: {t_20 * 1e3:.3f} ms "
          f"(best of 2)")
    print(f"phase 4f: done ({time.perf_counter() - t4f:.1f} s)")

    # --- 4g. the last modules: the native host runtime, HybridEngine, nvCOMP, the OOM
    # ladder, adaptive levels, the profiler, sharding over torch.distributed ---------
    paths4g = phase_4g(types.SimpleNamespace(
        card=card, dev=dev, data=data, golden2=golden2, golden5=golden5, golden7=golden7,
        torch_cases=torch_cases, frame16=frame16, bm3=bm3, accel=(frames, items),
        record=record, must_launch=must_launch, peak_base=peak_base, peak_gib=peak_gib,
        same_frames=same_frames, best_of=best_of, decodes=decodes))

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
    reps19 = REPS_L19 if time.perf_counter() - t_start < 600 else 2
    dt19, peak19 = batch_ms(cfg19, reps19)
    print(f"time [{card}]: level-19 batch 128x128KB {dt19 * 1e3:.3f} ms = "
          f"{B * N / dt19 / 1e9:.4f} GB/s (pipelined over {reps19} batches, best of 2); "
          f"peak device memory {peak19 / 2**30:.3f} GiB; "
          f"block-body ratio {B * N / int(clens19.sum()):.4f}")

    plan = decompress.prepare_decompress_batch(frames, max_block=N)
    plan.execute()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    ddt = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        pending = [plan.execute() for _ in range(3)]
        for _, ln in pending:
            ln.cpu()
        ddt = min(ddt, (time.perf_counter() - t0) / 3)
    dpeak = torch.cuda.max_memory_allocated()
    dec_ms = _time_ms(lambda: plan.execute(), 5)
    print(f"time [{card}]: decode 128x128KB accel frames, prepare_decompress_batch(...).execute() "
          f"{ddt * 1e3:.3f} ms = {B * N / ddt / 1e9:.4f} GB/s (3 executes with lengths fetched, "
          f"best of 2); by CUDA events {dec_ms:.3f} ms; peak device memory {dpeak / 2**30:.3f} "
          f"GiB ({(dpeak - base_mem) / 2**20:.1f} MiB above the plan's resident inputs)")

    def nbytes(t):
        return t.numel() * t.element_size()

    def stream_bytes(total_bits):
        return int(((total_bits.to(torch.int64) + 7) // 8).sum())

    def bound(name, args, kw, out):
        """Least time for the work and what bounds it: bytes read once +
        written once over the card's memory rate (the decode kernels: the live
        stream bytes, symbols, sequences and outputs of this input); K10 the
        larger of that and its int32 operations for this input's lengths
        over the card's int32 rate."""
        if name == "opt":
            return opt_bound_ms(*args, kw["lit_bits"], kw["cost_bank"])
        if name == "sort":
            return sort_bound_ms(args), "bytes"
        if name == "match":
            return match_bound_ms(*args)
        if name == "concat":  # per operand its live source elements, offsets, counts, output
            nb = 0
            for op, o in zip(args[0], out):
                c = op.counts.to(torch.int64)
                start = torch.clamp(torch.cumsum(c, 1) - c, max=op.out_len)
                moved = int(torch.minimum(c, op.out_len - start).sum())
                nb += (moved * op.src.element_size() + nbytes(op.counts) + nbytes(o)
                       + (0 if op.src_off is None else nbytes(op.src_off)))
        elif name == "chain":  # int32 operands; the symbols up to the live end
            rsym_a, nseq_a = args[6], args[7].to(torch.int64)
            live = torch.where(args[5].to(torch.bool), 0, torch.clamp(nseq_a - 1, 0,
                                                                      rsym_a.shape[1]))
            nb = (sum(a.numel() for a in args[:6]) + int(live.sum()) + rsym_a.shape[0]
                  + nseq_a.numel() + sum(o.numel() for o in out)) * 4
        elif name == "decode_huf":  # streams, tables, records in; symbols out
            _, tbits, _, tl, nsym, _, _, ck = args
            nb = (stream_bytes(tbits) + 4 * int((1 << tl.to(torch.int64)).sum())
                  + nbytes(ck) + 8 * tbits.numel() + int(nsym.sum()))
        elif name == "decode_seq":  # streams, tables, records in; ll/ml/off out
            _, tbits, tables, nseq_a, _, ckb, cks, ckr = args[:8]
            nb = (stream_bytes(tbits) + 3 * 512 * 4 * tbits.numel() + nbytes(ckb) + nbytes(cks)
                  + nbytes(ckr) + 12 * int(nseq_a.sum()))
        elif name == "exec":  # literals and sequences in; the output bytes out
            nlit_a, nseq_a = args[1], args[5]
            nb = int(nlit_a.sum()) + 12 * int(nseq_a.sum()) + int(out[1].sum())
        else:
            nb = sum(nbytes(a) for a in args if torch.is_tensor(a)) + nbytes(out)
        return nb / HBM_BYTES_PER_S * 1e3, "bytes"

    def shape_of(name, key):
        if name == "concat":  # per operand: source shape -> out_len and dtype
            return " + ".join(f"{k[0][0]} -> {k[3]} {str(k[4]).split('.')[-1]}"
                              for k in key[0][0])
        if name == "chain":
            return f"rows x msb {key[0][6][0]}"
        if name == "decode_seq":
            return f"{key[0][0][0][0]} blocks x {key[0][9]} chunks of {key[0][8]}"
        if name == "decode_huf":
            return f"{key[0][0][0][0]} streams x {key[0][6]} chunks of {key[0][5]}"
        if name == "exec":
            return f"{key[0][2][0]} ({'lit_src' if key[1] else 'lits'})"
        if name == "opt":
            return f"{key[0][0][0]} mm {key[0][1]} cap {key[0][2]}"
        if name == "sort":
            return f"{key[0][0][0]} x {len(key[0])} operands"
        if name == "match":
            return f"{key[0][0][0]} depth {key[0][2]} words {key[0][1][0][0]}"
        if name == "deposit":
            return f"{key[0][0][0]} -> {key[0][3]} words"
        return f"{key[0][0][0]} {key[0][0][1]}"

    # Every captured shape is timed; `ms_per_batch` sums the kernel's time over
    # its launches in one batch (the decode kernels: one execute() of the
    # bench frames). The JSON row reports the representative shape: K1's byte
    # roll at the block width, else the largest input.
    all_captured = {k: captured[k] for k in ("roll", "concat", "greedy", "rep", "chain")}
    all_captured.update({k: dec_captured[k] for k in ("decode_huf", "decode_seq", "exec")})
    all_captured["opt"] = captured19["opt"]
    # K13 and K12 at the three levels' shapes; the row (and the per-batch
    # time) is level 3's, DEFAULT_CONFIG's. K11 on the DEFAULT_CONFIG deposits.
    all_captured["match"] = {}
    all_captured["sort"] = {}
    for level in (1, 3, 5):
        margs, = fused_t[level]["key"]
        sargs = (margs[0], *margs[1].unbind(0))
        all_captured["match"][(key_of(margs), ())] = [margs, {}, int(level == 3)]
        all_captured["sort"][(key_of(sargs), ())] = [sargs, {}, int(level == 3)]
        if level == 3:
            rep_key = {"match": (key_of(margs), ()), "sort": (key_of(sargs), ())}
    all_captured["deposit"] = dep_runs
    # K13's launches on the fused route (one a level); K12 and K11 launch on no
    # main path: K12's network runs inside each K13 launch, and the main path
    # keeps the deposit tree, as the JAX package does.
    all_launches = {**launches, **{k: dec_launches[k] for k in ("decode_huf", "decode_seq",
                                                                 "exec")},
                    "opt": launches19["opt"], "match": fused_launches, "sort": 0,
                    "deposit": 0}
    extra = {
        **{k: {"launches_long_window_decode": pub_launches[k],
               "launches_batch_decompress": b_launches[k],
               "long_window_decode_device_ms": dev16["K7" if k == "decode_seq" else "K8"]}
           for k in ("decode_seq", "exec")},
        "match": {"level": 3, "launches_per_call": 1,
                  "plain_route_ms": fused_t[3]["plain_route_ms"],
                  "fused_route_ms": fused_t[3]["fused_ms"],
                  "note": "library none; plain_route_ms is find_matches' sort route"},
        "sort": {"level": 3, "network_runs_in": "match",
                 "note": "its bitonic network runs inside each match launch"},
        "deposit": {"launches_checked": len(dep_runs), "tree_ms": sum(fused_t["tree_ms"]),
                    "note": "library none; checked on the DEFAULT_CONFIG batch's deposits, "
                            "which the main path packs with the deposit tree"},
    }

    plain_iters = {"rep": 1, "decode_seq": 1, "exec": 1, "opt": 1, "match": 1}
    rows_out = []
    for name, (kern, plain, source, replaces) in K.items():
        per_batch = bound_batch = dev_batch = 0.0
        row = None
        counters = {}
        for key, (args, kw, n_calls) in sorted(
                all_captured[name].items(),
                key=lambda kv: -sum(nbytes(a) for a in kv[1][0] if torch.is_tensor(a))):
            if name == "chain":  # timed with int32 operands; raw_args as the path passes them
                raw_args = args
                args = tuple(a.to(torch.int32).contiguous() for a in args)
            if name in ("deposit", "sort", "match"):  # kept on the host since phase 4d
                args = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
            out = kern(*args, **kw)
            ms = _time_ms(lambda: kern(*args, **kw), 20)
            plain_ms = _time_ms(lambda: plain(*args, **kw), plain_iters.get(name, 3))
            b_ms, b_by = bound(name, args, kw, out)
            per_batch += n_calls * ms
            bound_batch += n_calls * b_ms
            shape = shape_of(name, key)
            dev_ms = None
            if name in KERNEL_SYMBOL:
                dev_ms = _device_ms(lambda: kern(*args, **kw), 20, KERNEL_SYMBOL[name])
                dev_batch = None if dev_ms is None or dev_batch is None else (
                    dev_batch + n_calls * dev_ms)
            q_ms = _queued_ms(lambda: kern(*args, **kw), 20) if name in ("greedy", "chain") else None
            print(f"kernel [{card}] {name} {shape} x{n_calls}/batch: {ms:.4f} ms"
                  + (f" (on the device {_fmt_ms(dev_ms)})" if name in KERNEL_SYMBOL else "")
                  + (f" (queued {q_ms:.4f} ms)" if q_ms is not None else "")
                  + f", bound {b_ms:.4f} ms, plain {plain_ms:.3f} ms")
            if name == "chain":  # as the path calls it: int64 operands, bool rle
                print(f"kernel [{card}] {name} {shape} as the path calls it "
                      f"({raw_args[6].dtype} symbols): "
                      f"{_time_ms(lambda: kern(*raw_args), 20):.4f} ms, queued "
                      f"{_queued_ms(lambda: kern(*raw_args), 20):.4f} ms")
            if name in ("rep", "exec", "decode_huf", "decode_seq", "chain"):  # counters
                st = kernel_stats(name, args, kw).to(torch.int64)
                if name == "decode_huf":
                    got = huf_counters(args, st)
                elif name == "decode_seq":
                    got = {k2.replace("longest_chain", "longest_chain_max"): v
                           for k2, v in seq_counters(st).items()}
                elif name == "chain":
                    got = chain_counters(st)
                    got["passes_sum"] = int(st[:, 0].sum())
                elif name == "rep":
                    got = {"chunks": int(st[:, 0].sum()), "chunks_unmet": int(st[:, 1].sum()),
                           "fixup_rounds_max": int(st[:, 2].max()),
                           "rows_rewalked": int(st[:, 3].sum()),
                           "serial_tiles": int(st[:, 4].sum())}
                else:
                    got = {"tiles": int(st[:, 0].sum()), "doubling_rounds": int(st[:, 1].sum()),
                           "doubling_rounds_max_tile": int(st[:, 2].max())}
                print(f"kernel [{card}] {name} {shape} counters: {got}")
                for k2, v in got.items():  # over the shapes: most of a max, else the sum
                    if k2 == "passes_mean":
                        continue
                    c = counters.get(k2, 0)
                    counters[k2] = max(c, v) if "_max" in k2 else c + v
            if row is None or key[0][0] == ((B, N), "torch.uint8") or key == rep_key.get(name):
                row = {
                    "name": name, "route": "cuda", "source": source, "replaces": replaces,
                    "launches": all_launches[name], "max_abs_err": max_err[name],
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None, "shape": shape,
                    **({"device_ms": dev_ms} if name in KERNEL_SYMBOL else {}),
                    **({"queued_ms": q_ms} if q_ms is not None else {}),
                    "launches_slice1": launches1.get(name, 0),
                    "launches_level19": launches19.get(name, 0),
                    "launches_windows": {p_: l_.get(name, 0) for p_, l_ in win_launches.items()},
                    "launches_4g": {p_: l_.get(name, 0) for p_, l_ in paths4g.items()},
                    "plain_kind": PLAIN_KIND.get(name, "torch ops on the card"),
                    **extra.get(name, {}),
                }
                if name == "sort":
                    row["library_ms"] = _time_ms(lambda: sort_library(*args), 3)
                if name in ("sort", "match"):
                    row["network_ops_ms"] = network_ms(*args[0].shape)
        row["ms_per_batch"] = per_batch
        row["bound_ms_per_batch"] = bound_batch
        if name in KERNEL_SYMBOL:
            row["device_ms_per_batch"] = dev_batch
        if counters:
            row["counters_per_batch"] = counters
        rows_out.append(row)
        print(f"kernel [{card}] {name}: {per_batch:.4f} ms per batch over "
              f"{all_launches[name]} launches, bound {bound_batch:.4f} ms per batch"
              + (f", on the device {_fmt_ms(dev_batch)}" if name in KERNEL_SYMBOL else ""))
        if name == "concat":
            print(f"kernel [{card}] concat: 2d2f9bf's K2 stage on the same operands: "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in CONCAT_PARENT_MS.items()))
    # K1, K2 and K3 on the largest input each window path of phase 4f gave
    # them, beside the bound.
    for p_, cap_ in win_captured.items():
        for name in ("roll", "concat", "greedy"):
            if not cap_[name]:
                continue
            key, (args, kw, n_calls) = max(
                cap_[name].items(),
                key=lambda kv: sum(nbytes(a) for a in kv[1][0] if torch.is_tensor(a)))
            kern = K[name][0]
            out = kern(*args, **kw)
            b_ms, _ = bound(name, args, kw, out)
            print(f"kernel [{card}] {name} {shape_of(name, key)} on the {p_} path "
                  f"(x{n_calls} a call): {_time_ms(lambda: kern(*args, **kw), 20):.4f} ms, "
                  f"bound {b_ms:.4f} ms")
    del win_captured
    k8 = next(r for r in rows_out if r["name"] == "exec")
    k8["name"] = "exec_k8"
    rows_out.append({**k8, "name": "exec_k9", "replaces": K9_REPLACES})
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the goldens were read")
    print(card)
    print(json.dumps({"kernels": rows_out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
