"""Write the goldens the PyTorch port is held against, from the JAX package.

Runs the JAX reference (tpu_zstd) on the CPU over the bench corpus and
records what it emits. Stock libzstd (`zstandard`) must decode every frame
before anything is written. Targets (default: slice2 cases):

- slice1 -> tests/golden/torch_slice1.json, the port's first configuration
  (raw literals, predefined FSE tables; every other field at DEFAULT_CONFIG):
  one 128 x 128 KB batch (per block: type, content length, sha256 of the
  content) and the frame of make_corpus(4 * 131072) through `compress`;
- slice2 -> tests/golden/torch_slice2.json, at DEFAULT_CONFIG (Huffman
  literals, custom FSE tables): the same batch, the 4-block frame with
  checksum=True, and the level-3 `compress_items_tpu` frames of 16 items of
  64-256 KB (consecutive slices of one corpus; their sizes are recorded);
- slice3 -> tests/golden/torch_slice3.json, the decode path's input: the
  bench batch make_corpus(128 * 131072) as 128 single-block items through
  `compress_items_tpu` at level 3 with decode_accel=True (the frames that
  bench.py decodes; accel sidecar included), each item's and frame's length
  and sha256, and the first 4 items again with a content checksum;
- slice4 -> tests/golden/torch_slice4.json, the optimal-parse path at the
  level-19 pipeline config (`_pipeline_config(CompressionConfig.from_level(19))`:
  min_match 3, depth 48, cap 64, 64 KB match windows, LDM, the segment DP):
  the bench batch in chunks of 32 blocks (blocks compress independently), per
  block its type, content length and sha256 plus the DP's inputs from pass 1
  (the literal price and the sha256 of the cost-bank row, caught at the
  `opt_steps` call), and the 16 level-19 `compress_items_tpu` frames of the
  slice-2 items;
- cases -> tests/golden/torch_cases.json, the digest of every seeded case in
  tests/torch_cases.py (small shapes: kernels, parse, table choice, state
  chains, Huffman stages, frames at 8-16 KB blocks, levels 1/3/5);
- multiblock -> tests/golden/multiblock_frames.json, the multi-block frames
  of tests/torch_cases.py `multiblock_specs` (the JAX package's
  `compress_items_tpu` at 8 KB blocks, and stock libzstd with blocks ended by
  flushes), inputs of the case `decompress_multiblock`; make it before
  `cases` when the specs change;
- slice5 -> tests/golden/torch_slice5.json, the public surface's long-window
  frame: the bench batch make_corpus(128 * 131072) as ONE item through
  `compress_items_tpu` at level 3 (a frame of 128 blocks whose header
  declares a 16 MiB window), its length and sha256 and the header's window
  and content sizes;
- slice6 -> tests/golden/torch_slice6.json, the cross-block windows on the
  bench corpus make_corpus(128 * 131072): `compress_items_tpu` with
  enable_ldm over 16 items of 1 MiB (level 3; 128 rows of a 64 KB window
  and a 128 KB block); `StreamingManager(level=3)` over the corpus in 16
  chunks of 1 MiB (the default 64 KB history); `compress_items_tpu` at
  level 19 of the 8 blocks after the corpus's first 64 KB, with those 64 KB
  as history; `train_dictionary` (64 KB) on 1024 records of 256-4096 bytes
  (tests/torch_cases.py `dict_records`) and `compress_with_dict` of 256
  other records (level 3). Each frame's length and sha256, the
  dictionary's too; libzstd decodes every frame first (the history frame
  and the dictionary frames with their raw-content dictionary).

- slice7 -> tests/golden/torch_slice7.json, the last modules
  (tests/torch_cases.py `slice7_inputs`): XXH64 and XXH32 of seeded
  buffers, the JAX package's `NativeEngine` frames at levels 1, 3 and 19 of
  make_corpus(4 MiB) and at level 3 of the corpus's first 64 KB (the hybrid
  engine's host route), `select_adaptive_level` at each preference of the
  corpus, seeded random bytes and a run of one byte, the metadata frame of
  `NvcompV5BatchManager` over slice2's 16 items (their sizes and slice2's
  frame lengths) and `HybridEngine.decide_route` on phase 4g's calls. No
  XLA compile: seconds.

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py [slice1] [slice2] [slice3] [slice4]
        [slice5] [slice6] [slice7] [multiblock] [cases]

About 4 minutes for slice1, 7 for slice2, slice3 and slice5, 13 for slice4
(on 8 cores) and about 25 for cases on the CPU. Give slice1-slice5 a fresh process (or
list it first): after the ~40 case compiles, XLA:CPU's compile of the
full-width batch failed for lack of memory mappings in the same process.
For the same reason `cases` runs each group of cases in a process of its
own.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import json
import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import zstandard  # noqa: E402

from bench import make_corpus  # noqa: E402
from tpu_zstd.api.config import ChecksumPolicy, CompressionConfig  # noqa: E402
from tpu_zstd.api.manager import compress_items_tpu  # noqa: E402
from tpu_zstd.constants import BLOCK_RLE  # noqa: E402
from tpu_zstd.format.frame import parse_frame_header, write_frame_header  # noqa: E402
from tpu_zstd.ops.pipeline import (  # noqa: E402
    DEFAULT_CONFIG,
    PipelineConfig,
    _split_blocks,
    compress,
    compress_blocks_staged,
)

GOLDEN = ROOT / "tests" / "golden"
BATCH_BLOCKS = 128
FRAME_BLOCKS = 4
ITEMS_SEED, ITEMS_COUNT = 2026, 16
CHECKSUM_ITEMS = 4


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _frame(lengths, contents, clens, btypes) -> bytes:
    parts = [write_frame_header(int(lengths.sum()))]
    for b in range(len(lengths)):
        last = int(b == len(lengths) - 1)
        if int(btypes[b]) == BLOCK_RLE:
            parts += [((int(lengths[b]) << 3) | (BLOCK_RLE << 1) | last).to_bytes(3, "little"),
                      contents[b, :1].tobytes()]
        else:
            clen = int(clens[b])
            parts += [((clen << 3) | (int(btypes[b]) << 1) | last).to_bytes(3, "little"),
                      contents[b, :clen].tobytes()]
    return b"".join(parts)


def _decodes(frame: bytes, data: bytes, what: str) -> None:
    if zstandard.ZstdDecompressor().decompress(frame, max_output_size=max(len(data), 1)) != data:
        raise SystemExit(f"libzstd failed to decode {what}")


def _batch(cfg: PipelineConfig) -> dict:
    data = make_corpus(BATCH_BLOCKS * cfg.block_size)
    blocks, lengths = _split_blocks(data, cfg.block_size)
    contents, clens, btypes = jax.device_get(
        compress_blocks_staged(jnp.asarray(blocks), jnp.asarray(lengths), cfg)
    )
    _decodes(_frame(lengths, contents, clens, btypes), data, "the batch frame")
    out = [{"btype": int(btypes[b]), "clen": int(clens[b]),
            "sha256": _sha(contents[b, : int(clens[b])].tobytes())} for b in range(len(lengths))]
    return {
        "corpus": f"make_corpus({BATCH_BLOCKS} * {cfg.block_size})",
        "block_body_ratio": len(data) / sum(b["clen"] for b in out),
        "blocks": out,
    }


def _small_frame(cfg: PipelineConfig, checksum: bool) -> dict:
    small = make_corpus(FRAME_BLOCKS * cfg.block_size)
    frame = compress(small, cfg, checksum=checksum)
    _decodes(frame, small, "the 4-block frame")
    return {"corpus": f"make_corpus({FRAME_BLOCKS} * {cfg.block_size})", "checksum": checksum,
            "len": len(frame), "sha256": _sha(frame)}


def _write(name: str, doc: dict) -> None:
    GOLDEN.mkdir(parents=True, exist_ok=True)
    (GOLDEN / name).write_text(json.dumps(doc, indent=1) + "\n")


def slice1() -> None:
    cfg = PipelineConfig(huffman_literals=False, custom_fse=False)
    doc = {"config": dataclasses.asdict(cfg), "batch": _batch(cfg)}
    frame = _small_frame(cfg, checksum=False)
    doc["frame"] = {k: frame[k] for k in ("corpus", "len", "sha256")}
    _write("torch_slice1.json", doc)


def slice2() -> None:
    cfg = DEFAULT_CONFIG
    doc = {"config": dataclasses.asdict(cfg), "batch": _batch(cfg),
           "frame": _small_frame(cfg, checksum=True)}
    rng = np.random.default_rng(ITEMS_SEED)
    sizes = [int(s) for s in rng.integers(64 * 1024, 256 * 1024 + 1, ITEMS_COUNT)]
    base = make_corpus(sum(sizes))
    starts = np.cumsum([0] + sizes[:-1])
    items = [base[s : s + n] for s, n in zip(starts, sizes)]
    ccfg = CompressionConfig.from_level(3)
    frames = compress_items_tpu(items, ccfg)
    for f, d in zip(frames, items):
        _decodes(f, d, "a level-3 item frame")
    doc["items"] = {
        "level": 3,
        "corpus": "consecutive slices of make_corpus(sum(sizes))",
        "sizes": sizes,
        "frames": [{"len": len(f), "sha256": _sha(f)} for f in frames],
    }
    _write("torch_slice2.json", doc)


def slice3() -> None:
    N = DEFAULT_CONFIG.block_size
    data = make_corpus(BATCH_BLOCKS * N)
    items = [data[i * N : (i + 1) * N] for i in range(BATCH_BLOCKS)]
    ccfg = dataclasses.replace(CompressionConfig.from_level(3), decode_accel=True)
    frames = compress_items_tpu(items, ccfg)
    ck_cfg = dataclasses.replace(ccfg, checksum=ChecksumPolicy.COMPUTE)
    ck_frames = compress_items_tpu(items[:CHECKSUM_ITEMS], ck_cfg)
    for f, d in zip(frames + ck_frames, items + items[:CHECKSUM_ITEMS]):
        _decodes(f, d, "an accel item frame")
    doc = {
        "config": {k: int(v) if isinstance(v, enum.Enum) else v
                   for k, v in dataclasses.asdict(ccfg).items()},
        "corpus": f"make_corpus({BATCH_BLOCKS} * {N}), one item per {N} bytes",
        "items": [{"len": len(d), "sha256": _sha(d)} for d in items],
        "frames": [{"len": len(f), "sha256": _sha(f)} for f in frames],
        "checksum_frames": [{"len": len(f), "sha256": _sha(f)} for f in ck_frames],
    }
    _write("torch_slice3.json", doc)


SLICE4_CHUNK = 32


def _spy_opt_steps(record: list):
    """Wrap the JAX package's `opt_steps` (looked up by `parse_block` at
    trace time) so each call also hands the host its per-block literal price
    and cost-bank row, batch axis first; the DP's result is unchanged."""
    from tpu_zstd.ops import pallas_opt

    orig = pallas_opt.opt_steps

    def rec(lit_bits, bank):
        lit_bits, bank = np.asarray(lit_bits), np.asarray(bank)
        record.append((lit_bits.reshape(-1, lit_bits.shape[-1])[:, 0].copy(),
                       bank.reshape(-1, *bank.shape[-2:])[:, 0].copy()))
        return np.zeros(lit_bits.shape[:-1], np.int32)

    def spy(packed, mm, cap, lit_bits=None, cost_bank=None):
        out = orig(packed, mm, cap, lit_bits=lit_bits, cost_bank=cost_bank)
        tok = jax.pure_callback(rec, jax.ShapeDtypeStruct((), jnp.int32), lit_bits, cost_bank,
                                vmap_method="expand_dims")
        return out + (tok != 0).astype(out.dtype)

    pallas_opt.opt_steps = spy


def slice4() -> None:
    from tpu_zstd.api.manager import _pipeline_config

    ccfg = CompressionConfig.from_level(19)
    cfg = _pipeline_config(ccfg)
    record: list = []
    _spy_opt_steps(record)
    N = cfg.block_size
    data = make_corpus(BATCH_BLOCKS * N)
    blocks, lengths = _split_blocks(data, N)
    parts = []
    for c in range(0, BATCH_BLOCKS, SLICE4_CHUNK):
        t0 = time.perf_counter()
        record.clear()
        out = jax.device_get(compress_blocks_staged(
            jnp.asarray(blocks[c : c + SLICE4_CHUNK]), jnp.asarray(lengths[c : c + SLICE4_CHUNK]),
            cfg))
        if len(record) != 1 or len(record[0][0]) != SLICE4_CHUNK:
            raise SystemExit(f"expected one opt_steps call over the chunk, got {len(record)}")
        parts.append((*out, *record[0]))
        print(f"  blocks {c}..{c + SLICE4_CHUNK}: {time.perf_counter() - t0:.1f} s", flush=True)
    contents, clens, btypes, lit, bank = (np.concatenate(x) for x in zip(*parts))
    _decodes(_frame(lengths, contents, clens, btypes), data, "the level-19 batch frame")
    out = [{"btype": int(btypes[b]), "clen": int(clens[b]),
            "sha256": _sha(contents[b, : int(clens[b])].tobytes()),
            "lit_price": int(lit[b]),
            "bank_sha256": _sha(bank[b].astype("<i4").tobytes())} for b in range(len(lengths))]
    doc = {
        "config": dataclasses.asdict(cfg),
        "batch": {
            "corpus": f"make_corpus({BATCH_BLOCKS} * {N})",
            "chunk": SLICE4_CHUNK,
            "block_body_ratio": len(data) / sum(b["clen"] for b in out),
            "blocks": out,
        },
    }
    rng = np.random.default_rng(ITEMS_SEED)
    sizes = [int(s) for s in rng.integers(64 * 1024, 256 * 1024 + 1, ITEMS_COUNT)]
    base = make_corpus(sum(sizes))
    starts = np.cumsum([0] + sizes[:-1])
    items = [base[s : s + n] for s, n in zip(starts, sizes)]
    t0 = time.perf_counter()
    frames = compress_items_tpu(items, ccfg)
    print(f"  items: {time.perf_counter() - t0:.1f} s", flush=True)
    for f, d in zip(frames, items):
        _decodes(f, d, "a level-19 item frame")
    doc["items"] = {
        "level": 19,
        "corpus": "consecutive slices of make_corpus(sum(sizes))",
        "sizes": sizes,
        "frames": [{"len": len(f), "sha256": _sha(f)} for f in frames],
    }
    _write("torch_slice4.json", doc)


def slice5() -> None:
    N = DEFAULT_CONFIG.block_size
    data = make_corpus(BATCH_BLOCKS * N)
    ccfg = CompressionConfig.from_level(3)
    frame, = compress_items_tpu([data], ccfg)
    _decodes(frame, data, "the 16 MiB level-3 item frame")
    hdr = parse_frame_header(frame)
    doc = {
        "config": {k: int(v) if isinstance(v, enum.Enum) else v
                   for k, v in dataclasses.asdict(ccfg).items()},
        "corpus": f"make_corpus({BATCH_BLOCKS} * {N}), one item",
        "size": len(data),
        "window_size": hdr.window_size,
        "content_size": hdr.content_size,
        "len": len(frame),
        "sha256": _sha(frame),
    }
    _write("torch_slice5.json", doc)


def _frames_doc(frames) -> list:
    return [{"len": len(f), "sha256": _sha(f)} for f in frames]


def _decodes_with(frame: bytes, data: bytes, dict_content: bytes, what: str) -> None:
    zd = zstandard.ZstdCompressionDict(dict_content, dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    got = zstandard.ZstdDecompressor(dict_data=zd).decompress(frame,
                                                              max_output_size=max(len(data), 1))
    if got != data:
        raise SystemExit(f"libzstd failed to decode {what}")


def slice6() -> None:
    from tpu_zstd import dictionary
    from tpu_zstd.api.manager import StreamingManager

    import torch_cases

    N = DEFAULT_CONFIG.block_size
    data = make_corpus(BATCH_BLOCKS * N)
    inp = torch_cases.slice6_inputs(data, N)
    doc = {"corpus": f"make_corpus({BATCH_BLOCKS} * {N})", "item": torch_cases.SLICE6_ITEM}

    t0 = time.perf_counter()
    ccfg = dataclasses.replace(CompressionConfig.from_level(3), enable_ldm=True)
    frames = compress_items_tpu(inp["items"], ccfg)
    for f, d in zip(frames, inp["items"]):
        _decodes(f, d, "an enable_ldm item frame")
    doc["ldm_items"] = {"level": 3, "enable_ldm": True, "frames": _frames_doc(frames)}
    print(f"  ldm items: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    sm = StreamingManager(level=3)
    stream = b"".join(sm.compress_chunk(c) for c in inp["items"]) + sm.flush()
    _decodes(stream, data, "the level-3 stream")
    doc["stream"] = {"level": 3, "chunks": len(inp["items"]), "len": len(stream),
                     "sha256": _sha(stream)}
    print(f"  stream: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    f19, = compress_items_tpu([inp["item19"]], CompressionConfig.from_level(19),
                              history=[inp["history"]])
    _decodes_with(f19, inp["item19"], inp["history"], "the level-19 history frame")
    doc["history19"] = {"level": 19, "history": torch_cases.SLICE6_HISTORY, "len": len(f19),
                        "sha256": _sha(f19)}
    print(f"  level-19 history frame: {time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    d = dictionary.train_dictionary(inp["train"], dict_size=64 * 1024)
    frames = dictionary.compress_with_dict(inp["records"], d)
    for f, r in zip(frames, inp["records"]):
        _decodes_with(f, r, d.content, "a dictionary frame")
    doc["dictionary"] = {"records": torch_cases.SLICE6_RECORDS, "dict_size": 64 * 1024,
                         "content_len": len(d.content), "content_sha256": _sha(d.content),
                         "dict_id": d.dict_id, "frames": _frames_doc(frames)}
    print(f"  dictionary: {time.perf_counter() - t0:.1f} s", flush=True)
    _write("torch_slice6.json", doc)


def slice7() -> None:
    from tpu_zstd.api import adaptive, hybrid
    from tpu_zstd.api.nvcomp import NvcompV5BatchManager
    from tpu_zstd.utils import native

    import torch_cases

    if native.get_native() is None:
        raise SystemExit("the JAX package's native library is unavailable (no g++)")
    N = DEFAULT_CONFIG.block_size
    data = make_corpus(BATCH_BLOCKS * N)
    inp = torch_cases.slice7_inputs(data)
    doc = {"corpus": f"make_corpus({BATCH_BLOCKS} * {N})", "seed": torch_cases.SLICE7_SEED}
    doc["xxh"] = [{"len": len(b), "xxh64": native.xxh64(b), "xxh64_seed": native.xxh64(b, 7),
                   "xxh32": native.xxh32(b), "xxh32_seed": native.xxh32(b, 7)}
                  for b in inp["xxh"]]
    frames = []
    for level in torch_cases.SLICE7_LEVELS:
        eng = native.NativeEngine.create(level)
        f = eng.compress(inp["native"])
        _decodes(f, inp["native"], f"the native level-{level} frame")
        frames.append({"level": level, "len": len(f), "sha256": _sha(f)})
    doc["native"] = {"corpus": f"make_corpus({torch_cases.SLICE7_NATIVE})", "frames": frames}
    f = native.NativeEngine.create(3).compress(inp["host"])
    _decodes(f, inp["host"], "the native 64 KB frame")
    doc["host_frame"] = {"level": 3, "size": len(inp["host"]), "len": len(f), "sha256": _sha(f)}
    doc["adaptive"] = [[adaptive.select_adaptive_level(d, p) for p in adaptive.Preference]
                       for d in inp["adaptive"]]
    g2 = json.loads((GOLDEN / "torch_slice2.json").read_text())["items"]
    meta = NvcompV5BatchManager._build_metadata_frame(g2["sizes"],
                                                      [f["len"] for f in g2["frames"]])
    doc["nvcomp_meta"] = {"len": len(meta), "sha256": _sha(meta)}
    routes = []
    for mode, size, loc, is_c in torch_cases.SLICE7_ROUTES:
        eng = hybrid.HybridEngine(hybrid.HybridConfig(mode=hybrid.RoutingMode(mode)))
        b, why = eng.decide_route(size, hybrid.DataLocation(loc), is_c)
        routes.append({"call": [mode, size, loc, is_c], "backend": int(b), "reason": why})
    doc["routes"] = routes
    _write("torch_slice7.json", doc)


def _cases_group(group: str) -> None:
    """Print the JSON digests of one group's cases as the last stdout line."""
    import torch_cases

    out = {}
    for name, c in torch_cases.CASES.items():
        if c.group == group:
            t0 = time.perf_counter()
            out[name] = torch_cases.run_ref(name)
            print(f"  case {name}: {time.perf_counter() - t0:.1f} s", file=sys.stderr, flush=True)
    print(json.dumps(out))


def cases() -> None:
    """Each group of cases in a process of its own: some 70 case compiles in
    one process exhaust XLA:CPU's memory mappings."""
    import subprocess

    import torch_cases

    out = {}
    for group in dict.fromkeys(c.group for c in torch_cases.CASES.values()):
        run = subprocess.run([sys.executable, __file__, "--cases-group", group],
                             stdout=subprocess.PIPE, text=True, check=True)
        out.update(json.loads(run.stdout.strip().splitlines()[-1]))
    _write("torch_cases.json", {"source": "tools/make_torch_goldens.py from tpu_zstd (JAX, CPU)",
                                "cases": {name: out[name] for name in torch_cases.CASES}})


def multiblock() -> None:
    """The case `decompress_multiblock`'s frames, base64, each decoded back
    by libzstd first."""
    import base64

    import torch_cases

    frames = []
    for spec in torch_cases.multiblock_specs():
        if spec["by"] == "zstd":
            frame = torch_cases.zstd_flushed(spec)
        else:
            cfg = dataclasses.replace(
                CompressionConfig.from_level(spec["level"]), block_size=torch_cases.MB_N,
                checksum=ChecksumPolicy.COMPUTE if spec["checksum"] else ChecksumPolicy.NONE,
                decode_accel=spec["decode_accel"])
            frame, = compress_items_tpu([spec["payload"]], cfg)
        _decodes(frame, spec["payload"], f"the {spec['by']} level-{spec['level']} frame")
        frames.append({**{k: v for k, v in spec.items() if k != "payload"}, "len": len(frame),
                       "b64": base64.b64encode(frame).decode()})
    _write("multiblock_frames.json", {
        "source": f"tools/make_torch_goldens.py: tpu_zstd (JAX, CPU) and zstandard "
                  f"{zstandard.__version__}", "frames": frames})


TARGETS = {"slice1": slice1, "slice2": slice2, "slice3": slice3, "slice4": slice4,
           "slice5": slice5, "slice6": slice6, "slice7": slice7, "multiblock": multiblock,
           "cases": cases}


def main(argv: list[str]) -> None:
    if argv[:1] == ["--cases-group"]:
        _cases_group(argv[1])
        return
    targets = argv or ["slice2", "cases"]
    for t in targets:
        if t not in TARGETS:
            raise SystemExit(f"unknown target {t!r}")
    for t in targets:
        t0 = time.perf_counter()
        TARGETS[t]()
        print(f"{t}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
