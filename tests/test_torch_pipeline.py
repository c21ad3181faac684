"""The PyTorch port end to end: frames byte-identical to the JAX reference.

`tpu_zstd_torch.ops.pipeline.compress(..., device="cpu")` against
`tpu_zstd.ops.pipeline.compress` at the same `PipelineConfig` (raw literals,
predefined FSE tables) on the conftest corpus and a bench-corpus slice;
stock libzstd (`zstandard`) must decode every port frame. Bytes: exact
equality. Also the port's configuration, corpus copy, import boundary,
full-width goldens (tests/golden/torch_slice{1,2,4}.json, made by
tools/make_torch_goldens.py; the full-width JAX graph is never built here),
and the seeded SLICE_CONFIG frame cases of tests/torch_cases.py against
both packages and tests/golden/torch_cases.json.
"""

import ast
import dataclasses
import json
import pathlib

import jax  # noqa: F401  (JAX stays on the CPU; see conftest.py)
import pytest
import torch
import torch_cases
import zstandard

import bench
from tpu_zstd.ops import pipeline as jp
from tpu_zstd_torch import corpus
from tpu_zstd_torch.api import config as tc
from tpu_zstd_torch.api import manager as tm
from tpu_zstd_torch.ops import pipeline as tp

ROOT = pathlib.Path(__file__).resolve().parent.parent
# 8 KB and 16 KB blocks, hash_log 13, 4 KB match windows: both the windowed
# match search and the windowed extraction run.
JAX_CFGS = {
    bs: jp.PipelineConfig(block_size=bs, hash_log=13, mf_win_log=12,
                          huffman_literals=False, custom_fse=False)
    for bs in (8192, 16384)
}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _first_block_type(frame: bytes, n: int) -> int:
    """Type of a frame's first block (single-segment header: magic, one
    descriptor byte, then a 1-, 2- or 4-byte content size)."""
    fcs = 1 if n <= 255 else 2 if n <= 65791 else 4
    return frame[5 + fcs] >> 1 & 3


def _cases(corpus_cases, bs):
    """Each distinct block count costs one more JAX compile, so: 8 KB blocks
    take the conftest cases of one block and the 39-block one; 16 KB blocks
    take the cases of one block (the 13.5 KB text among them) and a 4-block
    bench-corpus slice."""
    cases = {k: v for k, v in corpus_cases.items() if len(v) <= bs}
    if bs == 8192:
        cases["multiblock"] = corpus_cases["multiblock"]
        return cases
    cases["bench_slice"] = corpus.make_corpus(4 * bs)
    return cases


def _check_compress_frames_identical_to_jax(corpus, dctx, bs):
    jcfg = JAX_CFGS[bs]
    tcfg = tp.config_from_reference(dataclasses.asdict(jcfg))
    btypes = set()
    for name, data in _cases(corpus, bs).items():
        mine = tp.compress(data, tcfg, device="cpu")
        assert mine == jp.compress(data, jcfg), f"{name}: frame differs from the JAX reference"
        assert dctx.decompress(mine, max_output_size=max(len(data), 1)) == data, name
        if data:
            btypes.add(_first_block_type(mine, len(data)))
    assert len(btypes) >= 2  # more than one block type was emitted


def _check_staged_many_matches_staged():
    cfg = tp.config_from_reference(dataclasses.asdict(JAX_CFGS[8192]))
    data = corpus.make_corpus(6 * 8192)
    blocks, lengths = tp._split_blocks(data, 8192)
    blocks, lengths = torch.from_numpy(blocks), torch.from_numpy(lengths)
    batches = [(blocks[:3], lengths[:3]), (blocks[3:], lengths[3:]), (blocks[:2], lengths[:2])]
    many = tp.compress_blocks_staged_many(batches, cfg)
    assert len(many) == 3
    for (b, l), got in zip(batches, many):
        ref = tp.compress_blocks_staged(b, l, cfg)
        for x, y in zip(got, ref):
            assert torch.equal(x, y)


def _check_config_from_reference():
    ref = jp.PipelineConfig(huffman_literals=False, custom_fse=False)
    cfg = tp.config_from_reference(dataclasses.asdict(ref))
    assert cfg == tp.SLICE_CONFIG
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert tp.config_from_reference(dataclasses.asdict(jp.DEFAULT_CONFIG)) == tp.DEFAULT_CONFIG
    assert {f.name for f in dataclasses.fields(tp.PipelineConfig)} == {
        f.name for f in dataclasses.fields(jp.PipelineConfig)}
    with pytest.raises(ValueError):
        tp.config_from_reference({**dataclasses.asdict(ref), "no_such_field": 1})


# Still refused: min_match other than 3 or 4, and decode checkpoints without
# custom FSE tables (where the reference returns a tuple its manager cannot
# use). The window settings run since the cross-block slice.
UNSUPPORTED = [{"ckpt_every": 64}, {"min_match": 5}]
WINDOW_SETTINGS = [{"dict_cap": 4096}, {"ldm_window": True}, {"sample_log": 1},
                   {"dec_min_ml": 8}]


def _check_unsupported_requests_raise(dctx):
    ref = jp.PipelineConfig(huffman_literals=False, custom_fse=False)
    for change in UNSUPPORTED:
        with pytest.raises(NotImplementedError):
            tp.config_from_reference({**dataclasses.asdict(ref), **change})
        with pytest.raises(NotImplementedError):
            tp.compress(b"abc" * 100, dataclasses.replace(tp.SLICE_CONFIG, **change), device="cpu")
    data = corpus.make_corpus(20000)
    for change in WINDOW_SETTINGS:
        cfg = tp.config_from_reference({**dataclasses.asdict(ref), **change})
        assert cfg == dataclasses.replace(tp.SLICE_CONFIG, **change)
        if "dict_cap" in change:  # rows need their window prefix: compress_blocks_dict
            with pytest.raises(ValueError):
                tp.compress(data, cfg, device="cpu")
            continue
        frame = tp.compress(data, cfg, device="cpu")
        assert dctx.decompress(frame, max_output_size=len(data)) == data, change
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tp.compress(b"abc")  # device=None means CUDA


def _check_empty_input_frame(dctx):
    for checksum in (False, True):
        frame = tp.compress(b"", checksum=checksum, device="cpu")
        assert frame == jp.compress(b"", checksum=checksum)
        assert dctx.decompress(frame, max_output_size=1) == b""


def _check_corpus_copy_equals_bench():
    for n in (1000, 3 * 131072 + 17):
        assert corpus.make_corpus(n) == bench.make_corpus(n)


def _check_golden_files():
    for name, cfg in (("torch_slice1.json", tp.SLICE_CONFIG),
                      ("torch_slice2.json", tp.DEFAULT_CONFIG)):
        doc = json.loads((ROOT / "tests" / "golden" / name).read_text())
        blocks = doc["batch"]["blocks"]
        assert len(blocks) == 128
        assert all(set(b) == {"btype", "clen", "sha256"} and len(b["sha256"]) == 64
                   for b in blocks)
        assert all(b["btype"] in (0, 1, 2) and 0 < b["clen"] <= 131072 for b in blocks)
        assert doc["frame"]["len"] > 0 and len(doc["frame"]["sha256"]) == 64
        assert tp.config_from_reference(doc["config"]) == cfg
    items = doc["items"]
    assert items["level"] == 3 and len(items["sizes"]) == len(items["frames"])
    assert all(64 * 1024 <= n <= 256 * 1024 for n in items["sizes"])
    doc4 = json.loads((ROOT / "tests" / "golden" / "torch_slice4.json").read_text())
    assert tp.config_from_reference(doc4["config"]) == tm._pipeline_config(
        tc.CompressionConfig.from_level(19))
    blocks = doc4["batch"]["blocks"]
    assert len(blocks) == 128 and all(
        set(b) == {"btype", "clen", "sha256", "lit_price", "bank_sha256"} for b in blocks)
    assert all(8 <= b["lit_price"] <= 176 for b in blocks)
    assert doc4["items"]["level"] == 19 and doc4["items"]["sizes"] == items["sizes"]
    assert len(doc4["items"]["frames"]) == len(items["frames"])


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _check_port_imports_no_jax_and_no_reference_package():
    """No file of the package, nor chip_smoke.py, imports JAX or the JAX
    package; no file of the package imports `zstandard` (the card's machine
    has none; chip_smoke.py uses it where it is installed)."""
    files = sorted((ROOT / "tpu_zstd_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    rel = {str(f.relative_to(ROOT)) for f in files}
    assert {f"tpu_zstd_torch/{m}.py" for m in (
        "__init__", "api/__init__", "ops/chain", "ops/fse_tables", "ops/huffman",
        "format/xxhash", "api/config", "api/manager", "ops/decode", "ops/decode_lanes",
        "ops/exec", "api/decompress", "format/accel", "format/bitstream", "format/huffman",
        "format/sequences", "format/frame", "format/fse", "format/lz77", "ops/opt", "ops/sort",
        "ops/match", "ops/deposit", "dictionary", "utils/__init__", "utils/native",
        "utils/profiler", "api/hybrid", "api/adaptive", "api/nvcomp", "parallel/__init__",
        "parallel/sharding", "parallel/multihost")} <= rel
    for f in files:
        banned = ("jax", "jaxlib", "tpu_zstd") + (("zstandard",) if f.parent != ROOT else ())
        for mod in _imported_modules(f):
            root = mod.split(".")[0]
            assert root not in banned, f"{f.relative_to(ROOT)} imports {mod}"


def _parent_chain(node) -> int:
    n = 0
    while isinstance(node, ast.Attribute) and node.attr == "parent":
        n, node = n + 1, node.value
    return n


def _check_port_reaches_no_reference_path():
    """No source of the package names a path into the JAX package
    (`tpu_zstd/`) or the repository's csrc/ build (`csrc/build`,
    `libtpu_zstd_native`) outside its docstrings, nor climbs above the
    package with `.parent`; the kernel and host libraries build from the
    package's own sources into its own _build/."""
    from tpu_zstd_torch.ops import _kernels
    from tpu_zstd_torch.utils import native

    pkg = ROOT / "tpu_zstd_torch"
    for f in sorted(pkg.rglob("*.py")):
        tree = ast.parse(f.read_text(), filename=str(f))
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
                and n.body and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        depth = len(f.relative_to(pkg).parts)
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs):
                assert not any(b in node.value for b in ("tpu_zstd/", "csrc/build",
                                                         "libtpu_zstd_native")), (f, node.value)
            assert _parent_chain(node) <= depth, f"{f.relative_to(ROOT)} climbs above the package"
    for path in (native.SRC_DIR, native.BUILD_DIR, native.library_path(), _kernels.CSRC_DIR,
                 _kernels.BUILD_DIR):
        assert path.resolve().is_relative_to(pkg), path
    assert not list(native.SRC_DIR.glob("*.cu")) and sorted(
        p.name for p in native.SRC_DIR.iterdir()) == sorted(native.SOURCES)


def test_port_end_to_end(corpus):
    """One test item for the whole file (see tests/test_torch_kernels.py)."""
    dctx = zstandard.ZstdDecompressor()
    for bs in sorted(JAX_CFGS):
        _check_compress_frames_identical_to_jax(corpus, dctx, bs)
    _check_staged_many_matches_staged()
    _check_config_from_reference()
    _check_unsupported_requests_raise(dctx)
    _check_empty_input_frame(dctx)
    _check_corpus_copy_equals_bench()
    _check_golden_files()
    _check_port_imports_no_jax_and_no_reference_package()
    _check_port_reaches_no_reference_path()
    torch_cases.check_live("pipeline")
