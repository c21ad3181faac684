"""The port's public surface (tpu_zstd_torch, tpu_zstd_torch/api and the host
codec in tpu_zstd_torch/format) against the live JAX package: the seeded
cases of tests/torch_cases.py, group "api" (the host codec's frames and its
decoder, `decompress_batch_tpu`, the streaming decoder, `Manager`, the
top-level functions, `BatchManager.decompress_batch`, the validators and
hashes); the host encoder's stages on seeded inputs (the LL/ML/OF code
functions, FSE normalization and NCount headers, Huffman literals, the
hash-chain parse, the predefined-table sequence section); the enums;
`compress_batch_async`, the top-level `compress_batch` and
`decompress_batch_to_device` against the port's own batch paths; and
where the port differs from the reference by design: no entry point runs
without a card unless asked for the CPU, and `decompress_batch(use_tpu=True)`
falls through to the host only on a parse error, never after device work
has begun. The last modules: group "surface" (the native host runtime and
engine, `HybridEngine`, adaptive levels, the nvCOMP container, the OOM
ladder) against the JAX package; the C++ copies byte-equal to the
repository's `csrc/`, the native library built into the port's own
`_build/` (never `csrc/build/`), a failed build raising with the compiler's
output, the pure-Python fallbacks without a compiler and none where the
loaded library fails; only
`torch.cuda.OutOfMemoryError` starting the OOM ladder, a single item that
still runs out going to the native engine and counted apart; and an error of the device half
propagating out of `HybridEngine.decompress` and `decompress_batch`.
Exact equality. One test item (see tests/test_torch_kernels.py).
"""

import dataclasses
import hashlib
import pathlib

import numpy as np
import pytest
import torch
import torch_cases
import zstandard

import tpu_zstd_torch
from tpu_zstd import constants as jconst
from tpu_zstd.api import config as jc
from tpu_zstd.format import fse as jfse
from tpu_zstd.format import huffman as jhuf
from tpu_zstd.format import lz77 as jlz
from tpu_zstd.format import sequences as jseq
from tpu_zstd_torch import constants as tconst
from tpu_zstd_torch.api import config as tc
from tpu_zstd_torch.api import decompress as tdec
from tpu_zstd_torch.api import hybrid as thy
from tpu_zstd_torch.api import manager as tm
from tpu_zstd_torch.api import nvcomp as tnv
from tpu_zstd_torch.corpus import make_corpus
from tpu_zstd_torch.format import fse as tfse
from tpu_zstd_torch.format import frame as tframe
from tpu_zstd_torch.format import huffman as thuf
from tpu_zstd_torch.format import lz77 as tlz
from tpu_zstd_torch.format import sequences as tseq
from tpu_zstd_torch.format import xxhash as txxh
from tpu_zstd_torch.parallel import multihost as tmh
from tpu_zstd_torch.parallel import sharding as tsh
from tpu_zstd_torch.utils import native as tnat

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _check_enums_and_estimates():
    assert [(m.name, int(m)) for m in tc.ExecutionPath] == [
        (m.name, int(m)) for m in jc.ExecutionPath]
    for n in (0, 1, 1000, 131072, 131073, 5 << 20):
        assert tc.estimate_compressed_size(n) == jc.estimate_compressed_size(n)


def _check_host_encoder_stages():
    rng = np.random.default_rng(2027)
    ll = np.concatenate([np.arange(0, 70000, 7), rng.integers(0, 1 << 17, 500)])
    ml = ll + 3
    ob = ll + 1
    for fn in ("ll_code", "ml_code", "of_code"):
        arg = ml if fn == "ml_code" else ob if fn == "of_code" else ll
        assert np.array_equal(getattr(tconst, fn)(arg), getattr(jconst, fn)(arg)), fn
    for trial in range(40):
        n = int(rng.integers(2, 60))
        counts = rng.integers(0, 2000, n) * (rng.random(n) < 0.7)
        counts[rng.integers(0, n)] += 1
        counts[rng.integers(0, n)] += 1
        if (counts > 0).sum() < 2:
            continue
        total = int(counts.sum())
        log = tfse.optimal_table_log(0, total, n - 1)
        assert log == jfse.optimal_table_log(0, total, n - 1)
        norm = tfse.normalize_counts(counts, log, total)
        assert np.array_equal(norm, jfse.normalize_counts(counts, log, total)), trial
        assert tfse.write_ncount(norm, log) == jfse.write_ncount(norm, log), trial
    for data in (make_corpus(9000), bytes(rng.integers(0, 40, 3000, dtype=np.uint8)),
                 bytes(rng.integers(0, 256, 300, dtype=np.uint8)), b"ab" * 100):
        a, b = thuf.compress_literals(data), jhuf.compress_literals(data)
        assert (a is None) == (b is None) and (a is None or a[:2] == b[:2])
        kw = dict(hash_log=13, search_depth=6, min_match=4, lazy=True)
        seqs_t, rep_t = tlz.parse_block(data, [1, 4, 8], **kw)
        seqs_j, rep_j = jlz.parse_block(data, [1, 4, 8], **kw)
        assert rep_t == rep_j and (seqs_t is None) == (seqs_j is None)
        if seqs_t is not None:
            assert tseq.encode_sequences_section(seqs_t) == jseq.encode_sequences_section(seqs_j)


def _check_no_entry_point_runs_without_a_card():
    if torch.cuda.is_available():
        return
    for make in (tm.Manager, tm.BatchManager, lambda: tpu_zstd_torch.compress(b"abc"),
                 lambda: tpu_zstd_torch.decompress(b"abc"),
                 lambda: tdec.decompress_batch_tpu([b"abc"]), thy.HybridEngine,
                 lambda: tpu_zstd_torch.hybrid_compress(b"abc"),
                 lambda: tpu_zstd_torch.hybrid_decompress(b"abc"), tnv.NvcompV5BatchManager,
                 tsh.make_mesh, lambda: tmh.compress_batch_distributed([b"abc"])):
        with pytest.raises(RuntimeError):
            make()
    assert not tpu_zstd_torch.is_cuda_available()


def _check_decompress_batch_falls_through_only_before_device_work(monkeypatch):
    data = make_corpus(30000)
    good = tframe.compress(data, tframe.CompressParams(block_size=8192, checksum=True))
    bm = tm.BatchManager(level=3, device="cpu")
    # A frame that does not parse: the whole batch takes the host path.
    res = bm.decompress_batch([good, good[:100]], use_tpu=True)
    assert [it.status for it in res] == [tc.Status.SUCCESS, tc.Status.ERROR_CORRUPT_DATA]
    assert res[0].output == data and res[1].output is None
    # A checksum found wrong after the device decode propagates.
    with pytest.raises(ValueError, match="checksum"):
        bm.decompress_batch([good[:-1] + bytes([good[-1] ^ 1])], use_tpu=True)

    # A failure of the device half propagates: nothing falls back to the host.
    def fails(*a, **k):
        raise RuntimeError("kernel failed")

    with monkeypatch.context() as mp:
        mp.setattr(tdec, "decode_parsed", fails)
        with pytest.raises(RuntimeError, match="kernel failed"):
            bm.decompress_batch([good], use_tpu=True)


def _check_batch_entry_points():
    """compress_batch_async and the top-level compress_batch give
    compress_items' frames, which libzstd decodes; decompress_batch_to_device
    gives the prepared plan's rows."""
    items = [make_corpus(5000), b"", b"\x07" * 3000]
    cfg = dataclasses.replace(tc.CompressionConfig.from_level(1), block_size=16384)
    frames = tm.compress_items(items, cfg, device="cpu")
    bm = tm.BatchManager(config=cfg, device="cpu")
    assert [it.output for it in bm.compress_batch_async(items)()] == frames
    assert tpu_zstd_torch.compress_batch(items, level=1, device="cpu") == tm.compress_items(
        items, tc.CompressionConfig.from_level(1), device="cpu")
    dctx = zstandard.ZstdDecompressor()
    for f, d in zip(frames, items):
        assert dctx.decompress(f, max_output_size=max(len(d), 1)) == d
    out, lens = bm.decompress_batch_to_device(frames, 16384)
    ref_out, ref_lens = tdec.prepare_decompress_batch(frames, 16384, device="cpu").execute()
    assert torch.equal(lens, ref_lens) and torch.equal(out, ref_out)
    assert [bytes(out[k, : int(lens[k])].numpy()) for k in range(len(items))] == items


def _tree_digest(d: pathlib.Path) -> dict:
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest() for p in sorted(d.iterdir())}


def _check_native_runtime_builds_its_own_copies(monkeypatch, tmp_path):
    """The C++ copies equal the repository's csrc/; the library builds from
    them into the port's _build/ and never touches csrc/build/; a compiler
    that fails raises with its output; without a compiler the entry points
    take their pure-Python fallbacks."""
    for name in tnat.SOURCES:
        assert (tnat.SRC_DIR / name).read_bytes() == (ROOT / "csrc" / name).read_bytes(), name
    before = _tree_digest(ROOT / "csrc" / "build")
    assert tnat.get_native() is not None
    assert tnat.library_path().parent == ROOT / "tpu_zstd_torch" / "_build"
    with monkeypatch.context() as mp:  # a fresh build in a directory of its own
        mp.setattr(tnat, "BUILD_DIR", tmp_path / "build")
        mp.setattr(tnat, "_lib", None)
        mp.setattr(tnat, "_tried", False)
        lib = tnat.get_native()
        assert lib is not None and tnat.library_path().exists()
        assert tnat.xxh64(b"abc", 7) == txxh.xxh64(b"abc", 7)
    assert _tree_digest(ROOT / "csrc" / "build") == before, "the port's loader touched csrc/build"
    broken = tmp_path / "broken"
    broken.mkdir()
    for name in tnat.SOURCES:
        (broken / name).write_text("int broken(\n")
    with monkeypatch.context() as mp:
        mp.setattr(tnat, "SRC_DIR", broken)
        mp.setattr(tnat, "BUILD_DIR", tmp_path / "build_broken")
        mp.setattr(tnat, "_lib", None)
        mp.setattr(tnat, "_tried", False)
        with pytest.raises(RuntimeError, match=r"failed to build(?s:.*)int broken\("):
            tnat.get_native()
    with monkeypatch.context() as mp:
        mp.setattr(tnat, "BUILD_DIR", tmp_path / "build_none")
        mp.setattr(tnat, "find_compiler", lambda: None)
        mp.setattr(tnat, "_lib", None)
        mp.setattr(tnat, "_tried", False)
        assert tnat.get_native() is None and tnat.NativeEngine.create(3) is None
        data = make_corpus(9000)
        assert tnat.xxh64(data) == txxh.xxh64(data)
        assert tnat.xxh32(data, 5) == txxh.xxh32(data, 5)
        assert txxh.content_checksum(data) == txxh.xxh64(data) & 0xFFFFFFFF
        m = tm.Manager(level=3, device="cpu")
        frame = m.compress(data)
        assert frame == tframe.compress(data, tframe.CompressParams(
            level=3, hash_log=16, search_depth=8, min_match=4, lazy=True))
        assert tframe.decompress(frame) == data
        assert tnat.assemble_frames(np.zeros((1, 4), np.uint8), [0], [0], [0], [0], [1], [b"h"],
                                    None) is None
    lib = tnat.get_native()
    with monkeypatch.context() as mp:  # a loaded library that fails raises, never takes Python
        mp.setattr(lib, "tz_engine_compress", lambda *a: -1)
        mp.setattr(lib, "tz_assemble_frames", lambda *a: -1)
        with pytest.raises(RuntimeError, match="generic failure"):
            tm.host_compress(make_corpus(9000), tc.CompressionConfig.from_level(3))
        with pytest.raises(RuntimeError, match="tz_assemble_frames failed"):
            tnat.assemble_frames(np.zeros((1, 4), np.uint8), [0], [0], [0], [0], [1], [b"h"],
                                 None)


def _check_oom_ladder_reacts_to_oom_only(monkeypatch):
    """Another error propagates out of compress_batch (a message that
    speaks of memory too); an OOM splits; a single item that still runs out
    takes the native engine (HybridEngine forced to the CPU), counted in
    `host_fallbacks`."""
    items = [make_corpus(5000), b"\x07" * 3000]
    cfg = dataclasses.replace(tc.CompressionConfig.from_level(3), block_size=16384)
    orig = tm.compress_items

    def fails(exc):
        def run(its, *a, **k):
            raise exc
        return run

    for exc in (RuntimeError("kernel failed: CUDA error: out of memory"), ValueError("OOM")):
        bm = tm.BatchManager(config=cfg, device="cpu")
        with monkeypatch.context() as mp:
            mp.setattr(tm, "compress_items", fails(exc))
            with pytest.raises(type(exc)):
                bm.compress_batch(items)
        assert bm.degradations == 0 and bm.host_fallbacks == 0
    bm = tm.BatchManager(config=cfg, device="cpu")
    with monkeypatch.context() as mp:
        mp.setattr(tm, "compress_items", fails(torch.cuda.OutOfMemoryError("CUDA out of memory")))
        res = bm.compress_batch(items)
    assert bm.degradations == 3  # the pair, then each item
    assert bm.host_fallbacks == 2  # both items finished on the host
    for it, d in zip(res, items):
        assert it.output == tnat.NativeEngine.create(3).compress(d)
        assert it.status == tc.Status.SUCCESS
    def second_runs_out(its, *a, **k):
        if len(its) > 1 or its[0] is items[1]:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return orig(its, *a, **k)

    with monkeypatch.context() as mp:  # one item runs out: the other stays on the device path
        mp.setattr(tm, "compress_items", second_runs_out)
        bm = tm.BatchManager(config=cfg, device="cpu")
        res = bm.compress_batch(items)
    assert (bm.degradations, bm.host_fallbacks) == (2, 1)
    assert res[0].output == orig(items[:1], cfg, device="cpu")[0]
    assert res[1].output == tnat.NativeEngine.create(3).compress(items[1])


def _check_hybrid_decode_hides_no_device_error(monkeypatch):
    """HybridEngine forced to the card: a frame the host parse refuses goes
    to the host decoder; an error after the parse propagates, from the
    prepared plan, from decompress_batch_tpu's device half and from
    decompress_batch."""
    data = make_corpus(20000)
    cfg = dataclasses.replace(tc.CompressionConfig.from_level(3), block_size=16384)
    single, = tm.compress_items([data[:9000]], cfg, device="cpu")
    multi, = tm.compress_items([data], cfg, device="cpu")
    wide = torch_cases.rehead_wide(multi)
    eng = thy.HybridEngine(thy.HybridConfig(mode=thy.RoutingMode.FORCE_TPU), compression=cfg,
                           device="cpu")
    assert eng.decompress(single) == data[:9000] and eng.decompress(wide) == data
    res = thy.HybridResult()
    with pytest.raises(ValueError):
        eng.decompress(multi[:40], result=res)  # parse refused, then the host decoder fails
    assert eng.decompress_batch([single, wide]) == [data[:9000], data]

    def fails(*a, **k):
        raise RuntimeError("kernel failed")

    with monkeypatch.context() as mp:
        mp.setattr(tdec.DecompressPlan, "execute", fails)
        with pytest.raises(RuntimeError, match="kernel failed"):
            eng.decompress(single)
    with monkeypatch.context() as mp:
        mp.setattr(tdec, "decode_parsed", fails)
        with pytest.raises(RuntimeError, match="kernel failed"):
            eng.decompress(wide)
        with pytest.raises(RuntimeError, match="kernel failed"):
            eng.decompress_batch([single, wide])
    # A checksum found wrong after the device decode propagates too.
    ck, = tm.compress_items([data], dataclasses.replace(cfg, checksum=tc.ChecksumPolicy.COMPUTE),
                            device="cpu")
    with pytest.raises(ValueError, match="checksum"):
        eng.decompress_batch([ck[:-1] + bytes([ck[-1] ^ 1])])


def test_public_surface_matches_jax(monkeypatch, tmp_path):
    """One test item for the whole file."""
    _check_enums_and_estimates()
    _check_host_encoder_stages()
    _check_no_entry_point_runs_without_a_card()
    _check_decompress_batch_falls_through_only_before_device_work(monkeypatch)
    _check_batch_entry_points()
    _check_native_runtime_builds_its_own_copies(monkeypatch, tmp_path)
    _check_oom_ladder_reacts_to_oom_only(monkeypatch)
    _check_hybrid_decode_hides_no_device_error(monkeypatch)
    torch_cases.check_live("api")
    torch_cases.check_live("surface")
