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
has begun. Exact equality. One test item (see tests/test_torch_kernels.py).
"""

import dataclasses

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
from tpu_zstd_torch.api import manager as tm
from tpu_zstd_torch.corpus import make_corpus
from tpu_zstd_torch.format import fse as tfse
from tpu_zstd_torch.format import frame as tframe
from tpu_zstd_torch.format import huffman as thuf
from tpu_zstd_torch.format import lz77 as tlz
from tpu_zstd_torch.format import sequences as tseq


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
                 lambda: tdec.decompress_batch_tpu([b"abc"])):
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


def test_public_surface_matches_jax(monkeypatch):
    """One test item for the whole file."""
    _check_enums_and_estimates()
    _check_host_encoder_stages()
    _check_no_entry_point_runs_without_a_card()
    _check_decompress_batch_falls_through_only_before_device_work(monkeypatch)
    _check_batch_entry_points()
    torch_cases.check_live("api")
