"""The port's Huffman literals (ops/huffman.py) and DEFAULT_CONFIG frames
(ops/pipeline.py) against the live JAX package.

The seeded cases of tests/torch_cases.py (group "huffman": every Huffman
stage over literal rows with more than 128 distinct symbols, nlit < 16, one
repeated byte and 11-bit codes; the compressed-literals header; frames at
8-16 KB blocks with and without checksum) run through both packages and are
held against tests/golden/torch_cases.json. Further: the conftest corpus
through `compress` at DEFAULT_CONFIG with 16 KB blocks, every port frame
decoded by stock libzstd (`zstandard`). Exact equality. One test item (see
tests/test_torch_kernels.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cases
import zstandard

from tpu_zstd.ops import huffman_jax as jh
from tpu_zstd.ops import pipeline as jp
from tpu_zstd_torch.ops import huffman as th
from tpu_zstd_torch.ops import pipeline as tp

JAX_CFG = jp.PipelineConfig(block_size=16384, hash_log=13, mf_win_log=12)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _check_constants_equal_reference():
    assert (th.MAX_BITS, th.WEIGHT_CAP) == (jh.MAX_BITS, jh.WEIGHT_CAP)
    for bs in (1024, 8192, 16384, 131072):
        assert th.huff_payload_cap(bs) == jh.huff_payload_cap(bs)


def _check_cases_cover_the_weight_forms():
    """Both weight encodings are emitted, and the nlit < 16 and one-symbol
    rows keep raw literals."""
    c = torch_cases.CASES["huffman_literals"]
    i = c.inputs()
    lits, nlit = torch.from_numpy(i["lits"]), torch.from_numpy(i["nlit"])
    lengths, _ = th.build_lengths(th.literal_histogram(lits, nlit), nlit)
    _, _, ok_w = th.weights_header(lengths)
    _, _, ok_f = th.weights_fse_payload(lengths)
    assert (ok_f & ~ok_w).any() and ok_w.any()  # FSE-only (> 128 weights) and direct
    ok = c.port(i)["ok"].numpy()
    assert not ok[4] and not ok[5] and ok[0] and ok[1]


def _check_corpus_frames_identical_to_jax(corpus):
    tcfg = tp.config_from_reference(dataclasses.asdict(JAX_CFG))
    assert tcfg == dataclasses.replace(tp.DEFAULT_CONFIG, block_size=16384, hash_log=13,
                                       mf_win_log=12)
    dctx = zstandard.ZstdDecompressor()
    for name, data in corpus.items():
        if len(data) > 16384:
            continue  # one block each: one JAX compile for all of them
        for checksum in (False, True):
            mine = tp.compress(data, tcfg, checksum=checksum, device="cpu")
            assert mine == jp.compress(data, JAX_CFG, checksum=checksum), name
            assert dctx.decompress(mine, max_output_size=max(len(data), 1)) == data, name


def test_huffman_and_default_frames_match_jax(corpus):
    """One test item for the whole file."""
    _check_constants_equal_reference()
    _check_cases_cover_the_weight_forms()
    _check_corpus_frames_identical_to_jax(corpus)
    torch_cases.check_live("huffman")
    dctx = zstandard.ZstdDecompressor()
    for name in ("frame_default_8k", "frame_default_16k", "frame_default_16k_checksum"):
        c = torch_cases.CASES[name]
        i = c.inputs()
        frame = c.port(i)["frame"]
        assert dctx.decompress(frame, max_output_size=len(i["data"])) == i["data"]
        assert np.frombuffer(frame[:4], "<u4")[0] == 0xFD2FB528
