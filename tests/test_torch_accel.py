"""The port's decode-checkpoint outputs and decode_accel frames against the
live JAX package.

`compress_items(..., decode_accel=True)` against `compress_items_tpu` at
DEFAULT_CONFIG level 3 with 16 KB and 32 KB blocks (checkpoints every 256
sequences and 1024 literal symbols, with and without checksum): the frames,
their trailing checkpoint frame included, are byte-identical; stock libzstd
(`zstandard`) decodes each (it stops at the real frame's end); the parsed
checkpoint records are equal in both packages. The seeded cases of
tests/torch_cases.py (group "accel": encode_prepared's sequence checkpoints
and the rep-triple prefix, the literal checkpoints, the sidecar writer and
parser, item frames) run through both packages and are held against
tests/golden/torch_cases.json. Exact equality. One test item (see
tests/test_torch_kernels.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cases
import zstandard

from tpu_zstd.api import config as jc
from tpu_zstd.api import manager as jm
from tpu_zstd.format import accel as ja
from tpu_zstd_torch.api import manager as tm
from tpu_zstd_torch.corpus import make_corpus
from tpu_zstd_torch.format import accel as ta
from tpu_zstd_torch.ops import pipeline as tp


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _check_settings_equal_reference():
    assert tm.ACCEL_STRIDE == jm.ACCEL_STRIDE
    assert (ta.SKIPPABLE_MAGIC, ta.ACCEL_TAG, ta.ACCEL_VERSION) == (
        ja.SKIPPABLE_MAGIC, ja.ACCEL_TAG, ja.ACCEL_VERSION)
    ref = dataclasses.replace(jc.CompressionConfig.from_level(3), decode_accel=True)
    mine = tm.compression_config_from_reference(dataclasses.asdict(ref))
    assert dataclasses.asdict(tm._pipeline_config(mine)) == dataclasses.asdict(
        jm._pipeline_config(ref))
    with pytest.raises(NotImplementedError):  # checkpoints come from the custom encoder
        tp.check_supported(dataclasses.replace(tp.SLICE_CONFIG, ckpt_every=256))
    # A checkpoint delta that does not fit in 16 bits raises instead of
    # wrapping (sequence bit positions, then a literal row); one that fits
    # is written as the reference writes it.
    e = np.empty(0, np.uint32)
    el = np.zeros((4, 0), np.uint32)

    def rec(bits):
        return [(300, np.array(bits, np.uint32), np.zeros((2, 3), np.uint32),
                 np.ones((2, 3), np.uint32), el)]

    assert ta.write_accel_frame(256, rec([65539, 4])) == ja.write_accel_frame(256, rec([65539, 4]))
    with pytest.raises(ValueError, match="sequence checkpoint delta 70000"):
        ta.write_accel_frame(256, rec([70004, 4]))
    lit = np.array([[90000, 5]] * 4, np.uint32)
    with pytest.raises(ValueError, match="literal checkpoint delta 89995"):
        ta.write_accel_frame(256, [(10, e, e, e, lit)], lit_stride=1024)


def _items(corpus, bs):
    """One block each (one JAX compile per block size): the conftest cases
    that fit, corpus slices with several sequence and literal chunks."""
    items = [d for d in corpus.values() if len(d) <= bs]
    base = make_corpus(3 * bs)
    return items + [base[:bs], base[bs : 2 * bs], base[2 * bs : 2 * bs + bs // 3]]


def _check_frames_identical(corpus, bs, checksum):
    ref_cfg = dataclasses.replace(jc.CompressionConfig.from_level(3), block_size=bs,
                                  decode_accel=True, checksum=jc.ChecksumPolicy(checksum))
    cfg = tm.compression_config_from_reference(dataclasses.asdict(ref_cfg))
    items = _items(corpus, bs)
    mine = tm.compress_items(items, cfg, device="cpu")
    ref = jm.compress_items_tpu(items, ref_cfg)
    dctx = zstandard.ZstdDecompressor()
    records = 0
    for k, (a, b, data) in enumerate(zip(mine, ref, items)):
        assert a == b, f"item {k} ({len(data)} bytes, {bs} B blocks): frame differs"
        assert dctx.decompress(a, max_output_size=max(len(data), 1)) == data
        (m1, e1), (m2, e2) = ta.parse_accel_tail(a), ja.parse_accel_tail(b)
        assert e1 == e2 and m1 is not None and len(m1.blocks) == len(m2.blocks) == 1
        for x, y in zip(m1.blocks[0], m2.blocks[0]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
        records += len(m1.blocks[0][1]) + m1.blocks[0][4].shape[1]
    assert records > 0  # sequence and literal checkpoints were written


def test_accel_frames_match_jax(corpus):
    """One test item for the whole file."""
    _check_settings_equal_reference()
    for bs, checksum in ((16384, 0), (32768, 1)):
        _check_frames_identical(corpus, bs, checksum)
    torch_cases.check_live("accel")
