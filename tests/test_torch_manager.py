"""The port's batch manager (tpu_zstd_torch/api) against the live JAX package
(tpu_zstd/api): the configuration copy and level table, `compress_items`
against `compress_items_tpu` at levels 1, 3 and 5 with and without checksum
(and the seeded cases of tests/torch_cases.py, group "manager"),
`BatchManager.compress_batch` frames and stats, the content checksum, the
decode_accel pipeline mapping for every level 1-22, and the window settings
(enable_ldm, dict_id, streaming history), which run on the CPU when asked
for it and need a card otherwise. Every port frame is decoded by stock
libzstd (`zstandard`; a frame with a dictionary ID by the port's host
decoder, since libzstd refuses an ID that no loaded dictionary carries).
Exact equality. One test item (see tests/test_torch_kernels.py).
"""

import dataclasses

import pytest
import torch
import torch_cases
import zstandard

from tpu_zstd.api import config as jc
from tpu_zstd.api import manager as jm
from tpu_zstd_torch.api import config as tc
from tpu_zstd_torch.api import manager as tm
from tpu_zstd_torch.corpus import make_corpus
from tpu_zstd_torch.format import frame as tframe


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _check_config_copy_and_level_table():
    for enum_name in ("Status", "Strategy", "ChecksumPolicy"):
        mine, ref = getattr(tc, enum_name), getattr(jc, enum_name)
        assert [(m.name, int(m)) for m in mine] == [(m.name, int(m)) for m in ref], enum_name
    for level in range(1, 23):
        ref = jc.CompressionConfig.from_level(level)
        mine = tm.compression_config_from_reference(dataclasses.asdict(ref))
        assert mine == tc.CompressionConfig.from_level(level), level
        assert mine.validate() == ref.validate()
        assert dataclasses.asdict(tm._pipeline_config(mine)) == dataclasses.asdict(
            jm._pipeline_config(ref)), level
        accel = dataclasses.replace(ref, decode_accel=True)
        assert dataclasses.asdict(tm._pipeline_config(
            tm.compression_config_from_reference(dataclasses.asdict(accel)))) == \
            dataclasses.asdict(jm._pipeline_config(accel)), level
    assert [tm._bucket(n) for n in (0, 1, 8, 9, 100)] == [jm._bucket(n) for n in (0, 1, 8, 9, 100)]
    with pytest.raises(ValueError):
        tm.compression_config_from_reference({"level": 3, "no_such_field": 1})


def _check_later_slices_raise():
    """Since the cross-block slice enable_ldm, dict_id and history run (the
    seeded cases of group "windows" hold their bytes against the JAX
    package); without a card every entry point raises unless asked for
    the CPU."""
    base = dataclasses.replace(tc.CompressionConfig.from_level(3), block_size=16384)
    data = make_corpus(40000)
    dctx = zstandard.ZstdDecompressor()
    f_ldm, = tm.compress_items([data], dataclasses.replace(base, enable_ldm=True), device="cpu")
    assert dctx.decompress(f_ldm, max_output_size=len(data)) == data
    f_id, = tm.compress_items([data], dataclasses.replace(base, dict_id=7), device="cpu")
    assert tframe.parse_frame_header(f_id).dict_id == 7
    assert tframe.decompress(f_id) == data
    f_h, = tm.compress_items([data[20000:]], base, history=[data[:20000]], device="cpu")
    zd = zstandard.ZstdCompressionDict(data[:20000], dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    assert zstandard.ZstdDecompressor(dict_data=zd).decompress(
        f_h, max_output_size=20000) == data[20000:]
    for level in (7, 19):
        tm.BatchManager(config=dataclasses.replace(
            tc.CompressionConfig.from_level(level), enable_ldm=True), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tm.BatchManager(level=3)  # device=None means CUDA
        with pytest.raises(RuntimeError):
            tm.compress_items([b"abc"], base)
        with pytest.raises(RuntimeError):
            tm.compress_items([b"abc"], base, history=[b""])
        with pytest.raises(RuntimeError):
            tm.StreamingManager(level=3)


def _check_batch_manager_matches_jax():
    cfg_ref = dataclasses.replace(jc.CompressionConfig.from_level(3), block_size=16384,
                                  checksum=jc.ChecksumPolicy.COMPUTE)
    cfg = tm.compression_config_from_reference(dataclasses.asdict(cfg_ref))
    items = [make_corpus(50000), b"", make_corpus(90000)[60000:], b"z" * 17000]
    ref_mgr = jm.BatchManager(config=cfg_ref)
    mgr = tm.BatchManager(config=cfg, device="cpu")
    ref = ref_mgr.compress_batch(items)
    mine = mgr.compress_batch([tm.BatchItem(d) for d in items])
    dctx = zstandard.ZstdDecompressor()
    for a, b, data in zip(mine, ref, items):
        assert a.output == b.output and a.status == tc.Status.SUCCESS
        assert dctx.decompress(a.output, max_output_size=max(len(data), 1)) == data
    for f in ("total_input_bytes", "total_output_bytes", "total_frames", "total_compress_calls"):
        assert getattr(mgr.stats, f) == getattr(ref_mgr.stats, f), f
    assert mgr.stats.ratio == ref_mgr.stats.ratio


def _check_items_match_jax(level, checksum):
    """compress_items at 16 KB blocks against compress_items_tpu: the items of
    the seeded manager case (empty, one repeated byte, random, multi-block)."""
    cfg_ref = dataclasses.replace(jc.CompressionConfig.from_level(level), block_size=16384,
                                  checksum=jc.ChecksumPolicy(checksum))
    cfg = tm.compression_config_from_reference(dataclasses.asdict(cfg_ref))
    items = torch_cases.CASES["items_level3_checksum"].inputs()["items"]
    mine = tm.compress_items(items, cfg, device="cpu")
    assert mine == jm.compress_items_tpu(items, cfg_ref), (level, checksum)
    dctx = zstandard.ZstdDecompressor()
    for frame, data in zip(mine, items):
        assert dctx.decompress(frame, max_output_size=max(len(data), 1)) == data


def test_manager_matches_jax():
    """One test item for the whole file."""
    _check_config_copy_and_level_table()
    _check_later_slices_raise()
    _check_batch_manager_matches_jax()
    torch_cases.check_live("manager")
    for level in (1, 3, 5):
        for checksum in (0, 1):
            _check_items_match_jax(level, checksum)
