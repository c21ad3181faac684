"""The port's cross-block windows against the live JAX package: the seeded
cases of tests/torch_cases.py, group "windows" (`find_matches` and
`find_matches_long` with a window prefix, the parse with a dictionary
window, the payload-only LDM mode, sampled positions and the decode-tuned
minimum length, `compress_items` with enable_ldm and with history at levels
3 and 19, `StreamingManager`, `train_dictionary` and `compress_with_dict`),
held against tests/golden/torch_cases.json as well.

Then the one place the port differs from the reference by design: the JAX
package's search over the whole row packs each best offset into 20 bits
(`find_matches`, the restore of its non-windowed branch), so behind a 1 MiB
history (window_log 20) an offset past 2^20 keeps only its low bits and
the frame decodes to other bytes. The port leaves such a position without
a match: where the JAX frame decodes (offsets of exactly 2^20, which the
JAX package drops as offset 0) the two frames are the same bytes, and
where it does not, the port's frame decodes to its input. Stock libzstd
(`zstandard`) decodes every frame. One test item (see
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
from tpu_zstd_torch.api import manager as tm


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _check_window_log_20_offsets():
    """Two blocks behind the same 1 MiB history (random bytes), as
    StreamingManager(window_log=20) hands them to compress_items: the first
    repeats the history's first 64 KB (offset 2^20 exactly) before 64 KB of
    random bytes; the second does the same, then puts 32 KB of random bytes
    and the history's next 32 KB (offsets 2^20 + 32 KB: past the JAX
    package's 20-bit field). libzstd decodes each frame with the history as
    a raw-content dictionary."""
    rng = np.random.default_rng(2020)
    hist = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    items = [hist[:65536] + rng.integers(0, 256, 65536, dtype=np.uint8).tobytes(),
             hist[:65536] + rng.integers(0, 256, 32768, dtype=np.uint8).tobytes()
             + hist[65536:98304]]
    jcfg = dataclasses.replace(jc.CompressionConfig.from_level(3), window_log=20)
    cfg = tm.compression_config_from_reference(dataclasses.asdict(jcfg))
    mine = tm.compress_items(items, cfg, history=[hist, hist], device="cpu")
    ref = jm.compress_items_tpu(items, jcfg, history=[hist, hist])
    dctx = zstandard.ZstdDecompressor(dict_data=zstandard.ZstdCompressionDict(
        hist, dict_type=zstandard.DICT_TYPE_RAWCONTENT))
    for f, d in zip(mine, items):
        assert dctx.decompress(f, max_output_size=len(d)) == d
    assert mine[0] == ref[0]
    assert dctx.decompress(ref[0], max_output_size=len(items[0])) == items[0]
    assert mine[1] != ref[1]
    try:
        jax_ok = dctx.decompress(ref[1], max_output_size=len(items[1])) == items[1]
    except zstandard.ZstdError:
        jax_ok = False
    assert not jax_ok


def test_windows_match_jax():
    torch_cases.check_live("windows")
    _check_window_log_20_offsets()
