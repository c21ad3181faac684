"""The port's optimal-parse slice (levels 7-22) against the live JAX package.

The seeded cases of tests/torch_cases.py, group "optimal" (min_match 3, the
near-offset band, the wide sort key, the search over the whole block, LDM,
the segment DP `opt_steps` at min_match 3 / cap 64 and at min_match 4 /
cap 16 with one bank per 16 rows, the optimal parse with and without the
overflow poison, `compress_items` frames at levels 7, 12, 19 and 22 at
16 KB blocks with the search trimmed, and a frame whose search and
extraction span the whole block) run through both packages and are held
against tests/golden/torch_cases.json; stock libzstd (`zstandard`) decodes
every frame. Then the full level-19 configuration through the port's
`BatchManager` on the CPU, where every kernel wrapper (K10's too) takes its
plain version, decoded by libzstd, and the window settings at level 19
(enable_ldm, a dictionary ID, history), which run since the cross-block
slice. Exact equality. One test item (see tests/test_torch_kernels.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch_cases
import zstandard

from tpu_zstd_torch.api import config as tc
from tpu_zstd_torch.api import manager as tm
from tpu_zstd_torch.corpus import make_corpus
from tpu_zstd_torch.format import frame as tframe
from tpu_zstd_torch.ops import _kernels


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _check_frames_decode(dctx):
    for name, c in torch_cases.CASES.items():
        if c.group == "optimal" and name.startswith("items_level"):
            items = c.inputs()["items"]
            out = c.port(c.inputs())
            frames = [out[f"frame{k}"] for k in range(len(items))]
            for f, d in zip(frames, items):
                assert dctx.decompress(f, max_output_size=max(len(d), 1)) == d, name


def _check_level19_on_cpu(dctx):
    """`BatchManager(level=19)` (128 KB blocks, depth 48, cap 64, 64 KB
    windows, LDM, the DP) on CPU tensors: no kernel launches."""
    rng = np.random.default_rng(19)
    items = [make_corpus(150000), b"", b"\x07" * 3000,
             rng.integers(0, 256, 2000, dtype=np.uint8).tobytes()]
    _kernels.reset_launches()
    res = tm.BatchManager(level=19, device="cpu").compress_batch(items)
    assert not any(_kernels.launches.values()), _kernels.launches
    for r, d in zip(res, items):
        assert dctx.decompress(r.output, max_output_size=max(len(d), 1)) == d


def _check_later_slices_raise():
    """enable_ldm, a dictionary ID and history at level 19 (16 KB blocks,
    the search trimmed) run on the CPU; their frames decode (the history
    frame with its history as a raw-content dictionary, the frame with a
    dictionary ID on the port's host decoder)."""
    cfg = torch_cases._opt_level_cfg(tc, 19)
    data = make_corpus(40000)
    dctx = zstandard.ZstdDecompressor()
    f_ldm, = tm.compress_items([data], dataclasses.replace(cfg, enable_ldm=True), device="cpu")
    assert dctx.decompress(f_ldm, max_output_size=len(data)) == data
    f_id, = tm.compress_items([data], dataclasses.replace(cfg, dict_id=7), device="cpu")
    assert tframe.parse_frame_header(f_id).dict_id == 7 and tframe.decompress(f_id) == data
    f_h, = tm.compress_items([data[20000:]], cfg, history=[data[:20000]], device="cpu")
    zd = zstandard.ZstdCompressionDict(data[:20000], dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    assert zstandard.ZstdDecompressor(dict_data=zd).decompress(
        f_h, max_output_size=20000) == data[20000:]


def test_optimal_parse_matches_jax():
    dctx = zstandard.ZstdDecompressor()
    torch_cases.check_live("optimal")
    _check_frames_decode(dctx)
    _check_level19_on_cpu(dctx)
    _check_later_slices_raise()
