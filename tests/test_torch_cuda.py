"""The port's CUDA kernels (K1-K4) against their plain PyTorch versions, on
a card. Skips without one: a CUDA kernel has no CPU mode. Integer outputs:
exact equality. (One test item, like the other tests/test_torch_*.py files.)
"""

import jax  # noqa: F401  (JAX stays on the CPU; see conftest.py)
import numpy as np
import pytest
import torch

from tpu_zstd_torch.ops import concat, greedy, rep, roll


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    rng = np.random.default_rng(0)
    dev = "cuda"
    for dtype in (np.uint8, np.int32, np.int64):
        x = _t(rng.integers(0, 120, (7, 3000)).astype(dtype)).to(dev)
        s = _t(rng.integers(0, 3000, 7)).to(dev)
        assert torch.equal(roll.roll_rows(x, s), roll.roll_rows_plain(x, s))
    W = 512
    off = rng.integers(0, W, (3, 8))
    cnt = rng.integers(0, W - off + 1)
    args = (_t(rng.integers(0, 1000, (3, 8, W)).astype(np.int32)).to(dev),
            _t(off.astype(np.int32)).to(dev), _t(cnt.astype(np.int32)).to(dev), 1024)
    assert torch.equal(concat.concat_varlen(*args), concat.concat_varlen_plain(*args))
    seg = 1024
    step = np.minimum(rng.integers(1, 30, (9, seg)), seg - np.arange(seg))
    m = (rng.random((9, seg)) < 0.5) & (step >= 4)
    packed = _t((step | m << 11).astype(np.int32)).to(dev)
    assert torch.equal(greedy.greedy_segments(packed), greedy.greedy_segments_plain(packed))
    p = _t((rng.integers(1, 6, (5, 700)) | 1 << 22).astype(np.int32)).to(dev)
    assert torch.equal(rep.rep_codes(p), rep.rep_codes_plain(p))
