"""The port's CUDA kernels (K1-K5) against their plain PyTorch versions, on
a card, and a DEFAULT_CONFIG frame made on the card against the one made on
the CPU. Skips without one: a CUDA kernel has no CPU mode. Integer outputs:
exact equality; the K5 state chains on their live range. (One test item,
like the other tests/test_torch_*.py files.)
"""

import jax  # noqa: F401  (JAX stays on the CPU; see conftest.py)
import numpy as np
import pytest
import torch
import torch_cases

from tpu_zstd_torch.corpus import make_corpus
from tpu_zstd_torch.ops import chain, concat, greedy, pipeline, rep, roll


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
    for name in ("chain_sequences", "chain_weights"):
        i = torch_cases.CASES[name].inputs()
        keys = ("st", "dnb", "dfs", "init", "tl", "rle", "rsym", "nseq")
        args = [_t(i[k]).to(dev) for k in keys]
        got = torch_cases._chain_live(*(x.cpu() for x in chain.state_chain3(*args)), i["nseq"])
        want = torch_cases._chain_live(*(x.cpu() for x in chain.state_chain3_plain(*args)),
                                       i["nseq"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    cfg = pipeline.PipelineConfig(block_size=16384, hash_log=13, mf_win_log=12)
    data = make_corpus(5 * 16384)
    assert pipeline.compress(data, cfg, True, device=dev) == pipeline.compress(
        data, cfg, True, device="cpu")
