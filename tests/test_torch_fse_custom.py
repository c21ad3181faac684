"""The port's custom-table sequence encode (ops/fse_tables.py, ops/chain.py,
ops/fse.py `prepare_sequences_auto` / `encode_prepared`) against the live
JAX package (tpu_zstd/ops/fse_tables_jax.py, fse_jax.py).

Integer outputs: exact equality; the state chains on their live range
(1 <= t < nseq, and the flush state). The seeded cases of
tests/torch_cases.py (group "fse_custom") run through both packages and
are held against tests/golden/torch_cases.json; further checks here cover
each table choice (RLE, predefined, custom) and nseq of 0, 1, 2, a chunk
edge and the bucket edge. One test item (see tests/test_torch_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cases

from tpu_zstd.constants import SEQ_FSE, SEQ_PREDEFINED, SEQ_RLE
from tpu_zstd.ops import fse_jax as jf
from tpu_zstd.ops import fse_tables_jax as jt
from tpu_zstd_torch.ops import chain, fse
from tpu_zstd_torch.ops import fse_tables as tt


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _check_stream_specs_equal_reference():
    for mine, ref in zip(tt.stream_specs(), jt.stream_specs()):
        assert (mine.nsym, mine.pred_log) == (ref.nsym, ref.pred_log)
        for attr in ("pred_next", "pred_nb", "pred_init", "pred_dnb", "pred_dfs", "pred_st",
                     "pred_cost_q8", "pred_valid_mask"):
            np.testing.assert_array_equal(getattr(mine, attr), getattr(ref, attr), err_msg=attr)
    for name in ("TL", "TS", "STEP", "NSYM_LL", "NSYM_OF", "NSYM_ML"):
        assert getattr(tt, name) == getattr(jt, name), name
    np.testing.assert_array_equal(tt.SPREAD_INV, jt.SPREAD_INV)
    np.testing.assert_array_equal(tt.LOG2_Q8, jt.LOG2_Q8)
    assert [tt.desc_cap(n) for n in (13, 32, 36, 53)] == [jt.desc_cap(n) for n in (13, 32, 36, 53)]


def _check_cases_cover_every_table_choice():
    modes = set()
    for s in ("ll", "of", "ml"):
        c = torch_cases.CASES[f"choose_tables_{s}"]
        modes |= set(c.port(c.inputs())["mode"].tolist())
    assert modes == {SEQ_RLE, SEQ_PREDEFINED, SEQ_FSE}
    c = torch_cases.CASES["prepare_sequences_auto"]
    i = c.inputs()
    assert {0, 1, 2, i["ms"]} <= set(i["nseq"].tolist())
    assert (c.port(i)["mode3"] == SEQ_RLE).any()


def _check_histogram_matches_jax():
    rng = np.random.default_rng(3)
    codes = rng.integers(-2, 60, (4, 700)).astype(np.int32)
    nvalid = np.array([700, 0, 1, 333])
    for nsym in (13, 36, 53):
        ref = jax.vmap(lambda c, n: jt.histogram_codes(c, n, nsym))(
            jnp.asarray(codes), jnp.asarray(nvalid, jnp.int32))
        got = tt.histogram_codes(torch.from_numpy(codes), torch.from_numpy(nvalid), nsym)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _check_chain_wrapper_takes_plain_version_on_cpu():
    c = torch_cases.CASES["chain_sequences"]
    i = c.inputs()
    keys = ("st", "dnb", "dfs", "init", "tl", "rle", "rsym", "nseq")
    args = [torch.from_numpy(np.ascontiguousarray(i[k])) for k in keys]
    for a, b in zip(chain.state_chain3(*args), chain.state_chain3_plain(*args)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        chain.state_chain3_plain(*args[:6], args[6][:, :1000], args[7])  # msb % 128 != 0


def _check_encode_prepared_bucket_slice():
    """prepare at the full width, encode at a smaller bucket (as the staged
    pipeline does), against the JAX package."""
    c = torch_cases.CASES["prepare_sequences_auto"]
    i = c.inputs()
    ms, msb = int(i["ms"]), 512
    nseq = np.minimum(i["nseq"], msb)
    live = np.arange(ms)[None, :] < nseq[:, None]
    ll, ml, ob = (np.where(live, i[k], 0).astype(np.int32) for k in ("ll", "ml", "ob"))
    cap = -(-((msb * 40) // 8 + 1024) // 4096) * 4096
    ref = jax.vmap(lambda a, b, e, n: jf.encode_prepared(
        jf.prepare_sequences_auto(a[:msb], b[:msb], e[:msb], n, msb), n, msb, cap))(
        jnp.asarray(ll), jnp.asarray(ml), jnp.asarray(ob), jnp.asarray(nseq, jnp.int32))
    t = torch.from_numpy
    prep = fse.prepare_sequences_auto(t(ll)[:, :msb], t(ml)[:, :msb], t(ob)[:, :msb], t(nseq), msb)
    out, n = fse.encode_prepared(prep, t(nseq), msb, cap)
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref[0]))


def test_custom_fse_matches_jax():
    """One test item for the whole file."""
    _check_stream_specs_equal_reference()
    _check_cases_cover_every_table_choice()
    _check_histogram_matches_jax()
    _check_chain_wrapper_takes_plain_version_on_cpu()
    _check_encode_prepared_bucket_slice()
    torch_cases.check_live("fse_custom")
