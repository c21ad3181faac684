"""The PyTorch port's predefined-table sequence encode (ops/fse.py) against
the JAX reference (tpu_zstd/ops/fse_jax.py), plus the port's copies of the
RFC tables. Integer outputs: exact equality. The seeded predefined-encode
case of tests/torch_cases.py also runs through both packages, held against
tests/golden/torch_cases.json."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cases

from tpu_zstd import constants as jc
from tpu_zstd.ops import fse_jax as jf
from tpu_zstd_torch import constants as tc
from tpu_zstd_torch.ops import fse as tf


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _check_constants_equal_reference():
    for name in ("ZSTD_MAGIC", "BLOCK_SIZE_MAX", "BLOCK_RAW", "BLOCK_RLE", "BLOCK_COMPRESSED",
                 "SEQ_PREDEFINED", "SEQ_RLE", "SEQ_FSE",
                 "LL_DELTA_CODE", "ML_DELTA_CODE", "LL_DEFAULT_LOG", "ML_DEFAULT_LOG",
                 "OF_DEFAULT_LOG"):
        assert getattr(tc, name) == getattr(jc, name), name
    for name in ("LL_BASELINE", "LL_BITS", "ML_BASELINE", "ML_BITS", "LL_CODE_TABLE",
                 "ML_CODE_TABLE", "LL_DEFAULT_NORM", "ML_DEFAULT_NORM", "OF_DEFAULT_NORM"):
        np.testing.assert_array_equal(getattr(tc, name), getattr(jc, name), err_msg=name)


def _check_predefined_enc_tables_equal_reference():
    for mine, ref in zip(tf.predefined_enc_tables(), jf.predefined_enc_tables()):
        assert (mine.table_log, mine.table_size, mine.num_symbols) == (
            ref.table_log, ref.table_size, ref.num_symbols)
        for attr in ("next2d", "nb2d", "init_state", "dnb", "dfs", "state_table"):
            np.testing.assert_array_equal(getattr(mine, attr), getattr(ref, attr), err_msg=attr)


def _check_code_mapping_matches_jax():
    v = np.concatenate([np.arange(0, 300), [1000, 4095, 65535, 65536, 131072, (1 << 21) + 3]])
    t = torch.from_numpy(v.astype(np.int64))
    j = jnp.asarray(v.astype(np.int32))
    np.testing.assert_array_equal(tf.ll_code(t).numpy(), np.asarray(jf.ll_code_jnp(j)))
    # ml below 3 (rows past nseq) maps through the table's zero as in JAX.
    np.testing.assert_array_equal(tf.ml_code(t).numpy(), np.asarray(jf.ml_code_jnp(j)))
    np.testing.assert_array_equal(tf.of_code(t).numpy(), np.asarray(jf.of_code_jnp(j)))


def _check_state_chain_matches_jax():
    rng = np.random.default_rng(4)
    ms, B = 512, 3
    tabs = tf.predefined_enc_tables()
    nseq = np.array([ms, 0, 200])
    rsym = np.stack([rng.integers(0, t.num_symbols, (B, ms)) for t in tabs])
    pre, fin = tf._state_chain(torch.from_numpy(rsym), torch.from_numpy(nseq), ms)
    for s, tab in enumerate(jf.predefined_enc_tables()):
        for b in range(B):
            rp, rf = jf._state_chain(tab, jnp.asarray(rsym[s, b], jnp.int32), int(nseq[b]), ms)
            n = int(nseq[b])
            np.testing.assert_array_equal(pre[s, b, 1:n].numpy(), np.asarray(rp)[1:n])
            if n:
                assert int(fin[s, b]) == int(rf)


def _random_sequences(rng, B, ms, nseq):
    """Sequences with literal/match lengths and offsets across every code
    range, including repcode offset-base values 1..3."""
    ll = np.where(rng.random((B, ms)) < 0.9, rng.integers(0, 40, (B, ms)),
                  rng.integers(0, 70000, (B, ms)))
    ml = np.where(rng.random((B, ms)) < 0.9, rng.integers(4, 40, (B, ms)),
                  rng.integers(4, 70000, (B, ms)))
    ob = np.where(rng.random((B, ms)) < 0.3, rng.integers(1, 4, (B, ms)),
                  rng.integers(4, (1 << 21) + 3, (B, ms)))
    live = np.arange(ms)[None, :] < nseq[:, None]
    return [np.where(live, a, 0).astype(np.int32) for a in (ll, ml, ob)]


def _check_encode_sequences_predefined_matches_jax(ms, nseq):
    """ms 2048 takes the tree deposit, ms 1024 the scatter deposit; nseq
    covers the empty, 1-byte and 2-byte section headers."""
    rng = np.random.default_rng(ms)
    nseq = np.asarray(nseq)
    B = len(nseq)
    cap = -(-((ms * 40) // 8 + 1024) // 4096) * 4096
    ll, ml, ob = _random_sequences(rng, B, ms, nseq)
    enc = jax.jit(jax.vmap(lambda a, b, c, n: jf.encode_sequences_predefined(a, b, c, n, ms, cap)))
    ref_bytes, ref_len = enc(jnp.asarray(ll), jnp.asarray(ml), jnp.asarray(ob), jnp.asarray(nseq, jnp.int32))
    out, out_len = tf.encode_sequences_predefined(
        torch.from_numpy(ll), torch.from_numpy(ml), torch.from_numpy(ob),
        torch.from_numpy(nseq), ms, cap,
    )
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_bytes))


def test_fse_matches_jax():
    """One test item for the whole file (see tests/test_torch_kernels.py)."""
    _check_constants_equal_reference()
    _check_predefined_enc_tables_equal_reference()
    _check_code_mapping_matches_jax()
    _check_state_chain_matches_jax()
    for ms, nseq in [(2048, [2048, 0, 1, 127, 128, 1500]), (1024, [1024, 300])]:
        _check_encode_sequences_predefined_matches_jax(ms, nseq)
    torch_cases.check_live("fse")
