"""The PyTorch port's kernels and bit packing against their JAX twins.

Each plain PyTorch version (what a kernel wrapper runs on a CPU tensor) gets
the same seeded numpy inputs as the JAX function the reference runs on the
CPU. All outputs are integers, so the tolerance is exact equality.

The checks run as ONE test item. With `--dist loadfile` the test runner
schedules files with more test items first; a file of one item is scheduled
after every file of the reference package's suite, so adding the port's
tests leaves that suite's schedule as it was. tests/test_torch_cuda.py holds
the CUDA kernels against these plain versions on a card. The seeded cases of
tests/torch_cases.py (group "kernels") also run through both packages here,
held against tests/golden/torch_cases.json: among them the plain versions
of K11 (deposit), K12 (row sort) and K13 (fused match finder) against the
Pallas kernels in interpret mode, at the reference tests' shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cases

from tpu_zstd.ops import bitpack as jbit
from tpu_zstd.ops.lz77_jax import greedy_parse as jax_greedy_parse
from tpu_zstd.ops.pallas_concat import concat_varlen as jax_concat_varlen
from tpu_zstd.ops.pallas_rep import rep_codes_scan
from tpu_zstd_torch.ops import bitpack, concat, deposit, greedy, match, rep, roll, sort


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


# --- K1 roll -------------------------------------------------------------------------


def _check_roll_plain_matches_jax_dynroll(dtype, width):
    rng = np.random.default_rng(width)
    info = np.iinfo(dtype)
    x = rng.integers(info.min, info.max, (5, width), dtype=dtype, endpoint=True)
    s = rng.integers(0, width + 1, 5)
    s[0] = 0
    ref = np.asarray(jbit.dynroll(jnp.asarray(x), jnp.asarray(s[:, None], jnp.int32), width))
    out = roll.roll_rows_plain(_t(x), _t(s)).numpy()
    np.testing.assert_array_equal(out, ref)  # exact: integer data
    # On a CPU tensor the wrapper and the port's dynroll take the plain version.
    np.testing.assert_array_equal(roll.roll_rows(_t(x), _t(s)).numpy(), ref)
    np.testing.assert_array_equal(bitpack.dynroll(_t(x), _t(s)).numpy(), ref)


def _check_dynroll_left_and_place_match_jax():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 256, (4, 512), dtype=np.uint8)
    s = np.array([0, 1, 511, 512])
    ref = np.stack([np.asarray(jbit.dynroll_left(jnp.asarray(x[i]), int(s[i]), 512)) for i in range(4)])
    np.testing.assert_array_equal(bitpack.dynroll_left(_t(x), _t(s)).numpy(), ref)
    length = np.array([0, 7, 300, 512])
    off = np.array([0, 3, 100, 600])
    for out_len in (400, 1024):
        ref = np.stack([
            np.asarray(jbit.place(jnp.asarray(x[i]), int(length[i]), int(off[i]), out_len, 1024))
            for i in range(4)
        ])
        got = bitpack.place(_t(x), _t(length), _t(off), out_len).numpy()
        np.testing.assert_array_equal(got, ref)


# --- K2 concat -----------------------------------------------------------------------


def _check_concat_plain_matches_pallas_interpret(out_len):
    """Against the Pallas kernel run in interpret mode on the CPU; out_len 384
    forces the clamp of counts at what is left of the output."""
    rng = np.random.default_rng(out_len)
    B, NW, W = 2, 4, 256
    x = rng.integers(0, 1 << 30, (B, NW, W), dtype=np.int32)
    off = rng.integers(0, W, (B, NW)).astype(np.int32)
    cnt = rng.integers(0, W - off + 1).astype(np.int32)
    cnt[0] = W - off[0]  # a full-width segment row
    ref = np.asarray(
        jax.vmap(lambda a, o, c: jax_concat_varlen(a, o, c, out_len))(
            jnp.asarray(x), jnp.asarray(off), jnp.asarray(cnt)
        )
    )
    out = concat.concat_varlen_plain(_t(x), _t(off), _t(cnt), out_len).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(concat.concat_varlen(_t(x), _t(off), _t(cnt), out_len).numpy(), ref)


# --- K3 greedy -----------------------------------------------------------------------


def _check_greedy_plain_matches_jax_scan(seg, nseg):
    rng = np.random.default_rng(seg)
    N = seg * nseg
    pos = np.arange(N)
    step = np.minimum(rng.integers(1, 40, N), seg - pos % seg).astype(np.int32)
    matched = (rng.random(N) < 0.4) & (step >= 4)
    defer = (rng.random(N) < 0.1) & matched
    ref_seq, ref_lit = jax_greedy_parse(
        jnp.asarray(step), jnp.asarray(matched), jnp.asarray(defer), seg=seg
    )
    packed = (step | matched.astype(np.int32) << 11 | defer.astype(np.int32) << 12).reshape(nseg, seg)
    out = greedy.greedy_segments_plain(_t(packed)).numpy().reshape(-1)
    np.testing.assert_array_equal((out & 1) == 1, np.asarray(ref_seq))
    np.testing.assert_array_equal((out & 2) == 2, np.asarray(ref_lit))


# --- K4 rep --------------------------------------------------------------------------


def _check_rep_plain_matches_rep_codes_scan():
    rng = np.random.default_rng(11)
    S, rows = 3, 600
    offs = np.where(rng.random((S, rows)) < 0.6, rng.integers(1, 5, (S, rows)),
                    rng.integers(1, 1 << 21, (S, rows)))
    has_lit = rng.integers(0, 2, (S, rows))
    nvalid = np.array([rows, 0, 377])
    valid = np.arange(rows)[None, :] < nvalid[:, None]
    packed = np.where(valid, offs | has_lit << 21 | 1 << 22, 0).astype(np.int32)
    ref = np.stack([np.asarray(rep_codes_scan(jnp.asarray(p))) for p in packed])
    np.testing.assert_array_equal(rep.rep_codes_plain(_t(packed)).numpy(), ref)
    np.testing.assert_array_equal(rep.rep_codes(_t(packed)).numpy(), ref)
    assert (ref[0] <= 3).any() and (ref[0] > 3).any()  # repcodes and spelled offsets


# --- bit deposit ---------------------------------------------------------------------


def _check_deposit_bits_matches_jax(M):
    """M < 4096 takes the scatter deposit, M >= 4096 the tree deposit."""
    rng = np.random.default_rng(M)
    B = 2
    vals = rng.integers(0, 1 << 32, (B, M), dtype=np.uint64)
    lens = rng.integers(0, 33, (B, M)).astype(np.int32)
    lens[:, ::7] = 0
    # Three words short: the scatter drops the last fields, the tree wraps them (as in JAX).
    num_words = int(lens.sum(1).max()) // 32 - 3
    dep = jax.jit(jbit.deposit_bits, static_argnums=(2,))
    ref = [dep(jnp.asarray(v.astype(np.uint32)), jnp.asarray(l), num_words)
           for v, l in zip(vals, lens)]
    words, total = bitpack.deposit_bits(_t(vals.astype(np.int64)), _t(lens), num_words)
    np.testing.assert_array_equal(words.numpy(), np.stack([np.asarray(w) for w, _ in ref]))
    np.testing.assert_array_equal(total.numpy(), [int(t) for _, t in ref])


def _check_shift_words_and_words_to_bytes_match_jax():
    rng = np.random.default_rng(5)
    w = rng.integers(0, 1 << 32, (3, 40), dtype=np.uint64)
    bit_off = np.array([0, 31, 517])
    ref = np.stack([np.asarray(jbit.shift_words(jnp.asarray(w[i].astype(np.uint32)), int(bit_off[i]), 64))
                    for i in range(3)])
    got = bitpack.shift_words(_t(w.astype(np.int64)), _t(bit_off), 64)
    np.testing.assert_array_equal(got.numpy(), ref)
    ref_b = np.stack([np.asarray(jbit.words_to_bytes(jnp.asarray(r))) for r in ref])
    np.testing.assert_array_equal(bitpack.words_to_bytes(got).numpy(), ref_b)


def _check_new_kernel_wrappers_refuse_bad_shapes():
    """K11-K13's wrappers raise where the TPU kernels assert."""
    with pytest.raises(ValueError, match="power of two"):
        sort.sort_rows(torch.zeros((2, 1536), dtype=torch.int32))
    with pytest.raises(ValueError, match="power of two"):
        match.match_windows(torch.zeros((2, 512), dtype=torch.int32), [], 2, 1 << 12)
    with pytest.raises(ValueError, match="depth"):
        match.match_windows(torch.zeros((2, 1024), dtype=torch.int32), [], 128, 1 << 12)
    z = torch.zeros((2, 200), dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 128"):
        deposit.deposit_bits_pallas(z, z, z, 64)
    assert deposit.padded_words(100) == 1024 and deposit.padded_words(1000) == 1536
    assert sort.sortable(1024) and not sort.sortable(3072)


def test_plain_kernels_and_bitpack_match_jax():
    """One test item for the whole file (see the module docstring)."""
    for dtype, width in [(np.uint8, 4096), (np.int32, 2048), (np.int32, 100)]:
        _check_roll_plain_matches_jax_dynroll(dtype, width)
    _check_dynroll_left_and_place_match_jax()
    for out_len in (1024, 384):
        _check_concat_plain_matches_pallas_interpret(out_len)
    for seg, nseg in [(512, 4), (1024, 3)]:
        _check_greedy_plain_matches_jax_scan(seg, nseg)
    _check_rep_plain_matches_rep_codes_scan()
    for M in (300, 5000):  # the scatter deposit, then the tree deposit
        _check_deposit_bits_matches_jax(M)
    _check_shift_words_and_words_to_bytes_match_jax()
    _check_new_kernel_wrappers_refuse_bad_shapes()
    torch_cases.check_live("kernels")
