"""The PyTorch port's LZ77 parse (ops/lz77.py) against the JAX reference.

Blocks come from the conftest corpus and a seeded mix; the JAX functions run
on the CPU (XLA paths), the port's on CPU tensors (plain kernel versions).
Outputs are integers: exact equality. 8 KB blocks with hash_log 13 and
mf_win_log 12 exercise both the windowed match search (2 windows) and the
windowed extraction (4 windows of 2 KB). The fused match route (the K13
path, plain version on the CPU) is held against the sort route. The seeded
parse cases of tests/torch_cases.py (the parse and `find_matches` with
`use_pallas_match`) also run through both packages, held against
tests/golden/torch_cases.json.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_cases

from tpu_zstd.ops import lz77_jax as jl
from tpu_zstd.ops.fse_jax import highbit32_jnp
from tpu_zstd_torch.ops import lz77 as tl
from tpu_zstd_torch.ops.fse import highbit32

N = 8192
KW = dict(hash_log=13, depth=8, cap=8, mf_win_log=12)
PARSE_KW = dict(max_seqs=N // 4, min_match=4, lazy=True, seg_log=10, of_gate=(8, 12), **KW)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _batch(corpus):
    """(B, N) uint8 blocks + lengths: corpus cases, a short block, a seeded
    byte mix with repeats at many offsets, and an all-zero tail block."""
    rng = np.random.default_rng(0x5EED)
    mix = rng.integers(0, 256, N, dtype=np.uint8)
    for _ in range(60):
        src, dst, ln = rng.integers(0, N - 300), rng.integers(0, N - 300), rng.integers(4, 300)
        mix[dst:dst + ln] = mix[src:src + ln]
    datas = [corpus["text"][:N], corpus["mixed"], corpus["multiblock"][:N],
             corpus["low_entropy"], mix.tobytes(), b"abcd" * 5]
    blocks = np.zeros((len(datas), N), np.uint8)
    lengths = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        blocks[i, : len(d)] = np.frombuffer(d, np.uint8)
        lengths[i] = len(d)
    return blocks, lengths


def _check_hash_words_wrap_like_u32():
    """The Fibonacci hash wraps at 32 bits in the port's int64 arithmetic
    exactly as the JAX u32 product does (high-bit words included)."""
    rng = np.random.default_rng(1)
    block = rng.integers(0, 256, 4096, dtype=np.uint8)
    block[:8] = 0xFF
    w_ref, h_ref = jl._hash_words(jnp.asarray(block), 17)
    w, h = tl._hash_words(torch.from_numpy(block)[None], 17)
    np.testing.assert_array_equal(w[0].numpy(), np.asarray(w_ref).astype(np.int64))
    np.testing.assert_array_equal(h[0].numpy(), np.asarray(h_ref))


def _check_highbit32_matches_jax():
    v = np.array([1, 2, 3, 255, 256, 65535, 65536, (1 << 21) + 3, (1 << 31) + 5, (1 << 32) - 1],
                 dtype=np.int64)
    ref = np.asarray(highbit32_jnp(jnp.asarray(v.astype(np.uint32))))
    np.testing.assert_array_equal(highbit32(torch.from_numpy(v)).numpy(), ref)


def _check_find_matches_matches_jax(batch):
    blocks, lengths = batch
    ref = jax.jit(jax.vmap(lambda b, n: jl.find_matches(b, n, **KW)))(
        jnp.asarray(blocks), jnp.asarray(lengths)
    )
    ml, off = tl.find_matches(torch.from_numpy(blocks), torch.from_numpy(lengths), **KW)
    np.testing.assert_array_equal(ml.numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(off.numpy(), np.asarray(ref[1]))
    assert (ml.numpy() >= 4).sum() > 1000  # the batch really has matches


def _check_parse_block_matches_jax_field_for_field(batch):
    blocks, lengths = batch
    ref = jax.jit(jax.vmap(lambda b, n: jl.parse_block(b, n, **PARSE_KW)))(
        jnp.asarray(blocks), jnp.asarray(lengths)
    )
    got = tl.parse_block(torch.from_numpy(blocks), torch.from_numpy(lengths), **PARSE_KW)
    nseq = np.asarray(ref.nseq)
    np.testing.assert_array_equal(got.nseq.numpy(), nseq)
    np.testing.assert_array_equal(got.nlit.numpy(), np.asarray(ref.nlit))
    for field in ("ll", "ml", "ob", "off", "starts"):
        a, b = getattr(got, field).numpy(), np.asarray(getattr(ref, field))
        for i, n in enumerate(nseq):
            np.testing.assert_array_equal(a[i, :n], b[i, :n], err_msg=f"{field} block {i}")
            assert not a[i, n:].any(), f"{field} block {i}: rows past nseq must be zero"
    lits_ref = np.asarray(ref.lits)
    for i, n in enumerate(np.asarray(ref.nlit)):
        np.testing.assert_array_equal(got.lits.numpy()[i, :n], lits_ref[i, :n])
    assert (got.ob.numpy()[got.ob.numpy() > 0] <= 3).any()  # repcodes occur


def _check_greedy_parse_matches_jax(lazy):
    rng = np.random.default_rng(int(lazy))
    seg, nseg = 1024, 4
    pos = np.arange(seg * nseg)
    ml_t = np.minimum(rng.integers(0, 9, seg * nseg), seg - pos % seg)
    matched = ml_t >= 4
    step = np.where(matched, ml_t, 1).astype(np.int32)
    defer = None
    if lazy:
        nxt_ml = np.append(ml_t[1:], 0)
        nxt_m = np.append(matched[1:], False)
        defer = matched & nxt_m & (nxt_ml > ml_t + 1)
    ref = jl.greedy_parse(jnp.asarray(step), jnp.asarray(matched),
                          None if defer is None else jnp.asarray(defer), seg=seg)
    got = tl.greedy_parse(torch.from_numpy(step)[None], torch.from_numpy(matched)[None],
                          None if defer is None else torch.from_numpy(defer)[None], seg)
    np.testing.assert_array_equal(got[0][0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[1][0].numpy(), np.asarray(ref[1]))


def _check_fused_route_equals_sort_route(batch):
    """The fused route (find_matches_fused: the K13 path with its plain
    version on the CPU) equals the sort route at every live position and is
    0 at dead ones; on the CPU, use_pallas_match with two_band returns the
    sort route's four outputs, as the JAX package's find_matches does."""
    blocks, lengths = (torch.from_numpy(a) for a in batch)
    kw = dict(hash_log=13, depth=8, cap=16, mf_win_log=10)
    ml, off = tl.find_matches(blocks, lengths, **kw)
    fml, foff = tl.find_matches_fused(blocks, lengths, **kw)
    live = torch.arange(N) < lengths.to(torch.int64)[:, None] - 3
    assert torch.equal(torch.where(live, fml, 0), torch.where(live, ml, 0))
    assert torch.equal(torch.where(live, foff, 0), torch.where(live, off, 0))
    assert not fml[~live].any() and not foff[~live].any()
    assert (fml >= 4).sum() > 1000
    both = tl.find_matches(blocks, lengths, use_pallas_match=True, two_band=True, **kw)
    want = tl.find_matches(blocks, lengths, two_band=True, **kw)
    assert len(both) == 4 and all(torch.equal(a, b) for a, b in zip(both, want))
    with pytest.raises(ValueError, match="mf_win_log"):
        tl.find_matches_fused(blocks, lengths, hash_log=17, depth=2, cap=8, mf_win_log=14)


def test_parse_matches_jax(corpus):
    """One test item for the whole file (see tests/test_torch_kernels.py)."""
    batch = _batch(corpus)
    _check_hash_words_wrap_like_u32()
    _check_highbit32_matches_jax()
    _check_find_matches_matches_jax(batch)
    _check_parse_block_matches_jax_field_for_field(batch)
    for lazy in (False, True):
        _check_greedy_parse_matches_jax(lazy)
    _check_fused_route_equals_sort_route(batch)
    torch_cases.check_live("parse")
