"""The port's CUDA kernels (K1-K13) against their plain PyTorch versions, on
a card, a DEFAULT_CONFIG frame and an optimal-parse (level 19, trimmed
search) frame made on the card against the ones made on the CPU, the decode
of decode_accel frames on the card against the input, and the fused match
route (K13) against the CPU's, also with two_band and with 64 KB windows; K7
also on its hard inputs (tests/torch_cases.py seq_hard_inputs, and with
scrambled records) with its final rep triple, K12 also past one CTA's
width, K12 and K13 also on their hard sets (SORT_HARD, MATCH_HARD) at
widths 1024, 8192, 16384 and 65536, K3 and K5 also on their hard inputs
(greedy_hard_packed, chain_hard_inputs, chain_garbage_inputs), K2 also
through its fused entry on the hard operands of concat_fused_hard, the
multi-block decode plan on the golden multi-block frames
(decompress_multiblock), `decompress_batch_tpu` on its seeded batch
against the CPU's, the cross-block window paths against the CPU's (the
window parse cases, `compress_items` with enable_ldm and with history, the
streaming compressor, `compress_with_dict`), K10 also on
the calls of opt_card_calls (its hard calls, OPT_HARD and OPT_HARD_WIDE:
every row kind at 16397 x 1024, seg 1, 33, 1000 and 4096, cap 127 at mm
32, mm = cap; OPT_FAST_WIDE, every row of which must take the fast path;
seeded rows; rows that offer every length), `HybridEngine`'s routes on the
card (the case hybrid_routes; a CUDA tensor is DEVICE and compresses on the
card) and `compress_blocks_sharded` in an NCCL group of one rank, each
against the CPU's output. Skips
without one: a CUDA kernel has no CPU mode. Integer outputs: exact
equality; the K5 state chains on their live range, the decode kernels
up to nsym, nseq and out_len. (One test item, like the other
tests/test_torch_*.py files.)
"""

import jax  # noqa: F401  (JAX stays on the CPU; see conftest.py)
import numpy as np
import pytest
import torch
import torch_cases

from tpu_zstd_torch import dictionary
from tpu_zstd_torch.api import config, decompress, manager
from tpu_zstd_torch.corpus import make_corpus
from tpu_zstd_torch.ops import (
    _kernels, chain, concat, decode, decode_lanes, deposit, greedy, lz77, match, opt, pipeline,
    rep, roll, sort,
)
from tpu_zstd_torch.ops import exec as execmod


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
    for k, (dtype, rows, width) in enumerate(torch_cases.ROLL_HARD):  # K1's hard rows
        x, s = (_t(a).to(dev) for a in torch_cases.roll_hard_rows(k, dtype, rows, width))
        assert torch.equal(roll.roll_rows(x, s), roll.roll_rows_plain(x, s)), (dtype, width)
    W = 512
    off = rng.integers(0, W, (3, 8))
    cnt = rng.integers(0, W - off + 1)
    args = (_t(rng.integers(0, 1000, (3, 8, W)).astype(np.int32)).to(dev),
            _t(off.astype(np.int32)).to(dev), _t(cnt.astype(np.int32)).to(dev), 1024)
    assert torch.equal(concat.concat_varlen(*args), concat.concat_varlen_plain(*args))
    _check_concat_fused(dev)
    seg = 1024
    step = np.minimum(rng.integers(1, 30, (9, seg)), seg - np.arange(seg))
    m = (rng.random((9, seg)) < 0.5) & (step >= 4)
    packed = _t((step | m << 11).astype(np.int32)).to(dev)
    assert torch.equal(greedy.greedy_segments(packed), greedy.greedy_segments_plain(packed))
    p = _t((rng.integers(1, 6, (5, 700)) | 1 << 22).astype(np.int32)).to(dev)
    assert torch.equal(rep.rep_codes(p), rep.rep_codes_plain(p))
    for rows in (2100, 32768 + 77):  # K4's hard rows (one block never meets)
        p = _t(torch_cases.rep_hard_rows(rows, rows)).to(dev)
        assert torch.equal(rep.rep_codes(p), rep.rep_codes_plain(p)), rows
    for nseg, sw in ((45, 1024), (77, 64), (9, 100), (5, 1000), (3, 7)):  # K3's hard segments
        packed = _t(torch_cases.greedy_hard_packed(4, nseg, sw)).to(dev)
        assert torch.equal(greedy.greedy_segments(packed), greedy.greedy_segments_plain(packed))
    chain_calls = [(name, torch_cases.CASES[name].inputs())
                   for name in ("chain_sequences", "chain_weights")]
    chain_calls += [("hard", c) for c in torch_cases.chain_hard_inputs()]  # K5's hard calls
    chain_calls += [("garbage", c) for c in torch_cases.chain_garbage_inputs()]
    for name, i in chain_calls:
        args = [_t(i[k]).to(dev) for k in torch_cases.CHAIN_KEYS]
        got = torch_cases._chain_live(*(x.cpu() for x in chain.state_chain3(*args)), i["nseq"])
        want = torch_cases._chain_live(*(x.cpu() for x in chain.state_chain3_plain(*args)),
                                       i["nseq"])
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name} {k}")
    cfg = pipeline.PipelineConfig(block_size=16384, hash_log=13, mf_win_log=12)
    data = make_corpus(5 * 16384)
    assert pipeline.compress(data, cfg, True, device=dev) == pipeline.compress(
        data, cfg, True, device="cpu")
    opt_calls = [(name, torch_cases.CASES[name].inputs())
                 for name in ("opt_steps_mm3_cap64", "opt_steps_mm4_cap16")]
    opt_calls += torch_cases.opt_card_calls()
    for name, i in opt_calls:
        args = (_t(i["packed"]).to(dev), i["mm"], i["cap"], _t(i["lit"]).to(dev),
                _t(i["bank"]).to(dev))
        st = torch.zeros(args[0].shape[0], dtype=torch.int32, device=dev)
        assert torch.equal(opt.opt_steps(*args, stats=st), opt.opt_steps_plain(*args)), (
            name, tuple(args[0].shape), i["mm"], i["cap"])
        if name.startswith("fast"):
            assert int(st.sum()) == st.numel(), name
    opt_cfg = torch_cases._opt_level_cfg(config, 19)
    items = [make_corpus(40000), make_corpus(70000)[::-1][:33000]]
    assert manager.compress_items(items, opt_cfg, device=dev) == manager.compress_items(
        items, opt_cfg, device="cpu")
    _check_decode_kernels(dev)
    _check_fused_route_kernels(dev)
    _check_windows(dev)
    _check_surface(dev)


def _check_surface(dev):
    """HybridEngine's routes on the card equal the CPU's; a CUDA tensor is
    DEVICE and takes the card; the sharded compress in an NCCL group of one
    rank equals the CPU's, block for block."""
    import torch.distributed as dist

    from tpu_zstd_torch.api import hybrid
    from tpu_zstd_torch.parallel import sharding

    i = torch_cases.CASES["hybrid_routes"].inputs()
    assert torch_cases.digest(torch_cases._hybrid_run(hybrid, config, i, device=dev)) == \
        torch_cases.digest(torch_cases._hybrid_run(hybrid, config, i, device="cpu"))
    data = make_corpus(70000)
    t = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev)
    res = hybrid.HybridResult()
    frame = hybrid.HybridEngine(device=dev).compress(t, result=res)
    assert hybrid.detect_location(t) == hybrid.DataLocation.DEVICE
    assert res.backend == hybrid.Backend.TPU_KERNELS
    assert frame == manager.compress_items([data], config.CompressionConfig.from_level(3),
                                           device="cpu")[0]
    cfg = pipeline.PipelineConfig(block_size=4096, hash_log=13, mf_win_log=0)
    blocks = np.frombuffer(make_corpus(13 * 4096), np.uint8).reshape(13, 4096).copy()
    lengths = np.full(13, 4096, np.int32)
    want = sharding.compress_blocks_sharded(blocks, lengths, cfg, sharding.make_mesh(device="cpu"))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = sharding.make_mesh(device=dev)
        assert mesh.distributed and mesh.size == 1
        got = sharding.compress_blocks_sharded(blocks, lengths, cfg, mesh)
    finally:
        dist.destroy_process_group()
    assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])
    for b in range(13):
        assert np.array_equal(got[0][b, : got[1][b]], want[0][b, : want[1][b]]), b


def _check_windows(dev):
    """The window paths on the card equal the CPU's, on the seeded inputs
    of the cases of group "windows"."""
    for name in ("parse_dict", "parse_payload_only", "parse_sample_log", "parse_dec_min_ml"):
        i = torch_cases.CASES[name].inputs()
        DC = i["DC"]
        blocks = _t(i["blocks"])
        n = DC + _t(i["lengths"]).to(torch.int64)
        ws = DC - _t(i["dlens"]).to(torch.int64)
        for kw in i["kws"]:
            got = lz77.parse_block(blocks.to(dev), n.to(dev), block_start=DC,
                                   win_start=ws.to(dev), **kw)
            got = type(got)(*(x.cpu() for x in got))
            want = lz77.parse_block(blocks, n, block_start=DC, win_start=ws, **kw)
            W = blocks.shape[1]
            assert torch_cases.digest(torch_cases._opt_parse_digest(got, W)) == \
                torch_cases.digest(torch_cases._opt_parse_digest(want, W)), (name, kw)
    for name in ("items_ldm", "items_history_level3", "items_history_level19"):
        i = torch_cases.CASES[name].inputs()
        cfg = torch_cases._win_items_cfg(config, i)
        assert manager.compress_items(i["items"], cfg, history=i["history"], device=dev) == \
            manager.compress_items(i["items"], cfg, history=i["history"], device="cpu"), name
    i = torch_cases.CASES["streaming_compress"].inputs()
    assert torch_cases.digest(torch_cases._stream_compress_run(config, manager, i, device=dev)) \
        == torch_cases.digest(torch_cases._stream_compress_run(config, manager, i, device="cpu"))
    i = torch_cases.CASES["dict_frames"].inputs()
    assert torch_cases._dict_frames_run(dictionary, config, i, device=dev) == \
        torch_cases._dict_frames_run(dictionary, config, i, device="cpu")


def _check_concat_fused(dev):
    """K2's fused entry against its plain version (dtypes too) on the hard
    operands of tests/torch_cases.py concat_fused_hard: the tier-1 case's,
    at widths and lengths off 16 bytes, and from a source that does not
    start on 16 bytes."""
    def cu(a):
        return _t(a).to(dev)

    for kw in ({}, dict(seed=387, B=4, NW=5, W=100, lit_len=1001, seq_len=333)):
        i = torch_cases.concat_fused_hard(**kw)
        ops = torch_cases.concat_fused_operands(i, cu)
        shifted = cu(np.concatenate([i["pk"], i["pk"][..., :1]], -1))[..., 1:]
        off16 = [op._replace(src=shifted[..., : op.src.shape[2]]) if k in (0, 2) else op
                 for k, op in enumerate(ops)]
        for x in (ops, off16):
            for k, (g, w) in enumerate(zip(concat.concat_fused(x), concat.concat_fused_plain(x))):
                assert g.dtype == w.dtype and torch.equal(g, w), (kw, k)


def _check_fused_route_kernels(dev):
    """K12, K13 and K11 against their plain versions on the seeded cases,
    and the fused route against the sort route at its live positions."""
    for name in ("sort_rows_1024", "sort_rows_2048", "sort_rows_8192"):
        ops = [_t(x).to(dev) for x in torch_cases.CASES[name].inputs()["ops"]]
        for a, b in zip(sort.sort_rows(*ops), sort.sort_rows_plain(*ops)):
            assert torch.equal(a, b), name
    rng = np.random.default_rng(7)  # K12 past one CTA's width: the tiled network
    for W, P in ((32768, 2), (65536, 0)):
        key = rng.permuted(np.tile(np.arange(W, dtype=np.int32), (2, 1)), axis=1) * 3 - W
        ops = [_t(key).to(dev)] + [_t(rng.integers(-2**31, 2**31, (2, W)).astype(np.int32)).to(dev)
                                   for _ in range(P)]
        for a, b in zip(sort.sort_rows(*ops), sort.sort_rows_plain(*ops)):
            assert torch.equal(a, b), W
    for W in (1024, 8192, 16384, 65536):  # K12's and K13's hard sets, one CTA and tiled
        for c, (kinds, P, _) in enumerate(torch_cases.SORT_HARD):
            ops = [_t(x).to(dev) for x in torch_cases.sort_hard_ops(W, kinds, P, c)]
            for a, b in zip(sort.sort_rows(*ops), sort.sort_rows_plain(*ops)):
                assert torch.equal(a, b), (kinds, P, W)
        for c, (kinds, depth, nw, _) in enumerate(torch_cases.MATCH_HARD):
            m = torch_cases.match_hard_inputs(W, kinds, depth, nw, c)
            args = (_t(m["key"]).to(dev), _t(m["words"]).to(dev), depth, m["sentinel"])
            for a, b in zip(match.match_windows(*args), match.match_windows_plain(*args)):
                assert torch.equal(a, b), (kinds, depth, nw, W)
    for name in ("match_windows_d2_w2", "match_windows_d8_w8"):
        i = torch_cases.CASES[name].inputs()
        args = (_t(i["key"]).to(dev), [_t(w).to(dev) for w in i["words"]], i["depth"],
                i["sentinel"])
        for a, b in zip(match.match_windows(*args), match.match_windows_plain(*args)):
            assert torch.equal(a, b), name
    for kind in (0, 1, 2, "sparse", "edge"):
        i = torch_cases.CASES[f"deposit_pallas_{kind}"].inputs()
        args = [_t(i[k]).to(dev) for k in ("vals", "lens", "offs")] + [i["num_words"]]
        assert torch.equal(deposit.deposit_bits_pallas(*args),
                           deposit.deposit_bits_pallas_plain(*args)), kind
    i = torch_cases.CASES["find_matches_fused"].inputs()
    b, n = _t(i["blocks"]).to(dev), _t(i["lengths"]).to(dev)
    fml, foff = lz77.find_matches(b, n, use_pallas_match=True, **torch_cases.FUSED_KW)
    want = torch_cases.CASES["find_matches_fused"].port(i)
    assert torch.equal(fml.cpu(), want["fused_ml"]) and torch.equal(foff.cpu(), want["fused_off"])
    both = lz77.find_matches(b, n, use_pallas_match=True, two_band=True, **torch_cases.FUSED_KW)
    assert len(both) == 2 and torch.equal(both[0], fml) and torch.equal(both[1], foff)
    # 64 KB windows (K13's tiled path) against the sort route at live positions.
    blk = _t(np.frombuffer(make_corpus(2 * 131072), np.uint8).reshape(2, 131072)).to(dev)
    n2 = torch.tensor([131072, 100000], dtype=torch.int32, device=dev)
    kw = dict(hash_log=14, depth=4, cap=8, mf_win_log=16)
    f = lz77.find_matches(blk, n2, use_pallas_match=True, **kw)
    p = lz77.find_matches(blk, n2, **kw)
    live = torch.arange(131072, device=dev)[None, :] < n2.to(torch.int64)[:, None] - 3
    for x, y in zip(f, p):
        assert torch.equal(torch.where(live, x, 0), torch.where(live, y, 0))


def _live(x, n):
    x = x.cpu()
    return torch.where(torch.arange(x.shape[1]) < n.cpu().to(torch.int64)[:, None], x, 0)


def _check_decode_kernels(dev):
    i = torch_cases.CASES["decode_huffman"].inputs()
    args = [_t(i[k]).to(dev) for k in ("lstreams", "ltbits", "dtab", "tlog", "lnsym")]
    lck = _t(i["lck"]).to(dev)
    got = decode_lanes.decode_huffman_lanes(*args, i["CL"], i["NCL"], lck)
    want = decode.decode_huffman_device(*args, i["CL"], i["NCL"], lck)
    assert torch.equal(_live(got, args[4]), _live(want, args[4]))
    for name, v in torch_cases._huf_hard_inputs().items():  # K6's hard streams
        hargs = [_t(v[k]).to(dev) for k in ("lstreams", "ltbits", "dtab", "tlog", "lnsym")]
        hck = _t(v["lck"]).to(dev)
        got = decode_lanes.decode_huffman_lanes(*hargs, v["CL"], v["NCL"], hck)
        want = decode.decode_huffman_device(*hargs, v["CL"], v["NCL"], hck)
        assert torch.equal(_live(got, hargs[4]), _live(want, hargs[4])), name
    tables = decode.SeqTables(*(_t(i[k]).to(dev) for k in ("sym", "nb", "ns", "logs")))
    rep0 = torch.tensor([[1, 4, 8]] * len(i["nseq"]), dtype=torch.int32, device=dev)
    sargs = (_t(i["streams"]).to(dev), _t(i["tbits"]).to(dev), tables, _t(i["nseq"]).to(dev),
             rep0)
    for ck, C, NC in (((_t(i["ckb"]), _t(i["cks"]), _t(i["ckr"])), i["C"], i["NC"]),
                      ((torch.zeros((4, 0), dtype=torch.int32),) * 2
                       + (torch.zeros((4, 0, 3), dtype=torch.int32),), 20000, 1)):
        ck = tuple(x.to(dev) for x in ck)
        got = decode_lanes.decode_sequences_lanes(*sargs, *ck, C, NC, 20000, rep_fin=True)
        ll, ml, off, rows = decode.decode_sequences_chunks(*sargs, *ck, C, NC, 20000)
        for g, w in zip(got, (ll, ml, off)):
            assert torch.equal(_live(g, sargs[3]), _live(w, sargs[3]))
        assert torch.equal(got[3], decode.final_rep(rows, sargs[3], C, NC))
    hard = torch_cases.seq_hard_inputs()  # K7's hard inputs, and with scrambled records
    hard["garbage"] = torch_cases.seq_garbage_inputs(hard)
    for name, v in hard.items():
        nb = len(v["nseq"])
        none = np.zeros((nb, 0), np.int32)
        hargs = [_t(v[k]).to(dev) for k in ("streams", "tbits")]
        hargs += [decode.SeqTables(*(_t(v[k]).to(dev) for k in ("sym", "nb", "ns", "logs"))),
                  _t(v["nseq"]).to(dev), _t(np.tile(np.int32([1, 4, 8]), (nb, 1))).to(dev)]
        hargs += [_t(v.get(k, none)).to(dev) for k in ("ckb", "cks")]
        hargs += [_t(v.get("ckr", none[..., None])).to(dev), v["C"], v["NC"], v["max_seqs"]]
        got = decode_lanes.decode_sequences_lanes(*hargs, rep_fin=True)
        ll, ml, off, rows = decode.decode_sequences_chunks(*hargs)
        want = (ll, ml, off, decode.final_rep(rows, hargs[3], v["C"], v["NC"]))
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), name
    for W in (0, 300):
        eargs = [_t(a).to(dev) for a in torch_cases.exec_inputs(W, 6, 4096, W, 96, 2048)]
        eargs[6] = eargs[6][:, :W].contiguous()
        out, n = execmod.execute_sequences(*eargs, 4096, W)
        ref, rn = decode.execute_sequences_device(*eargs, 4096, W)
        assert torch.equal(n.cpu(), rn.cpu().to(torch.int32))
        assert torch.equal(_live(out, n), _live(ref, rn))
    for W in (1, 4096):  # K8/K9's hard lists, from front-compacted and stream rows
        h = torch_cases.exec_hard_inputs(W + 7, 8192, W)
        eargs = [_t(a).to(dev) for a in h]
        rows = _t(torch_cases.stream_rows(h[0], h[1], 8192 // 4 + 8)).to(dev)
        for kw in ({}, {"lit_src": (rows, eargs[1])}):
            out, n = execmod.execute_sequences(*eargs, 8192, W, **kw)
            ref, rn = decode.execute_sequences_device(*eargs, 8192, W, **kw)
            assert torch.equal(n.cpu(), rn.cpu().to(torch.int32)), W
            assert torch.equal(_live(out, n), _live(ref, rn)), W
    c = torch_cases.CASES["decompress_batch_accel"]
    inp = c.inputs()
    out, lens = decompress.prepare_decompress_batch(inp["frames"], torch_cases.DEC_N).execute()
    for k, p in enumerate(inp["payloads"]):
        assert int(lens[k]) == len(p) and out[k, : len(p)].cpu().numpy().tobytes() == p
    # The multi-block plan on the card (K7 serially from carried rep triples,
    # K8 against the carried history): the golden multi-block frames, the
    # port's and libzstd's, with their checksums; the window-cap refusal.
    inp = torch_cases.CASES["decompress_multiblock"].inputs()
    out, lens = decompress.prepare_decompress_batch(inp["frames"], torch_cases.MB_N).execute(
        verify_checksum=True)
    for k, p in enumerate(inp["payloads"]):
        assert int(lens[k]) == len(p) and out[k, : len(p)].cpu().numpy().tobytes() == p, k
    with pytest.raises(ValueError):
        decompress.prepare_decompress_batch(inp["wide"], torch_cases.MB_N)
    # decompress_batch_tpu on the card, equal to the CPU's (the seeded batch
    # of tests/torch_cases.py: carried repeat offsets, an 8 MiB window without
    # a content size, skippable frames, a checksum), K7 and K8 launched.
    inp = torch_cases.decompress_batch_tpu_inputs()()
    _kernels.reset_launches()
    got = decompress.decompress_batch_tpu(inp["frames"], torch_cases.DBT_N, device=dev)
    torch.cuda.synchronize()
    assert _kernels.launches["decode_seq"] > 0 and _kernels.launches["exec"] > 0
    assert got == decompress.decompress_batch_tpu(inp["frames"], torch_cases.DBT_N, device="cpu")
    assert got == inp["payloads"]
