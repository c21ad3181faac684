"""The port's decode path against the live JAX package.

- The host format copies (tpu_zstd_torch/format/{bitstream,fse,huffman,
  sequences,frame,accel}.py) equal their originals: the bit readers on
  seeded streams, Huffman stream decode (errors included), and the seeded
  case "format_decode" (frame headers, literal sections, weights, sequence
  tables of libzstd and port frames).
- The plain versions of the decode kernels (ops/decode.py) equal the JAX
  functions on their live ranges (cases "decode_sequences_serial",
  "decode_sequences_chunked", "decode_huffman", "execute_sequences"), and
  the TPU kernels run in interpret mode: K7 `decode_sequences_lanes` and
  K8/K9 `execute_sequences_pallas(_mb)` everywhere; K6
  `decode_huffman_lanes` on the streams it decodes right (its word-slice
  staging mis-decodes some blocks), while the port's literals are held
  against the input bytes themselves.
- `prepare_decompress_batch(..., device="cpu").execute()` returns the input
  for the port's accel and plain frames, the JAX package's accel frames,
  and stock libzstd's single-block frames at levels 1, 3, 9 and 19;
  `execute(verify_checksum=True)` passes on good frames and raises on a bad
  checksum; a batch with libzstd's multi-block frame decodes through the
  chained-round plan, and a window past its 4 MiB cap raises ValueError;
  `device=None` means CUDA.
- The LL/ML tables written into csrc/decode_seq.cu equal constants.py.

Exact equality. One test item (see tests/test_torch_kernels.py).
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch
import torch_cases
import zstandard

import jax.numpy as jnp
from tpu_zstd import constants as jconst
from tpu_zstd.api import config as jc
from tpu_zstd.api import decompress as jd
from tpu_zstd.api import manager as jm
from tpu_zstd.format import bitstream as jbits
from tpu_zstd.format.accel import parse_accel_tail
from tpu_zstd.format import huffman as jhuf
from tpu_zstd.ops import pallas_decode as PD
from tpu_zstd.ops.pallas_exec import execute_sequences_pallas, execute_sequences_pallas_mb
from tpu_zstd_torch import constants as tconst
from tpu_zstd_torch.api import config as tc
from tpu_zstd_torch.api import decompress as td
from tpu_zstd_torch.api import manager as tm
from tpu_zstd_torch.corpus import make_corpus
from tpu_zstd_torch.format import bitstream as tbits
from tpu_zstd_torch.format import huffman as thuf
from tpu_zstd_torch.ops import decode

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 16384


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _check_constants_and_bit_readers():
    for name in ("SKIPPABLE_MAGIC_MIN", "SKIPPABLE_MAGIC_MAX", "LIT_RAW", "LIT_RLE",
                 "LIT_COMPRESSED", "LIT_TREELESS", "SEQ_REPEAT", "REPCODE_INIT",
                 "FSE_MAX_TABLELOG", "FSE_MIN_TABLELOG", "HUF_MAX_BITS"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    assert all(tconst.highbit32(v) == jconst.highbit32(v) for v in (1, 2, 3, 255, 1 << 30))
    rng = np.random.default_rng(77)

    def same(fa, fb):
        """fa() and fb() return the same value, or both raise ValueError."""
        try:
            want = fb()
        except ValueError:
            with pytest.raises(ValueError):
                fa()
            return
        assert fa() == want

    for n in (1, 2, 9, 300):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()[:-1] + bytes([1 + n % 255])
        for permissive in (False, True):
            a, b = tbits.BackwardBitReader(data, permissive), jbits.BackwardBitReader(data, permissive)
            f1, f2 = tbits.ForwardBitReader(data), jbits.ForwardBitReader(data)
            for w in [int(x) for x in rng.integers(0, 17, 40)]:
                same(lambda: a.peek_padded(w), lambda: b.peek_padded(w))
                same(lambda: a.read(w), lambda: b.read(w))
                assert (a.bits_left, a.overflowed) == (b.bits_left, b.overflowed)
                assert f1.peek(w) == f2.peek(w)
                assert f1.read(w) == f2.read(w) and f1.bytes_consumed == f2.bytes_consumed


def _check_huffman_stream_decode():
    """decode_stream (byte-window reads) against the reference's big-integer
    reader: whole literal sections of libzstd frames, and streams cut or
    padded so that both raise."""
    data = make_corpus(40000)
    frame = zstandard.ZstdCompressor(level=19).compress(data[:30000])
    body = frame[jd.parse_frame_header(frame).header_size + 3 :]
    lit = jd.decode_literals_section(body, None)
    assert lit.huff_table is not None and body[0] & 3 == 2
    pay = body[3 if (body[0] >> 2) & 3 <= 1 else ((body[0] >> 2) & 3) + 2 : lit.consumed]
    w, c = jhuf.parse_weights(pay)
    dt_j, dt_t = jhuf.build_dtable(w), thuf.build_dtable(w)
    streams = pay[c:]
    for regen in (len(lit.data), len(lit.data) - 1, len(lit.data) + 7):
        try:
            want = jhuf.decode_literals_4stream(streams, dt_j, regen)
        except ValueError:
            with pytest.raises(ValueError):
                thuf.decode_literals_4stream(streams, dt_t, regen)
            continue
        assert thuf.decode_literals_4stream(streams, dt_t, regen) == want
    assert thuf.decode_literals_4stream(streams, dt_t, len(lit.data)) == lit.data


def _check_kernel_tables_equal_constants():
    src = (ROOT / "tpu_zstd_torch" / "csrc" / "decode_seq.cu").read_text()
    for name, ref in (("c_ll_base", tconst.LL_BASELINE), ("c_ll_bits", tconst.LL_BITS),
                      ("c_ml_base", tconst.ML_BASELINE), ("c_ml_bits", tconst.ML_BITS)):
        body = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", src).group(1)
        assert [int(v) for v in body.replace("\n", " ").split(",")] == [int(v) for v in ref]


def _accel_frame(data):
    cfg = dataclasses.replace(jc.CompressionConfig.from_level(3), block_size=N, decode_accel=True)
    return jm.compress_items_tpu([data], cfg)[0]


def _block_of(frame):
    meta, end = parse_accel_tail(frame)
    f = frame[:end]
    pos = jd.parse_frame_header(f).header_size
    bh = int.from_bytes(f[pos : pos + 3], "little")
    assert (bh >> 1) & 3 == 2
    return meta, f[pos + 3 : pos + 3 + (bh >> 3)]


def _check_interpret_huffman_lanes():
    """K6 in interpret mode against the port's plain decode and the input."""
    data = make_corpus(2 * N)[N:]
    frame = _accel_frame(data)
    meta, body = _block_of(frame)
    litdev, _, regen = jd._parse_litdev(body)
    CL, lck = meta.lit_stride, meta.blocks[0][4]
    seg = (regen + 3) // 4
    ncl_pad = max(32, -(-(-(-seg // CL)) // 32) * 32)
    slices, bits0, nsym, tl, banks, wmax, R = PD.build_litlane_inputs([litdev], [lck], ncl_pad, CL)
    ext = (-(-R // 1024) * 1024 - R) // 128
    z = np.zeros((ext, 128), np.int32)
    lanes = PD.decode_huffman_lanes(
        jnp.asarray(np.concatenate([slices, np.zeros((wmax, ext, 128), np.int32)], 1)),
        *(jnp.asarray(np.concatenate([a, z])) for a in (bits0, nsym, tl)),
        jnp.asarray(np.concatenate([banks, np.zeros((ext,) + banks.shape[1:], np.int32)])),
        CL, wmax, True)
    lanes = np.asarray(lanes)[:R].reshape(4, ncl_pad * CL)
    # The port: its own parse and plain decode of the same streams.
    tlit, _, _ = td._parse_litdev(body)
    sts, tb, nsy, packed, tlog, _ = tlit
    NCL = -(-max(nsy) // CL)
    streams = np.zeros((4, max(len(s) for s in sts)), np.uint8)
    for s in range(4):
        streams[s, : len(sts[s])] = np.frombuffer(sts[s], np.uint8)
    lck_p = np.zeros((4, max(NCL - 1, 1)), np.int32)
    lck_p[:, : lck.shape[1]] = lck[:, : lck_p.shape[1]]
    syms = decode.decode_huffman_device(_t(streams), _t(np.int32(tb)), _t(packed[None]),
                                        _t(np.int32([tlog])), _t(np.int32(nsy)), CL, NCL,
                                        _t(lck_p)).numpy()
    lits = decode.assemble_literals_4stream(_t(syms), _t(np.int32([regen])), N).numpy()[0]
    truth = jd.decode_literals_section(body, None).data
    assert lits[:regen].tobytes() == truth  # the port, against the host decode
    agree = 0
    for s in range(4):
        want = truth[s * seg : s * seg + nsy[s]]
        if lanes[s, : nsy[s]].tobytes() == want:  # where the TPU kernel decodes right
            assert syms[s, : nsy[s]].tobytes() == lanes[s, : nsy[s]].tobytes()
            agree += 1
    assert agree >= 1


def _check_interpret_sequence_lanes():
    """K7 in interpret mode against the port's plain chunked decode."""
    data = make_corpus(3 * N)[2 * N :]
    meta, body = _block_of(_accel_frame(data))
    plan, _, _ = jd._parse_block_plan(body, None, None)
    C, rec = meta.stride, meta.blocks[0]
    nc_pad = max(128, -(-(-(-plan.nbseq // C)) // 128) * 128)
    blk = {"stream": plan.stream, "tbits": plan.total_bits, "nseq": plan.nbseq,
           "tables": plan.tables, "ckb": rec[1], "cks": rec[2], "ckr": rec[3]}
    sl, b0, s0, r0, nloc, nupd, banks, wmax, R = PD.build_seqlane_inputs([blk], nc_pad, C)
    ext = (-(-R // 1024) * 1024 - R) // 128
    z = np.zeros((ext, 128), np.int32)
    llb, mlb = PD._value_banks()
    lanes = PD.decode_sequences_lanes(
        jnp.asarray(np.concatenate([sl, np.zeros((wmax, ext, 128), np.int32)], 1)),
        jnp.asarray(np.concatenate([b0, z])), jnp.asarray(np.concatenate([s0, z])),
        jnp.asarray(np.concatenate([r0, np.ones((3, ext, 128), np.int32)], 1)),
        jnp.asarray(np.concatenate([nloc, z])), jnp.asarray(np.concatenate([nupd, z])),
        jnp.asarray(np.concatenate([banks, np.zeros((ext, 12, 128), np.int32)])),
        jnp.asarray(llb), jnp.asarray(mlb), C, wmax, True)
    lanes = [np.asarray(a)[:R].reshape(-1)[: plan.nbseq] for a in lanes]
    tplan, _, _ = td._parse_block_plan(body, None, None)
    NC = -(-plan.nbseq // C)
    sym, nb, ns, logs = tplan.tables
    K = max(NC - 1, 1)
    ck = [np.zeros((1, K), np.int32), np.zeros((1, K), np.int32), np.ones((1, K, 3), np.int32)]
    for a, r in zip(ck, rec[1:4]):
        a[0, : len(r)] = r
    out = decode.decode_sequences_device_chunked(
        _t(np.frombuffer(tplan.stream, np.uint8)[None]), _t(np.int32([tplan.total_bits])),
        decode.SeqTables(_t(sym[None]), _t(nb[None]), _t(ns[None]), _t(logs[None])),
        _t(np.int32([tplan.nbseq])), *(_t(a) for a in ck), C, NC, NC * C)
    for got, want in zip(out[:3], lanes):
        np.testing.assert_array_equal(got.numpy()[0, : plan.nbseq], want)


def _check_interpret_executors():
    """K8 and K9 (group 2) in interpret mode against the port's plain
    executor, with and without a window."""
    for W in (0, 256):
        lits, nlit, ll, ml, off, nseq, window = torch_cases.exec_inputs(W + 1, 5, 2048, W, 48, 1024)
        args = (lits, nlit, ll, ml, off, nseq, window)
        mine, mine_len = decode.execute_sequences_device(*(_t(a) for a in args), 2048, W)
        jargs = tuple(jnp.asarray(a) for a in args)
        for got, got_len in (
                execute_sequences_pallas(*jargs, out_size=2048, win_size=W, interpret=True),
                execute_sequences_pallas_mb(*jargs, out_size=2048, win_size=W, group=2,
                                            interpret=True)):
            got, got_len = np.asarray(got), np.asarray(got_len)
            np.testing.assert_array_equal(mine_len.numpy(), got_len)
            for b in range(5):
                np.testing.assert_array_equal(mine.numpy()[b, : got_len[b]],
                                              got[b, : got_len[b]], err_msg=f"W {W} row {b}")


def _decodes(frames, payloads, **kw):
    out, lens = td.prepare_decompress_batch(frames, N, device="cpu").execute(**kw)
    for k, p in enumerate(payloads):
        assert int(lens[k]) == len(p) and out[k, : len(p)].numpy().tobytes() == p, k


def _check_decode_batches(corpus):
    payloads = [d for d in corpus.values() if len(d) <= N]
    base = make_corpus(3 * N)
    payloads += [base[:N], base[N : 2 * N], base[2 * N : 2 * N + 5000]]
    cfg = dataclasses.replace(tc.CompressionConfig.from_level(3), block_size=N, decode_accel=True,
                              checksum=tc.ChecksumPolicy.COMPUTE)
    port = tm.compress_items(payloads, cfg, device="cpu")
    _decodes(port, payloads, verify_checksum=True)
    plain = tm.compress_items(payloads, dataclasses.replace(cfg, decode_accel=False), device="cpu")
    _decodes(plain, payloads)
    ref_cfg = dataclasses.replace(jc.CompressionConfig.from_level(3), block_size=N,
                                  decode_accel=True)
    _decodes(jm.compress_items_tpu(payloads, ref_cfg), payloads)
    for level in (1, 3, 9, 19):
        cctx = zstandard.ZstdCompressor(level=level, write_checksum=True)
        _decodes([cctx.compress(p) for p in payloads], payloads, verify_checksum=True)
    # A frame behind an 8-byte skippable frame (and one with its accel
    # sidecar) decodes to its input; the reference parses the header at
    # offset 0 there and raises.
    skip = (0x184D2A50).to_bytes(4, "little") + (0).to_bytes(4, "little")
    lead = [skip + zstandard.ZstdCompressor(level=3).compress(payloads[-1]), skip + port[-1]]
    _decodes(lead, [payloads[-1]] * 2)
    bad = bytearray(port[-1])
    _, end = parse_accel_tail(bytes(bad))
    bad[end - 1] ^= 0xFF  # the stored checksum's last byte
    with pytest.raises(ValueError, match="checksum"):
        td.prepare_decompress_batch(port[:-1] + [bytes(bad)], N, device="cpu").execute(
            verify_checksum=True)
    # A batch with a multi-block frame takes the chained-round plan: libzstd's
    # frame with blocks ended by flushes decodes to its input beside a
    # single-block one; a frame whose window passes the plan's 4 MiB cap
    # raises ValueError.
    spec = {"payload": make_corpus(40000), "level": 3, "flush": [N, 9000], "checksum": True}
    multi = torch_cases.zstd_flushed(spec)
    _decodes([multi, lead[0]], [spec["payload"], payloads[-1]], verify_checksum=True)
    wide = (0xFD2FB528).to_bytes(4, "little") + bytes([0x00, 13 << 3])  # 8 MiB window
    wide += (5 << 3).to_bytes(3, "little") + b"12345" + ((5 << 3) | 1).to_bytes(3, "little")
    with pytest.raises(ValueError, match="window size"):
        td.prepare_decompress_batch([wide + b"67890"], N, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            td.prepare_decompress_batch(port[:1], N)  # device=None means CUDA


def test_decode_path_matches_jax(corpus):
    """One test item for the whole file."""
    _check_constants_and_bit_readers()
    _check_huffman_stream_decode()
    _check_kernel_tables_equal_constants()
    _check_interpret_huffman_lanes()
    _check_interpret_sequence_lanes()
    _check_interpret_executors()
    _check_decode_batches(corpus)
    torch_cases.check_live("decode")
