"""Batched decompression: host framing -> device decode kernels.

Counterpart of tpu_zstd/api/decompress.py (`prepare_decompress_batch` ->
`DecompressPlan.execute`, `decompress_batch_to_device`,
`decompress_batch_tpu`). Section headers and entropy tables are
parsed and built on the host (they are small); the sequence decode, the
4-stream Huffman literal decode and the sequence execution run on the
device, uploaded once at prepare time so `execute()` does device work only:

- blocks whose frame carries decode-acceleration metadata (format/accel.py)
  at one stride decode chunk-parallel from its checkpoints (K7), and their
  literals too where the block is eligible (K6);
- frames without metadata take the serial decode, K7 with one chunk per
  block started from the states at the stream's head, and their literals
  are decoded on the host (pure Python);
- the executor (K8/K9) regenerates every block, reading K6's literal rows
  directly when a whole group decodes its literals on the device.

On CUDA tensors the kernels are the path (ops/decode_lanes.py,
ops/exec.py); on the CPU their plain versions run. Frames are grouped by
decode size class (chunk-count buckets) so small blocks do not pad to the
batch's largest.

A batch with a multi-block frame takes the chained-round plan
(`_prepare_multiblock_plan`, counterpart of the reference's): every block of
every frame is parsed at prepare time (literals and tables on the host, as
the reference does) and uploaded as rounds, block k of every frame in round
k; `execute()` decodes round after round on the device, K7 serially with
the repeat offsets carried from the round before, K8 against the history
window carried from the rounds before, then joins the rounds into one row
per frame. The plan keeps at most 4 MiB of history (PLAN_WINDOW_CAP) and
refuses frames whose window is wider.

`decompress_batch_tpu` decodes frames of any window up to 1 GiB with the same
round parser and the same device loop (`_parse_rounds`, `_stage_round`,
`_decode_rounds`), staging each round only when its turn comes and fetching
finished rounds to the host a few rounds behind, so the device never holds
the whole batch; it returns the frames' bytes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (
    BLOCK_COMPRESSED,
    BLOCK_RAW,
    BLOCK_RLE,
    LL_DEFAULT_LOG,
    LL_DEFAULT_NORM,
    ML_DEFAULT_LOG,
    ML_DEFAULT_NORM,
    OF_DEFAULT_LOG,
    OF_DEFAULT_NORM,
    REPCODE_INIT,
    SKIPPABLE_MAGIC_MAX,
    SKIPPABLE_MAGIC_MIN,
)
from ..format import huffman as huf
from ..format.accel import parse_accel_tail
from ..format.frame import decode_literals_section, parse_frame_header
from ..format.sequences import SeqDecodeTables, read_nbseq, read_sequence_table
from ..format.xxhash import content_checksum
from ..ops.decode import HUF_TSIZE, TSIZE_MAX, SeqTables, pack_seq_tables
from ..ops.decode_lanes import decode_huffman_lanes, decode_sequences_lanes
from ..ops.exec import execute_sequences
from ..ops.pipeline import resolve_device
from .manager import _bucket

# The multi-block plan: sequence rows a block (ceil(128K / 3), chunk-aligned)
# and the history it keeps (4 MiB).
MAX_SEQS_DEC = 44032
PLAN_WINDOW_CAP = 1 << 22


class _BlockPlan:
    """Host-parsed decode plan for one Compressed block."""

    __slots__ = ("lits", "nlit", "stream", "total_bits", "tables", "nbseq", "litdev")

    def __init__(self, lits, nlit, stream, total_bits, tables, nbseq, litdev=None):
        self.lits = lits
        self.nlit = nlit
        self.stream = stream
        self.total_bits = total_bits
        self.tables = tables  # (sym, nb, ns, logs) numpy, or None when nbseq == 0
        self.nbseq = nbseq
        # When the Huffman literals decode on the device: (streams[4] bytes,
        # tbits[4], nsym[4], packed dtable (2048,) i32, table_log, regen);
        # self.lits is then b"" and nlit == regen.
        self.litdev = litdev


def _parse_litdev(body: bytes) -> tuple | None:
    """Parse a 4-stream Compressed-literals section without decoding it.

    Returns (litdev tuple, consumed, regen) when the section can decode on
    the device (4-stream Huffman with its own table), else None (the host
    decodes it)."""
    b0 = body[0]
    lit_type = b0 & 3
    size_format = (b0 >> 2) & 3
    if lit_type != 2 or size_format == 0:  # Compressed_Literals, 4 streams only
        return None
    if size_format == 1:
        v = int.from_bytes(body[:3], "little")
        regen, comp, pos = (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 3
    elif size_format == 2:
        v = int.from_bytes(body[:4], "little")
        regen, comp, pos = (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4
    else:
        v = int.from_bytes(body[:5], "little")
        regen, comp, pos = (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 5
    payload = body[pos : pos + comp]
    weights, consumed = huf.parse_weights(payload)
    dt = huf.build_dtable(weights)
    payload = payload[consumed:]
    if len(payload) < 6:
        return None
    s1 = int.from_bytes(payload[0:2], "little")
    s2 = int.from_bytes(payload[2:4], "little")
    s3 = int.from_bytes(payload[4:6], "little")
    sbody = payload[6:]
    s4 = len(sbody) - s1 - s2 - s3
    if s4 <= 0:
        return None
    seg = (regen + 3) // 4
    nsym = [seg, seg, seg, regen - 3 * seg]
    if nsym[3] <= 0:
        return None
    streams, tbits = [], []
    for o, sz in zip([0, s1, s1 + s2, s1 + s2 + s3], [s1, s2, s3, s4]):
        chunk = sbody[o : o + sz]
        if not chunk or chunk[-1] == 0:
            return None
        streams.append(chunk)
        tbits.append((len(chunk) - 1) * 8 + chunk[-1].bit_length() - 1)
    packed = np.zeros(HUF_TSIZE, np.int32)
    packed[: 1 << dt.table_log] = (dt.symbol.astype(np.int32) << 4) | dt.nb_bits.astype(np.int32)
    return (streams, tbits, nsym, packed, dt.table_log, regen), pos + comp, regen


def _dense_tables(dts) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    sym = np.zeros((3, TSIZE_MAX), np.int32)
    nb = np.zeros((3, TSIZE_MAX), np.int32)
    ns = np.zeros((3, TSIZE_MAX), np.int32)
    logs = np.zeros(3, np.int32)
    for i, dt in enumerate(dts):  # order LL, OF, ML
        size = dt.table_size
        sym[i, :size] = dt.symbol
        nb[i, :size] = dt.nb_bits
        ns[i, :size] = dt.new_state
        logs[i] = dt.table_log
    return sym, nb, ns, logs


def _parse_block_plan(body: bytes, prev_tables: SeqDecodeTables | None, prev_huf,
                      device_literals: bool = False):
    """One Compressed block's plan; returns (plan, tables for Repeat mode,
    Huffman table for treeless literals)."""
    litdev = parsed = None
    if device_literals:
        parsed = _parse_litdev(body)
    if parsed is not None:
        litdev, consumed, regen = parsed
        lits, huff_table, nlit_val = b"", prev_huf, regen
    else:
        lit = decode_literals_section(body, prev_huf)
        lits, consumed, huff_table, nlit_val = lit.data, lit.consumed, lit.huff_table, len(lit.data)
    rest = body[consumed:]
    nbseq, pos = read_nbseq(rest)
    if nbseq == 0:
        return _BlockPlan(lits, nlit_val, b"", 0, None, 0, litdev), prev_tables, huff_table
    modes = rest[pos]
    pos += 1
    dts = []
    for shift, prev, norm, log, max_sym in (
        (6, prev_tables.ll if prev_tables else None, LL_DEFAULT_NORM, LL_DEFAULT_LOG, 35),
        (4, prev_tables.of if prev_tables else None, OF_DEFAULT_NORM, OF_DEFAULT_LOG, 31),
        (2, prev_tables.ml if prev_tables else None, ML_DEFAULT_NORM, ML_DEFAULT_LOG, 52),
    ):
        dt, c = read_sequence_table(rest[pos:], (modes >> shift) & 3, prev, norm, log, max_sym)
        dts.append(dt)
        pos += c
    stream = rest[pos:]
    if not stream or stream[-1] == 0:
        raise ValueError("corrupt sequence bitstream (bad sentinel)")
    total_bits = (len(stream) - 1) * 8 + stream[-1].bit_length() - 1
    plan = _BlockPlan(lits, nlit_val, stream, total_bits, _dense_tables(dts), nbseq, litdev)
    return plan, SeqDecodeTables(*dts), huff_table


def _upload(a, dev, dtype=torch.int32) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a)).to(device=dev, dtype=dtype)


def _skip_skippable(f: bytes) -> int:
    pos = 0
    while SKIPPABLE_MAGIC_MIN <= int.from_bytes(f[pos : pos + 4], "little") <= SKIPPABLE_MAGIC_MAX:
        pos += 8 + int.from_bytes(f[pos + 4 : pos + 8], "little")
    return pos


class DecompressPlan:
    """Prepared decompression: host parse and uploads done once.

    `execute()` runs only device work on the plan's device-resident inputs
    (no host parsing, no host-to-device copies), so repeated decodes of the
    same frames go at device speed.
    """

    def __init__(self, runners, nf: int, inv, checksums=None, device=None):
        self._runners = runners  # [(zero-argument device function, group size), ...]
        self._nf = nf
        # The regrouping permutation is uploaded once (None: one group).
        self._inv = None if inv is None else torch.as_tensor(inv, device=device)
        # Per frame the stored checksum (low 4 bytes of XXH64), or None.
        self._checksums = checksums or [None] * nf

    def execute(self, verify_checksum: bool = False):
        """Device-only decode. Returns (out (B, max_block) uint8, or (B, MO)
        with MO the largest content size bucketed for a batch with
        multi-block frames, lengths (B,) int32), frame i in row i; bytes
        past lengths[i] are unspecified (zero in the multi-block plan).

        verify_checksum=True also copies the outputs to the host and checks
        each frame's stored XXH64 content checksum (frames without one are
        skipped), raising ValueError on a mismatch.
        """
        if self._inv is None:
            out, out_len = self._runners[0][0]()
            out, out_len = out[: self._nf], out_len[: self._nf]
        else:
            outs, lens = [], []
            for run, cnt in self._runners:
                o, n = run()
                outs.append(o[:cnt])
                lens.append(n[:cnt])
            out = torch.cat(outs)[self._inv]
            out_len = torch.cat(lens)[self._inv]
        if verify_checksum and any(c is not None for c in self._checksums):
            out_h, len_h = out.cpu().numpy(), out_len.cpu().numpy()
            for i, stored in enumerate(self._checksums):
                if stored is None:
                    continue
                got = content_checksum(out_h[i, : int(len_h[i])].tobytes())
                if got != stored:
                    raise ValueError(f"content checksum mismatch (frame {i}): "
                                     f"stored {stored:#010x} != computed {got:#010x}")
        return out, out_len


def decompress_batch_to_device(frames: list[bytes], max_block: int = 128 * 1024, device=None):
    """One-shot decompression (prepare + execute): (out (B, max_block) uint8,
    or (B, MO) for a batch with multi-block frames, lengths (B,)), both on
    `device` (None means CUDA)."""
    return prepare_decompress_batch(frames, max_block, device).execute()


def prepare_decompress_batch(frames: list[bytes], max_block: int = 128 * 1024,
                             device=None) -> DecompressPlan:
    """Parse the frames, build their decode tables and upload everything to
    `device` (None means CUDA; raises without it). Single-block frames take
    the size-grouped plan; a batch with a multi-block frame takes
    `_prepare_multiblock_plan`."""
    dev = resolve_device(device)
    # A batch with a multi-block frame takes the chained-round plan.
    for f in frames:
        pos = _skip_skippable(f)
        h = parse_frame_header(f[pos:])
        bh = int.from_bytes(f[pos + h.header_size : pos + h.header_size + 3], "little")
        if not (bh & 1):
            return _prepare_multiblock_plan(frames, max_block, dev)

    nf = len(frames)
    plans: list[_BlockPlan | None] = []
    raws: list[bytes | None] = []
    bodies: list[bytes | None] = []
    metas: list = []  # per frame: its accel block record, or None
    checksums: list = []
    accel_stride = lit_stride = None
    for f in frames:
        f = f[_skip_skippable(f):]  # leading skippable frames carry no content
        meta, frame_end = parse_accel_tail(f)
        rec = None
        if meta is not None:
            f = f[:frame_end]
            if len(meta.blocks) == 1:
                rec = meta.blocks[0]
                accel_stride = meta.stride if accel_stride in (None, meta.stride) else -1
                lit_stride = meta.lit_stride if lit_stride in (None, meta.lit_stride) else -1
        hdr = parse_frame_header(f)
        pos = hdr.header_size
        bh = int.from_bytes(f[pos : pos + 3], "little")
        btype, bsize = (bh >> 1) & 3, bh >> 3
        if (hdr.content_size or 0) > max_block or bsize > max_block:
            raise ValueError("prepare_decompress_batch: block exceeds max_block "
                             f"({hdr.content_size or bsize} > {max_block})")
        body = f[pos + 3 : pos + 3 + (1 if btype == BLOCK_RLE else bsize)]
        ck_pos = pos + 3 + (1 if btype == BLOCK_RLE else bsize)
        checksums.append(int.from_bytes(f[ck_pos : ck_pos + 4], "little")
                         if hdr.has_checksum and ck_pos + 4 <= len(f) else None)
        if btype in (BLOCK_RAW, BLOCK_RLE):
            plans.append(None)
            raws.append(body if btype == BLOCK_RAW else body[:1] * bsize)
            bodies.append(None)
            metas.append(None)
        else:
            plan, _, _ = _parse_block_plan(body, None, None, device_literals=rec is not None)
            plans.append(plan)
            raws.append(None)
            bodies.append(body)
            metas.append(rec)
    # Chunk-parallel decode only when every compressed block with sequences
    # has checkpoints at one common stride.
    C = accel_stride if accel_stride and accel_stride > 0 else 0
    CL = lit_stride if lit_stride and lit_stride > 0 else 0
    use_accel = bool(C) and all(
        m is not None for p, m in zip(plans, metas) if p is not None and p.nbseq > 0)
    # Device literals: a litdev parse and checkpoint records for every chunk
    # (ceil(seg / CL) - 1 of them; seg <= CL needs none).
    litdev_set = set()
    if C and CL:
        for i, p in enumerate(plans):
            if p is None or p.litdev is None or metas[i] is None:
                continue
            if metas[i][4].shape[1] >= max(0, -(-((p.litdev[5] + 3) // 4) // CL) - 1):
                litdev_set.add(i)

    def t(a, dtype=torch.int32):
        return _upload(a, dev, dtype)

    def prepare_group(idxs: list[int]):
        """Stage and upload one size-class group; returns a zero-argument
        device function."""
        ng = len(idxs)
        B = _bucket(max(ng, 1), lo=1)
        live = [i for i in idxs if plans[i] is not None]
        swidth = _bucket(max(max((len(plans[i].stream) for i in live), default=1), 64), lo=64)
        all_dev = bool(idxs) and all(i in litdev_set for i in idxs)
        streams = np.zeros((B, swidth), np.uint8)
        tbits = np.zeros(B, np.int32)
        sym = np.zeros((B, 3, TSIZE_MAX), np.int32)
        nb = np.zeros((B, 3, TSIZE_MAX), np.int32)
        ns = np.zeros((B, 3, TSIZE_MAX), np.int32)
        logs = np.zeros((B, 3), np.int32)
        nseq = np.zeros(B, np.int32)
        lits = np.zeros((B, max_block if not all_dev else 1), np.uint8)
        nlit = np.zeros(B, np.int32)
        for bi, i in enumerate(idxs):
            p = plans[i]
            if p is None:
                lits[bi, : len(raws[i])] = np.frombuffer(raws[i], np.uint8)
                nlit[bi] = len(raws[i])
                continue
            streams[bi, : len(p.stream)] = np.frombuffer(p.stream, np.uint8)
            tbits[bi] = p.total_bits
            nseq[bi] = p.nbseq
            nlit[bi] = p.nlit
            if i not in litdev_set:
                if p.litdev is not None:
                    # Parsed for the device but without usable checkpoints.
                    p.lits = decode_literals_section(bodies[i], None).data
                lits[bi, : p.nlit] = np.frombuffer(p.lits, np.uint8)
            if p.tables is not None:
                sym[bi], nb[bi], ns[bi], logs[bi] = p.tables
        max_nseq = int(nseq.max()) if B else 0
        ms = max(-(-max_nseq // 256) * 256, 256)
        # Packed once here, as K7 takes them, not on every execute().
        tables = pack_seq_tables(SeqTables(t(sym), t(nb), t(ns), t(logs)))
        streams_d, tbits_d, nseq_d, nlit_d = t(streams, torch.uint8), t(tbits), t(nseq), t(nlit)
        rep0_d = t(np.tile(np.asarray(REPCODE_INIT, np.int32), (B, 1)))
        if use_accel:
            NC = _bucket(max(-(-max_nseq // C), 1), lo=1)
            K = max(NC - 1, 1)
            ckb = np.zeros((B, K), np.int32)
            cks = np.zeros((B, K), np.int32)
            ckr = np.ones((B, K, 3), np.int32)
            for bi, i in enumerate(idxs):
                rec = metas[i]
                if rec is None:
                    continue
                n = min(len(rec[1]), K)
                ckb[bi, :n] = rec[1][:n].astype(np.int64)
                cks[bi, :n] = rec[2][:n].astype(np.int64)
                ckr[bi, :n] = rec[3][:n].astype(np.int64)
            seq_args = (t(ckb), t(cks), t(ckr), C, NC, ms)
        else:  # serial: one chunk per block, as long as the longest block
            empty = torch.zeros((B, 0), dtype=torch.int32, device=dev)
            seq_args = (empty, empty, empty.reshape(B, 0, 3), max(max_nseq, 1), 1, ms)

        def decode_seqs():
            return decode_sequences_lanes(streams_d, tbits_d, tables, nseq_d, rep0_d, *seq_args)

        zwin = torch.zeros((B, 1), dtype=torch.uint8, device=dev)
        if all_dev:
            # The whole group decodes its literals on the device; the
            # executor reads K6's stream rows directly.
            R0 = B * 4
            lsw = _bucket(max(max(len(s) for i in idxs for s in plans[i].litdev[0]), 64), lo=64)
            max_sym = max(max(plans[i].litdev[2]) for i in idxs)
            NCL = _bucket(max(-(-max_sym // CL), 1), lo=1)
            lstreams = np.zeros((R0, lsw), np.uint8)
            ltbits = np.zeros(R0, np.int32)
            lnsym = np.zeros(R0, np.int32)
            dtab = np.zeros((B, HUF_TSIZE), np.int32)
            tlog = np.zeros(B, np.int32)
            lck = np.zeros((R0, max(NCL - 1, 1)), np.int32)
            regen = np.zeros(B, np.int32)
            for bi, i in enumerate(idxs):
                sts, tb, nsy, packed, tl_b, rg = plans[i].litdev
                dtab[bi] = packed
                tlog[bi] = tl_b
                regen[bi] = rg
                lc = metas[i][4]
                for s in range(4):
                    r = bi * 4 + s
                    lstreams[r, : len(sts[s])] = np.frombuffer(sts[s], np.uint8)
                    ltbits[r] = tb[s]
                    lnsym[r] = nsy[s]
                    n = min(lc.shape[1], NCL - 1)
                    lck[r, :n] = lc[s, :n].astype(np.int64)
            lit_args = (t(lstreams, torch.uint8), t(ltbits), t(dtab), t(tlog), t(lnsym), CL,
                        NCL, t(lck))
            regen_d = t(regen)
            zlit = torch.zeros((B, 1), dtype=torch.uint8, device=dev)

            def run():
                ll, ml, off = decode_seqs()
                syms = decode_huffman_lanes(*lit_args)
                return execute_sequences(zlit, nlit_d, ll, ml, off, nseq_d, zwin, max_block, 1,
                                         lit_src=(syms, regen_d))

            return run
        lits_d = t(lits, torch.uint8)

        def run():
            ll, ml, off = decode_seqs()
            return execute_sequences(lits_d, nlit_d, ll, ml, off, nseq_d, zwin, max_block, 1)

        return run

    # Size classes: chunk-count buckets of the sequences and the literal
    # streams; Raw / RLE and host-literal frames group apart, so device-
    # literal groups take the executor's stream-row path.
    groups: dict = {}
    for i in range(nf):
        p = plans[i]
        if p is None:
            key = ("host", 0, 0)
        else:
            nc = _bucket(max(-(-p.nbseq // C), 1), lo=1) if use_accel else 0
            if i in litdev_set:
                key = ("dev", nc, _bucket(max(-(-((p.litdev[5] + 3) // 4) // CL), 1), lo=1))
            else:
                key = ("host", nc, 0)
        groups.setdefault(key, []).append(i)
    if len(groups) <= 1:
        return DecompressPlan([(prepare_group(list(range(nf))), nf)], nf, None, checksums, dev)
    runners, order = [], []
    for key in sorted(groups):
        runners.append((prepare_group(groups[key]), len(groups[key])))
        order.extend(groups[key])
    inv = np.empty(nf, np.int64)
    inv[np.asarray(order)] = np.arange(nf)
    return DecompressPlan(runners, nf, inv, checksums, dev)


def _carry_window(win_prev: torch.Tensor, out: torch.Tensor, olen: torch.Tensor, Wn: int):
    """The history before the next round: per row the right-aligned last Wn
    bytes of concat(win_prev, out[:, :olen]), the bytes before the history's
    start repeating its first one (reference `_carry_window`, a gather there
    too). The gather takes a few rows at a time, so its int64 index stays
    under 128 MiB at windows up to 1 GiB."""
    Wp, B = win_prev.shape[1], out.shape[0]
    cat = torch.cat([win_prev, out], 1)
    start = olen.to(torch.int64)[:, None] + (Wp - Wn)  # each row's first byte in cat
    col = torch.arange(Wn, device=out.device)
    step = max(1, (1 << 24) // Wn)
    return torch.cat([cat[r : r + step].gather(1, (start[r : r + step] + col).clamp_(min=0))
                      for r in range(0, B, step)])


def _assemble_rounds(outs: torch.Tensor, lens: torch.Tensor, MO: int):
    """(R, B, M) round outputs and (R, B) lengths -> the contiguous (B, MO)
    uint8 rows, zero past each row's total, and the totals (B,) int32
    (reference `_assemble_rounds`)."""
    R, B, M = outs.shape
    lens = lens.to(torch.int64)
    cum = torch.cumsum(lens, 0)  # (R, B) inclusive
    start = cum - lens
    j = torch.arange(MO, device=outs.device)
    # The round of output position j: the rounds that end at or before j.
    rsel = torch.searchsorted(cum.T.contiguous(), j.expand(B, MO).contiguous(), right=True)
    rsel = torch.clamp(rsel, max=R - 1)
    pos = torch.clamp(j - start.T.gather(1, rsel), 0, M - 1)
    out = outs.permute(1, 0, 2).reshape(B, R * M).gather(1, rsel * M + pos)
    total = cum[-1]
    return torch.where(j < total[:, None], out, 0).to(torch.uint8), total.to(torch.int32)


# --- Multi-block frames: rounds of blocks, parsed on the host, decoded in turn --------


def _parse_headers(frames: list[bytes]):
    """Each frame with its leading skippable frames and its trailing
    decode-acceleration tail stripped (the round decoders use no
    checkpoints), its header, and a cursor at its first block header."""
    stripped, hdrs, cursors = [], [], []
    for f in frames:
        f = f[_skip_skippable(f):]
        meta, frame_end = parse_accel_tail(f)
        if meta is not None:
            f = f[:frame_end]
        hdr = parse_frame_header(f)
        stripped.append(f)
        hdrs.append(hdr)
        cursors.append(hdr.header_size)
    return stripped, hdrs, cursors


def _parse_rounds(frames: list[bytes], cursors: list[int], max_block: int) -> list[dict]:
    """Every block of every frame parsed on the host, block k of each frame
    in round k: per round {frame: _BlockPlan, or the bytes of a Raw / RLE
    block}. Repeat-mode sequence tables and the treeless Huffman table carry
    across a frame's blocks; section parsing depends only on the compressed
    bytes, so the device loop needs no host round trip between rounds.
    Leaves each cursor at its frame's end (the checksum). Raises ValueError
    for a truncated frame, a reserved block type, a corrupt section, and a
    block of more than max_block bytes or MAX_SEQS_DEC sequences."""
    nf = len(frames)
    done = [False] * nf
    seq_tables: list = [None] * nf
    huf_tables: list = [None] * nf
    rounds: list[dict] = []
    while not all(done):
        entry: dict = {}
        for i, f in enumerate(frames):
            if done[i]:
                continue
            pos = cursors[i]
            if pos + 3 > len(f):
                raise ValueError(f"truncated frame {i}: missing block header")
            bh = int.from_bytes(f[pos : pos + 3], "little")
            pos += 3
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            if pos + (1 if btype == BLOCK_RLE else bsize) > len(f):
                raise ValueError(f"truncated frame {i}: block body exceeds input")
            if btype == BLOCK_RAW:
                entry[i] = f[pos : pos + bsize]
                pos += bsize
            elif btype == BLOCK_RLE:
                entry[i] = f[pos : pos + 1] * bsize
                pos += 1
            elif btype == BLOCK_COMPRESSED:
                entry[i], seq_tables[i], huf_tables[i] = _parse_block_plan(
                    f[pos : pos + bsize], seq_tables[i], huf_tables[i])
                pos += bsize
            else:
                raise ValueError("reserved block type")
            nbytes = entry[i].nlit if isinstance(entry[i], _BlockPlan) else len(entry[i])
            if nbytes > max_block or (isinstance(entry[i], _BlockPlan)
                                      and entry[i].nbseq > MAX_SEQS_DEC):
                raise ValueError(f"frame {i}: a block exceeds max_block ({max_block} bytes) or "
                                 f"{MAX_SEQS_DEC} sequences")
            cursors[i] = pos
            done[i] = bool(last)
        rounds.append(entry)
    return rounds


def _stored_checksums(frames: list[bytes], hdrs, cursors: list[int]) -> list:
    """Per frame its stored checksum at its cursor, or None."""
    return [int.from_bytes(f[c : c + 4], "little") if h.has_checksum and c + 4 <= len(f)
            else None for f, h, c in zip(frames, hdrs, cursors)]


def _stage_round(entry: dict, B: int, max_block: int, dev) -> dict:
    """One round's inputs, B rows (frame i in row i), uploaded to dev: the
    sequence streams and their tables (packed once, as K7 takes them), the
    literals (a Raw / RLE block's bytes as literals without sequences)."""
    plans_r = [p for p in entry.values() if isinstance(p, _BlockPlan)]
    swidth = _bucket(max(max((len(p.stream) for p in plans_r), default=1), 64), lo=64)
    streams = np.zeros((B, swidth), np.uint8)
    tbits = np.zeros(B, np.int32)
    sym = np.zeros((B, 3, TSIZE_MAX), np.int32)
    nb = np.zeros((B, 3, TSIZE_MAX), np.int32)
    ns = np.zeros((B, 3, TSIZE_MAX), np.int32)
    logs = np.zeros((B, 3), np.int32)
    nseq = np.zeros(B, np.int32)
    lits = np.zeros((B, max_block), np.uint8)
    nlit = np.zeros(B, np.int32)
    for i, p in entry.items():
        if isinstance(p, _BlockPlan):
            streams[i, : len(p.stream)] = np.frombuffer(p.stream, np.uint8)
            tbits[i] = p.total_bits
            nseq[i] = p.nbseq
            lits[i, : p.nlit] = np.frombuffer(p.lits, np.uint8)
            nlit[i] = p.nlit
            if p.tables is not None:
                sym[i], nb[i], ns[i], logs[i] = p.tables
        else:
            lits[i, : len(p)] = np.frombuffer(p, np.uint8)
            nlit[i] = len(p)
    return {
        "streams": _upload(streams, dev, torch.uint8), "tbits": _upload(tbits, dev),
        "tables": pack_seq_tables(SeqTables(*(_upload(a, dev) for a in (sym, nb, ns, logs)))),
        "nseq": _upload(nseq, dev), "lits": _upload(lits, dev, torch.uint8),
        "nlit": _upload(nlit, dev), "any_seqs": any(p.nbseq > 0 for p in plans_r),
    }


def _decode_rounds(staged, nr: int, rep0: torch.Tensor, max_block: int, window_cap: int):
    """Decode nr staged rounds in turn on rep0's device; yields each round's
    (out (B, max_block) uint8, out_len (B,) int32). K7 runs serially (one
    chunk a block) from the repeat offsets the round before left (rows
    without sequences keep theirs), K8 against the history carried from the
    rounds before, which grows by a block a round up to window_cap, in powers
    of two from 4 KB, as the reference's executor sees it. `staged` may be
    a lazy iterator: each round is staged only when its turn comes."""
    B, dev = rep0.shape[0], rep0.device
    none = torch.zeros((B, 0), dtype=torch.int32, device=dev)
    rep = rep0
    win = torch.zeros((B, 1), dtype=torch.uint8, device=dev)
    Wcur, have_ub = 1, 0
    for r, st in enumerate(staged):
        if st["any_seqs"]:
            ll, ml, off, rep = decode_sequences_lanes(
                st["streams"], st["tbits"], st["tables"], st["nseq"], rep, none, none,
                none.reshape(B, 0, 3), MAX_SEQS_DEC, 1, MAX_SEQS_DEC, rep_fin=True)
            out, out_len = execute_sequences(st["lits"], st["nlit"], ll, ml, off, st["nseq"],
                                             win, max_block, Wcur)
        else:
            out, out_len = st["lits"], st["nlit"]
        out_len = out_len.to(torch.int32)
        yield out, out_len
        if r + 1 < nr:
            have_ub = min(window_cap, have_ub + max_block)
            Wnext = _bucket(max(have_ub, 4096), lo=4096)
            win = _carry_window(win, out, out_len, Wnext)
            Wcur = Wnext


def _rep_init(B: int, dev) -> torch.Tensor:
    return _upload(np.tile(np.asarray(REPCODE_INIT, np.int32), (B, 1)), dev)


def _prepare_multiblock_plan(frames: list[bytes], max_block: int, dev) -> DecompressPlan:
    """Prepared plan for a batch with multi-block frames (reference
    `_prepare_multiblock_plan`): every round parsed (`_parse_rounds`) and
    uploaded (`_stage_round`) at prepare time; `execute()` decodes the rounds
    in turn (`_decode_rounds`), then joins them into (B, MO) rows.
    Decode-acceleration tails are stripped (their checkpoints are unused)
    and leading skippable frames skipped. Raises ValueError for a frame
    whose window (bounded by its content size) exceeds PLAN_WINDOW_CAP:
    `decompress_batch_tpu` decodes those."""
    nf = len(frames)
    frames, hdrs, cursors = _parse_headers(frames)
    # Past the cap the plan no longer holds history the frame may reference.
    for i, h in enumerate(hdrs):
        need = h.window_size or h.content_size or 0
        if h.content_size is not None:
            need = min(need, h.content_size)
        if need > PLAN_WINDOW_CAP:
            raise ValueError(f"frame {i}: window size {need} exceeds the prepared-plan cap "
                             f"({PLAN_WINDOW_CAP}); decompress_batch_tpu decodes it")
    window_cap = max(4096, -(-min(max(h.window_size or h.content_size or (1 << 22)
                                      for h in hdrs), PLAN_WINDOW_CAP) // 4096) * 4096)
    rounds = _parse_rounds(frames, cursors, max_block)
    B = _bucket(nf, lo=1)
    staged = [_stage_round(entry, B, max_block, dev) for entry in rounds]
    nr = len(rounds)
    MO = _bucket(max(max((h.content_size or nr * max_block) for h in hdrs), 1), lo=4096)
    rep0 = _rep_init(B, dev)

    def run():
        outs, lens = zip(*_decode_rounds(staged, nr, rep0, max_block, window_cap))
        return _assemble_rounds(torch.stack(outs), torch.stack(lens), MO)

    return DecompressPlan([(run, nf)], nf, None, _stored_checksums(frames, hdrs, cursors), dev)


# The longest history `decompress_batch_tpu` keeps (the reference's ceiling).
WINDOW_CEILING = 1 << 30
# Rounds `decompress_batch_tpu` keeps on the device before fetching the oldest.
DRAIN_BEHIND = 4


@dataclass
class ParsedBatch:
    """A batch parsed on the host for `decompress_batch_tpu`; nothing of it
    is on a device yet."""

    hdrs: list
    rounds: list[dict]
    checksums: list
    window_cap: int
    max_block: int


def parse_batch(frames: list[bytes], max_block: int = 128 * 1024,
                window_cap: int | None = None) -> ParsedBatch:
    """The host half of `decompress_batch_tpu`: headers and every block
    parsed. Raises ValueError for a frame that cannot be parsed, before any
    device work."""
    frames, hdrs, cursors = _parse_headers(frames)
    if window_cap is None:
        # From the headers (window descriptor, else content size), up to
        # WINDOW_CEILING, so that any valid frame decodes.
        need = max(min(h.window_size or h.content_size or WINDOW_CEILING, WINDOW_CEILING)
                   for h in hdrs)
        window_cap = max(4096, -(-need // 4096) * 4096)
    rounds = _parse_rounds(frames, cursors, max_block)
    return ParsedBatch(hdrs, rounds, _stored_checksums(frames, hdrs, cursors), window_cap,
                       max_block)


def decode_parsed(parsed: ParsedBatch, verify_checksum: bool = True, device=None) -> list[bytes]:
    """The device half of `decompress_batch_tpu`: the rounds of `parsed`,
    each staged and uploaded when its turn comes, decoded in turn on
    `device` (None means CUDA); finished rounds are fetched to the host
    DRAIN_BEHIND rounds behind, so the device holds a few rounds at a time.
    Then each frame's content size and (with verify_checksum) checksum are
    checked, raising ValueError on a mismatch."""
    dev = resolve_device(device)
    nf, rounds, max_block = len(parsed.hdrs), parsed.rounds, parsed.max_block
    B = _bucket(nf, lo=1)
    outputs = [bytearray() for _ in range(nf)]
    pending: list = []

    def drain(n_keep: int) -> None:
        while len(pending) > n_keep:
            r0, out, out_len = pending.pop(0)
            out_h, len_h = out.cpu().numpy(), out_len.cpu().numpy()
            for i in rounds[r0]:
                outputs[i] += out_h[i, : len_h[i]].tobytes()

    staged = (_stage_round(entry, B, max_block, dev) for entry in rounds)
    for r, (out, out_len) in enumerate(_decode_rounds(staged, len(rounds), _rep_init(B, dev),
                                                      max_block, parsed.window_cap)):
        pending.append((r, out, out_len))
        drain(DRAIN_BEHIND)
    drain(0)
    results = []
    for i, hdr in enumerate(parsed.hdrs):
        out = bytes(outputs[i])
        if hdr.has_checksum and verify_checksum and parsed.checksums[i] != content_checksum(out):
            raise ValueError(f"content checksum mismatch (frame {i})")
        if hdr.content_size is not None and len(out) != hdr.content_size:
            raise ValueError(f"content size mismatch (frame {i}): {len(out)} != "
                             f"{hdr.content_size}")
        results.append(out)
    return results


def decompress_batch_tpu(frames: list[bytes], max_block: int = 128 * 1024,
                         window_cap: int | None = None, verify_checksum: bool = True,
                         device=None) -> list[bytes]:
    """Decompress a batch of zstd frames of any number of blocks, one round
    of blocks at a time on `device` (None means CUDA; raises without it);
    returns each frame's content (reference `decompress_batch_tpu`).

    window_cap: the history cross-block matches see. None derives it from
    the frames' headers (window descriptor or content size, up to 1 GiB),
    so any valid frame decodes; a smaller cap trades correctness on
    long-window frames for memory. Leading skippable frames are skipped.
    Raises ValueError for a frame that cannot be parsed (before any device
    work), for a block of more than max_block bytes or MAX_SEQS_DEC
    sequences, and for a content size or (with verify_checksum) checksum
    mismatch. An empty batch returns []."""
    dev = resolve_device(device)
    if not frames:
        return []
    return decode_parsed(parse_batch(frames, max_block, window_cap), verify_checksum, dev)
