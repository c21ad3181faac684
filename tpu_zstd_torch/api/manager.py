"""Batch compression of many buffers in one device batch.

Counterpart of `compress_items_tpu` and `BatchManager.compress_batch` in
tpu_zstd/api/manager.py, without cross-block windows: every item's blocks
flatten into one (B, 128 KB) batch padded to a power-of-two bucket, the
batch runs through `compress_blocks_staged`, the contents are trimmed on the
device to the largest non-Raw block before the copy to the host, and each
item's frame is assembled in Python (Raw blocks take the caller's bytes).
With `decode_accel` every frame carries a trailing skippable frame of
decoder checkpoints (format/accel.py), as the reference writes it. Levels
1-22 run, each block compressed on its own (levels 7 and up with the
long-range pass, 16 and up with the optimal parse); `enable_ldm` windows,
streaming history and dictionary IDs belong to later slices of the port
and raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import BLOCK_COMPRESSED, BLOCK_RAW, BLOCK_RLE
from ..format.accel import write_accel_frame
from ..format.frame import write_frame_header
from ..format.xxhash import content_checksum
from ..ops.pipeline import PipelineConfig, check_supported, compress_blocks_staged, resolve_device
from .config import ChecksumPolicy, CompressionConfig, CompressionStats, Status, Strategy


# Decoder-checkpoint stride (sequences per chunk; format/accel.py).
ACCEL_STRIDE = 256


def _pipeline_config(cfg: CompressionConfig) -> PipelineConfig:
    """The reference's level -> pipeline mapping."""
    return PipelineConfig(
        block_size=cfg.block_size,
        hash_log=min(cfg.hash_log, 17),
        depth=cfg.search_depth,
        cap=cfg.compare_cap,
        min_match=cfg.min_match,
        lazy=cfg.strategy >= Strategy.LAZY,
        optimal=cfg.strategy >= Strategy.BTOPT,
        huffman_literals=True,
        of_gate=(8, 12) if cfg.level >= 3 else (99, 99),
        mf_win_log=(13 if cfg.level <= 6 else 14 if cfg.level <= 9
                    else 15 if cfg.level <= 12 else 16),
        ckpt_every=ACCEL_STRIDE if cfg.decode_accel else 0,
        sample_log=0,
        ldm=cfg.level >= 7,
    )


def _bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _check_port_supports(cfg: CompressionConfig) -> None:
    later = [name for name, on in (
        ("enable_ldm", cfg.enable_ldm),
        ("dict_id", cfg.dict_id),
    ) if on]
    if later:
        raise NotImplementedError(
            f"not supported by the port yet: {', '.join(later)} (a later slice: cross-block "
            "windows, dictionaries)"
        )


def compression_config_from_reference(d: dict) -> CompressionConfig:
    """The port's CompressionConfig from `dataclasses.asdict` of a JAX
    CompressionConfig. Raises ValueError on an unknown field."""
    names = {f.name for f in dataclasses.fields(CompressionConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown CompressionConfig fields: {unknown}")
    kw = dict(d)
    if "strategy" in kw:
        kw["strategy"] = Strategy(int(kw["strategy"]))
    if "checksum" in kw:
        kw["checksum"] = ChecksumPolicy(int(kw["checksum"]))
    return CompressionConfig(**kw)


def compress_items(
    items: list[bytes], cfg: CompressionConfig, history: list[bytes] | None = None, device=None
) -> list[bytes]:
    """Compress a list of buffers in one device batch, one frame per item, on
    `device` (None means CUDA)."""
    if history is not None:
        raise NotImplementedError("streaming history is not supported by the port yet")
    _check_port_supports(cfg)
    pcfg = _pipeline_config(cfg)
    check_supported(pcfg)
    dev = resolve_device(device)
    N = pcfg.block_size

    spans: list[tuple[int, int]] = []  # (first_block, nblocks) per item
    chunks: list[np.ndarray] = []
    for data in items:
        n = len(data)
        nb = max(1, -(-n // N))
        spans.append((len(chunks), nb))
        arr = np.frombuffer(data, dtype=np.uint8)
        chunks += [arr[b * N : min((b + 1) * N, n)] for b in range(nb)]
    B = len(chunks)
    Bpad = _bucket(B)
    blocks_np = np.zeros((Bpad, N), dtype=np.uint8)
    lens_np = np.zeros(Bpad, dtype=np.int32)
    for b, chunk in enumerate(chunks):
        blocks_np[b, : len(chunk)] = chunk
        lens_np[b] = len(chunk)

    out = compress_blocks_staged(
        torch.from_numpy(blocks_np).to(dev), torch.from_numpy(lens_np).to(dev), pcfg
    )
    contents_d = out[0]
    # Two-phase fetch: lengths and types first, then the contents trimmed to
    # the largest non-Raw block (Raw blocks re-use the caller's bytes).
    clens = out[1].cpu().numpy()
    btypes = out[2].cpu().numpy()
    accel_meta = _accel_frames(out, btypes, spans, B, pcfg) if pcfg.ckpt_every else None
    nonraw = btypes[:B] != BLOCK_RAW
    mx = int(clens[:B][nonraw].max()) if nonraw.any() else 1
    width = min(_bucket(max(mx, 64), lo=64), N)
    contents = contents_d[:, :width].cpu().numpy()

    checksum = cfg.checksum != ChecksumPolicy.NONE
    outs: list[bytes] = []
    for (first, nb), data in zip(spans, items):
        tail = [content_checksum(data).to_bytes(4, "little")] if checksum else []
        if len(data) == 0:
            outs.append(b"".join([write_frame_header(0, checksum), (1).to_bytes(3, "little"),
                                  *tail]))
            continue
        parts = [write_frame_header(len(data), checksum, window_log=cfg.window_log)]
        for k in range(nb):
            b = first + k
            last = 1 if k == nb - 1 else 0
            btype = int(btypes[b])
            clen = int(clens[b])
            if btype == BLOCK_RLE:
                hdr = (int(lens_np[b]) << 3) | (BLOCK_RLE << 1) | last
                parts += [hdr.to_bytes(3, "little"), contents[b, :1].tobytes()]
            elif btype == BLOCK_RAW:
                parts.append(((clen << 3) | (BLOCK_RAW << 1) | last).to_bytes(3, "little"))
                parts.append(data[k * N : k * N + clen])
            else:
                parts.append(((clen << 3) | (btype << 1) | last).to_bytes(3, "little"))
                parts.append(contents[b, :clen].tobytes())
        outs.append(b"".join(parts + tail))
    if accel_meta:
        return [f + m for f, m in zip(outs, accel_meta)]
    return outs


def _accel_frames(out, btypes, spans, B: int, pcfg: PipelineConfig) -> list[bytes]:
    """One skippable checkpoint frame per item (the reference's sidecar
    assembly): per block its nseq, the sequence checkpoints trimmed to
    ceil(nseq / C) - 1 records and, where the block's literals are
    Huffman-coded, the literal checkpoints trimmed to ceil(ceil(nlit / 4) /
    CL) - 1 records per stream; empty records for Raw / RLE blocks and
    blocks without sequences."""
    C, CL = pcfg.ckpt_every, pcfg.lit_ckpt_every
    nseq_h = out[6].cpu().numpy().astype(np.int64)
    nck = np.maximum(-(-nseq_h // C) - 1, 0)
    mx_ck = int(nck[:B].max()) if B else 0
    ckb, cks, ckr = (out[k][:, :mx_ck].cpu().numpy() for k in (3, 4, 5))
    lck = None
    if pcfg.huffman_literals:
        lit_used_h = out[8].cpu().numpy()
        seg_h = -(-out[9].cpu().numpy().astype(np.int64) // 4)
        nckl = np.where(lit_used_h, np.maximum(-(-seg_h // CL) - 1, 0), 0)
        mx_ckl = int(nckl[:B].max()) if B else 0
        lck = out[7][:, :, :mx_ckl].cpu().numpy() if mx_ckl else None
    e = np.empty(0, np.uint32)
    el = np.zeros((4, 0), np.uint32)
    metas = []
    for first, nb in spans:
        recs = []
        for b in range(first, first + nb):
            if btypes[b] == BLOCK_COMPRESSED and nseq_h[b] > 0:
                n = int(nck[b])
                lc = lck[b, :, : int(nckl[b])] if lck is not None and nckl[b] > 0 else el
                recs.append((int(nseq_h[b]), ckb[b, :n], cks[b, :n], ckr[b, :n], lc))
            else:
                recs.append((0, e, e, e, el))
        metas.append(write_accel_frame(C, recs, lit_stride=CL))
    return metas


@dataclass
class BatchItem:
    """One batch entry."""

    data: bytes
    output: bytes | None = None
    status: Status = Status.SUCCESS


class BatchManager:
    """Batched many-buffer compression: one device batch per call."""

    def __init__(self, level: int = 3, config: CompressionConfig | None = None, device=None):
        self.config = config or CompressionConfig.from_level(level)
        _check_port_supports(self.config)
        self.device = resolve_device(device)
        self.stats = CompressionStats()

    def __enter__(self) -> "BatchManager":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def compress_batch(self, items: list[BatchItem] | list[bytes]) -> list[BatchItem]:
        t0 = time.perf_counter()
        norm = [it if isinstance(it, BatchItem) else BatchItem(it) for it in items]
        outs = compress_items([it.data for it in norm], self.config, device=self.device)
        for it, out in zip(norm, outs):
            it.output = out
            it.status = Status.SUCCESS
        dt = time.perf_counter() - t0
        self.stats.total_input_bytes += sum(len(it.data) for it in norm)
        self.stats.total_output_bytes += sum(len(it.output or b"") for it in norm)
        self.stats.total_frames += len(norm)
        self.stats.total_compress_calls += 1
        self.stats.total_compress_time_s += dt
        return norm
