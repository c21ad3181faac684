"""Managers: single-shot, batch and streaming surfaces of the port.

Counterpart of tpu_zstd/api/manager.py: `Manager` (single-shot, routed by
size: inputs under `cpu_threshold` compress on the host, with the native
engine (utils/native.py) or, where no C++ compiler exists, the pure-Python
codec; larger ones on the card; `decompress` on the card through
`decompress_batch_tpu` on the device execution paths, else with the host
decoder), `BatchManager` (`compress_batch` with the OOM split-and-retry
ladder, `compress_batch_async`, `decompress_batch`,
`decompress_batch_to_device`), `StreamingManager` (one
frame across `compress_chunk` calls, each chunk's blocks reaching back into
the chunks before it; its decode half is a `StreamingDecompressor`) and
`StreamingDecompressor` (incremental host decode of arbitrary chunks).
The managers resolve their device when made: None means CUDA, and they
raise without it.

`compress_items` is the counterpart of `compress_items_tpu`: every item's
blocks flatten into one (B, 128 KB) batch padded to a power-of-two bucket,
the batch runs through `compress_blocks_staged`, the contents are trimmed
on the device to the largest non-Raw block before the copy to the host, and
each item's frame is assembled: by the native assembler where no trim
applies and no item is empty (as the reference's condition has it), else in
Python (Raw blocks take the caller's bytes). With `decode_accel` every
frame carries a trailing skippable frame of decoder checkpoints
(format/accel.py), as the reference writes it.
Levels 1-22 run (levels 7 and up with the long-range pass, 16 and up with
the optimal parse). With `enable_ldm` or `history` each block sees a window
of the bytes before it in its stream (`compress_blocks_dict`): with
`enable_ldm` alone through the long-range pass, with history through the
search over the whole row; such frames carry no checkpoints.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import (
    BLOCK_COMPRESSED,
    BLOCK_RAW,
    BLOCK_RLE,
    BLOCK_SIZE_MAX,
    REPCODE_INIT,
    SKIPPABLE_MAGIC_MAX,
    SKIPPABLE_MAGIC_MIN,
    ZSTD_MAGIC,
)
from ..format import frame as host_frame
from ..format.accel import write_accel_frame
from ..format.frame import decode_literals_section, parse_frame_header, write_frame_header
from ..format.sequences import decode_sequences_section, execute_sequences
from ..format.xxhash import XXH64State, content_checksum
from ..ops.pipeline import (
    PipelineConfig,
    check_supported,
    compress_blocks_dict,
    compress_blocks_staged,
    resolve_device,
)
from ..utils.native import NativeEngine, assemble_frames
from .config import (
    ChecksumPolicy,
    CompressionConfig,
    CompressionStats,
    ExecutionPath,
    Status,
    Strategy,
)


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


LDM_WINDOW_CAP = 64 * 1024  # cross-block window size (enable_ldm / streaming history)


def _window_cap(cfg: CompressionConfig) -> int:
    """The window a block sees before it: 64 KB, or 2^window_log up to
    1 MiB."""
    return min(1 << cfg.window_log, 1 << 20) if cfg.window_log else LDM_WINDOW_CAP


def compress_items(
    items: list[bytes], cfg: CompressionConfig, history: list[bytes] | None = None, device=None
) -> list[bytes]:
    """Compress a list of buffers in one device batch, one frame per item, on
    `device` (None means CUDA).

    With cfg.enable_ldm or `history` every block also sees, as a window of
    match sources, the bytes before it in its stream: `history[i]` (prior
    stream content of item i) and the item's earlier blocks, up to
    `_window_cap` bytes rounded up to 4 KB. enable_ldm without history
    keeps the windowed search on the payload and reaches the window through
    the long-range pass; history searches the whole row."""
    pcfg = _pipeline_config(cfg)
    N = pcfg.block_size
    windowed = cfg.enable_ldm or history is not None
    dcap = 0
    if windowed:
        dcap = -(-_window_cap(cfg) // 4096) * 4096
        extra = {"ldm": True, "ldm_window": True} if cfg.enable_ldm and history is None else {}
        pcfg = dataclasses.replace(pcfg, dict_cap=dcap, **extra)
    check_supported(pcfg)
    dev = resolve_device(device)

    spans: list[tuple[int, int]] = []  # (first_block, nblocks) per item
    rows: list[tuple[np.ndarray, bytes]] = []  # (block, window tail) per block
    for it_i, data in enumerate(items):
        n = len(data)
        nb = max(1, -(-n // N))
        spans.append((len(rows), nb))
        arr = np.frombuffer(data, dtype=np.uint8)
        hist = history[it_i] if history is not None else b""
        for b in range(nb):
            tail = b""
            if windowed:
                # The last dcap bytes of hist + data[:b * N].
                own = data[max(0, b * N - dcap) : b * N]
                tail = hist[max(0, len(hist) + len(own) - dcap):] + own
            rows.append((arr[b * N : min((b + 1) * N, n)], tail))
    B = len(rows)
    Bpad = _bucket(B)
    blocks_np = np.zeros((Bpad, dcap + N), dtype=np.uint8)
    lens_np = np.zeros(Bpad, dtype=np.int32)
    dlens_np = np.zeros(Bpad, dtype=np.int32)
    for b, (chunk, tail) in enumerate(rows):
        blocks_np[b, dcap : dcap + len(chunk)] = chunk
        if tail:
            blocks_np[b, dcap - len(tail) : dcap] = np.frombuffer(tail, np.uint8)
        lens_np[b] = len(chunk)
        dlens_np[b] = len(tail)

    blocks_t = torch.from_numpy(blocks_np).to(dev)
    lens_t = torch.from_numpy(lens_np).to(dev)
    if windowed:
        out = compress_blocks_dict(blocks_t, lens_t, torch.from_numpy(dlens_np).to(dev), pcfg)
    else:
        out = compress_blocks_staged(blocks_t, lens_t, pcfg)
    contents_d = out[0]
    # Two-phase fetch: lengths and types first, then the contents trimmed to
    # the largest non-Raw block (Raw blocks re-use the caller's bytes).
    clens = out[1].cpu().numpy()
    btypes = out[2].cpu().numpy()
    accel = pcfg.ckpt_every and not windowed
    accel_meta = _accel_frames(out, btypes, spans, B, pcfg) if accel else None
    nonraw = btypes[:B] != BLOCK_RAW
    mx = int(clens[:B][nonraw].max()) if nonraw.any() else 1
    width = min(_bucket(max(mx, 64), lo=64), N)
    contents = contents_d[:, :width].cpu().numpy()

    checksum = cfg.checksum != ChecksumPolicy.NONE
    outs = None
    if width == N and all(len(d) for d in items):
        outs = _assemble_native(items, spans, contents, clens, btypes, lens_np, cfg, checksum)
    if outs is None:
        outs = _assemble_python(items, spans, contents, clens, btypes, lens_np, cfg, checksum)
    if accel_meta:
        return [f + m for f, m in zip(outs, accel_meta)]
    return outs


def _assemble_python(items, spans, contents, clens, btypes, lens_np, cfg,
                     checksum) -> list[bytes]:
    """Each item's frame joined in Python; Raw blocks take the caller's
    bytes, an empty item is one empty Raw block."""
    N = cfg.block_size
    outs: list[bytes] = []
    for (first, nb), data in zip(spans, items):
        tail = [content_checksum(data).to_bytes(4, "little")] if checksum else []
        if len(data) == 0:
            outs.append(b"".join([write_frame_header(0, checksum, dict_id=cfg.dict_id),
                                  (1).to_bytes(3, "little"), *tail]))
            continue
        parts = [write_frame_header(len(data), checksum, dict_id=cfg.dict_id,
                                    window_log=cfg.window_log)]
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
    return outs


def _assemble_native(items, spans, contents, clens, btypes, lens_np, cfg,
                     checksum) -> list[bytes] | None:
    """Every item's frame joined by the native assembler (contents whole:
    Raw blocks from the device's copy), then split at the frame sizes that
    the block sizes give; None where no C++ compiler exists."""
    headers = [write_frame_header(len(d), checksum, dict_id=cfg.dict_id,
                                  window_log=cfg.window_log) for d in items]
    checks = [content_checksum(d).to_bytes(4, "little") for d in items] if checksum else None
    firsts = np.array([s[0] for s in spans], dtype=np.int32)
    counts = np.array([s[1] for s in spans], dtype=np.int32)
    blob = assemble_frames(contents, clens, btypes, lens_np[: len(clens)], firsts, counts,
                           headers, checks)
    if blob is None:
        return None
    # Each block is its 3-byte header and its payload (one byte for RLE).
    ends = np.concatenate(([0], np.cumsum(3 + np.where(btypes == BLOCK_RLE, 1, clens),
                                          dtype=np.int64)))
    sizes = (np.array([len(h) for h in headers], dtype=np.int64) + 4 * checksum
             + ends[firsts + counts] - ends[firsts])
    offs = np.concatenate(([0], np.cumsum(sizes))).tolist()
    return [blob[a:b] for a, b in zip(offs[:-1], offs[1:])]


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


class Manager:
    """Single-shot compress / decompress (context-manager friendly), on
    `device` (None means CUDA; raises without it, even where an input then
    takes the host route)."""

    def __init__(self, level: int = 3, config: CompressionConfig | None = None,
                 execution_path: ExecutionPath = ExecutionPath.AUTO, device=None):
        self.config = config or CompressionConfig.from_level(level)
        st = self.config.validate()
        if st != Status.SUCCESS:
            raise ValueError(f"invalid config: {st.name}")
        self.execution_path = execution_path
        self.device = resolve_device(device)
        self.stats = CompressionStats()
        self._closed = False

    def __enter__(self) -> "Manager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        self._closed = True

    def select_execution_path(self, size: int) -> ExecutionPath:
        """Routing by size: inputs under cpu_threshold go to the host codec,
        larger ones to the card, unless the manager was given a path."""
        if self.execution_path != ExecutionPath.AUTO:
            return self.execution_path
        if size < self.config.cpu_threshold:
            return ExecutionPath.CPU
        return ExecutionPath.TPU_BATCH

    def compress(self, data: bytes) -> bytes:
        t0 = time.perf_counter()
        if self.select_execution_path(len(data)) == ExecutionPath.CPU:
            out = self._compress_cpu(data)
        else:
            out = compress_items([data], self.config, device=self.device)[0]
        dt = time.perf_counter() - t0
        self.stats.total_input_bytes += len(data)
        self.stats.total_output_bytes += len(out)
        self.stats.total_frames += 1
        self.stats.total_blocks += max(1, -(-len(data) // self.config.block_size))
        self.stats.total_compress_calls += 1
        self.stats.total_compress_time_s += dt
        return out

    def decompress(self, data: bytes, max_output_size: int | None = None) -> bytes:
        """On the device execution paths, `decompress_batch_tpu` on the card
        (checksum checked unless the policy is NONE); else the host decoder
        (checksum checked under COMPUTE_AND_VERIFY)."""
        t0 = time.perf_counter()
        if self.execution_path in (ExecutionPath.TPU_BATCH, ExecutionPath.TPU_CHUNK):
            from .decompress import decompress_batch_tpu

            out = decompress_batch_tpu(
                [data], verify_checksum=self.config.checksum != ChecksumPolicy.NONE,
                device=self.device)[0]
        else:
            out = _decompress_host(
                data, max_output_size,
                verify=self.config.checksum == ChecksumPolicy.COMPUTE_AND_VERIFY)
        self.stats.total_decompress_calls += 1
        self.stats.total_decompress_time_s += time.perf_counter() - t0
        return out

    def _compress_cpu(self, data: bytes) -> bytes:
        """The host route (`host_compress`: the native engine, as the
        reference's manager tries first)."""
        return host_compress(data, self.config, self.config.checksum != ChecksumPolicy.NONE,
                             self.config.block_size)


def host_compress(data: bytes, cfg: CompressionConfig, checksum: bool = False,
                  block_size: int = 0) -> bytes:
    """One frame on the host at cfg's level: the native engine
    (utils/native.py; block_size 0 keeps its 128 KB), or where no C++
    compiler exists the pure-Python codec (format/frame.py `compress`) with the
    parameters the reference's manager gives it."""
    eng = NativeEngine.create(cfg.level, checksum=checksum, block_size=block_size)
    if eng is not None:
        return eng.compress(data)  # raises where the engine fails
    return host_frame.compress(data, host_frame.CompressParams(
        level=cfg.level, hash_log=min(cfg.hash_log, 16), search_depth=cfg.search_depth,
        min_match=cfg.min_match, lazy=cfg.strategy >= Strategy.LAZY,
        block_size=block_size or BLOCK_SIZE_MAX, checksum=checksum))


def _decompress_host(data: bytes, max_output_size: int | None = None,
                     verify: bool = False) -> bytes:
    """Host decompression of (concatenated) frames with the port's own
    decoder (format/frame.py `decompress`). The reference tries libzstd
    (`zstandard`) first; the port does not use it. max_output_size is
    accepted and unused, as in the reference's fallback."""
    return host_frame.decompress(data, verify_checksum=verify)


def _compress_items_degraded(items: list[bytes], cfg: CompressionConfig, on_degrade=None,
                             device=None) -> list[bytes]:
    """compress_items with the reference's degradation ladder: an
    out-of-memory error on the device halves the batch and retries each
    half, down to single items; a single item that still runs out goes to
    the host (`HybridEngine` forced to the CPU: the native engine).
    on_degrade(n) is called once for each batch of n items that ran out.
    Only torch.cuda.OutOfMemoryError starts the ladder (the reference
    matches "OOM" in any message, which would also catch a kernel's
    failure); any other error propagates."""
    try:
        return compress_items(items, cfg, device=device)
    except torch.cuda.OutOfMemoryError:
        pass  # retry outside the handler: its traceback holds the failed batch's tensors
    if on_degrade is not None:
        on_degrade(len(items))
    if len(items) > 1:
        mid = len(items) // 2
        return (_compress_items_degraded(items[:mid], cfg, on_degrade, device)
                + _compress_items_degraded(items[mid:], cfg, on_degrade, device))
    from .hybrid import HybridConfig, HybridEngine, RoutingMode

    eng = HybridEngine(HybridConfig(mode=RoutingMode.FORCE_CPU), compression=cfg, device=device)
    return [eng.compress(items[0])]


class BatchManager:
    """Batched many-buffer compression (one device batch per call, split and
    retried on an out-of-memory error; `degradations` counts the batches
    that ran out, `host_fallbacks` the single items among them that the
    native engine then compressed on the host) and batch decompression, on
    `device` (None means CUDA; raises without it)."""

    def __init__(self, level: int = 3, config: CompressionConfig | None = None, device=None):
        self.config = config or CompressionConfig.from_level(level)
        self.device = resolve_device(device)
        self.stats = CompressionStats()
        self.degradations = 0
        self.host_fallbacks = 0

    def __enter__(self) -> "BatchManager":
        return self

    def __exit__(self, *exc) -> None:
        pass

    def compress_batch(self, items: list[BatchItem] | list[bytes]) -> list[BatchItem]:
        t0 = time.perf_counter()
        norm = [it if isinstance(it, BatchItem) else BatchItem(it) for it in items]

        def on_degrade(n: int) -> None:
            self.degradations += 1
            self.host_fallbacks += n == 1  # a single item goes to the host

        outs = _compress_items_degraded([it.data for it in norm], self.config, on_degrade,
                                        self.device)
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

    def compress_batch_async(self, items: list[bytes]):
        """Dispatch now, resolve later: compress_batch runs in a worker
        thread; the returned zero-argument resolver waits for it and returns
        its list[BatchItem] (or raises its exception)."""
        import concurrent.futures

        ex = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        fut = ex.submit(self.compress_batch, items)

        def resolve() -> list[BatchItem]:
            try:
                return fut.result()
            finally:
                ex.shutdown(wait=False)

        return resolve

    def decompress_batch_to_device(self, items: list[bytes], max_block: int = 128 * 1024):
        """Decompress into device-resident rows (see api/decompress.py
        `decompress_batch_to_device`): (out, lengths) on the manager's device."""
        from .decompress import decompress_batch_to_device

        return decompress_batch_to_device(items, max_block, device=self.device)

    def decompress_batch(self, items: list[BatchItem] | list[bytes],
                         use_tpu: bool = False) -> list[BatchItem]:
        """Decompress every item; each gets its output and a status.

        use_tpu=True decodes the batch on the manager's device
        (`decompress_batch_tpu`). Only a ValueError raised while the frames
        are parsed on the host, before any device work, sends the batch to
        the per-item host path; any error after that propagates, so a
        failure of the card or of a kernel is never hidden. The host path
        (use_tpu=False, or that fall-through) decodes item by item and marks
        an item it cannot decode ERROR_CORRUPT_DATA."""
        t0 = time.perf_counter()
        norm = [it if isinstance(it, BatchItem) else BatchItem(it) for it in items]
        if use_tpu:
            from .decompress import decode_parsed, parse_batch

            try:
                parsed = parse_batch([it.data for it in norm]) if norm else None
            except ValueError:
                parsed = None
            if parsed is not None:
                outs = decode_parsed(parsed, device=self.device)
                for it, out in zip(norm, outs):
                    it.output, it.status = out, Status.SUCCESS
                self.stats.total_decompress_calls += 1
                self.stats.total_decompress_time_s += time.perf_counter() - t0
                return norm
        for it in norm:
            try:
                it.output = _decompress_host(it.data)
                it.status = Status.SUCCESS
            except Exception:
                it.output = None
                it.status = Status.ERROR_CORRUPT_DATA
        self.stats.total_decompress_calls += 1
        self.stats.total_decompress_time_s += time.perf_counter() - t0
        return norm


class StreamingManager:
    """One zstd frame across `compress_chunk` calls, on `device` (None means
    CUDA; raises without it): the frame header (no content size, the
    config's window_log or 2^20) with the first chunk, each chunk's blocks
    (`compress_items` of the chunk, its frame header and checksum stripped
    and its last-block flag cleared), then `flush`: an empty last Raw block
    and, if asked for, the checksum of every chunk. With window_history each
    chunk's blocks reach back into the chunks before it, up to the window
    `compress_items` gives a block (64 KB, or 2^window_log up to 1 MiB). The
    decompress half is a `StreamingDecompressor` on the host."""

    def __init__(self, level: int = 3, config: CompressionConfig | None = None,
                 window_history: bool = True, device=None):
        self.config = config or CompressionConfig.from_level(level)
        self.window_history = window_history
        self.device = resolve_device(device)
        self._dec = None
        self.reset()

    def reset(self) -> None:
        self._started = False
        self._finished = False
        self._hasher_data = bytearray()
        self._history = b""
        self.stats = CompressionStats()

    def _header(self) -> bytes:
        self._started = True
        return write_frame_header(None, checksum=self.config.checksum != ChecksumPolicy.NONE,
                                  dict_id=self.config.dict_id,
                                  window_log=self.config.window_log or 20)

    def compress_chunk(self, chunk: bytes) -> bytes:
        """The chunk as blocks of the stream's frame (the header first, on
        the first call)."""
        if self._finished:
            raise RuntimeError("stream finished; call reset()")
        out = bytearray()
        if not self._started:
            out += self._header()
        if self.config.checksum != ChecksumPolicy.NONE:
            self._hasher_data += chunk
        if chunk:
            hist = [self._history] if self.window_history else None
            frame, = compress_items([chunk], self.config, history=hist, device=self.device)
            out += _strip_frame_to_blocks(frame, clear_last=True)
        if self.window_history:
            self._history = (self._history + chunk)[-_window_cap(self.config):]
        self.stats.total_input_bytes += len(chunk)
        self.stats.total_output_bytes += len(out)
        return bytes(out)

    def flush(self) -> bytes:
        """End the frame: an empty last Raw block and the checksum."""
        if self._finished:
            return b""
        out = bytearray()
        if not self._started:
            out += self._header()
        out += (1).to_bytes(3, "little")  # empty Raw block, last=1
        if self.config.checksum != ChecksumPolicy.NONE:
            out += content_checksum(bytes(self._hasher_data)).to_bytes(4, "little")
        self._finished = True
        return bytes(out)

    def decompress_chunk(self, data: bytes) -> bytes:
        """Incremental decode of a compressed stream (StreamingDecompressor)."""
        if self._dec is None:
            self._dec = StreamingDecompressor()
        return self._dec.decompress_chunk(data)

    def decompress_flush(self) -> bytes:
        return b"" if self._dec is None else self._dec.flush()

    def decompress_reset(self) -> None:
        if self._dec is not None:
            self._dec.reset()


def _strip_frame_to_blocks(frame: bytes, clear_last: bool) -> bytes:
    """The block stream of a single frame, without its header and checksum;
    with clear_last, the final block's last flag cleared."""
    pos = parse_frame_header(frame).header_size
    blocks = bytearray()
    while True:
        bh = int.from_bytes(frame[pos : pos + 3], "little")
        last = bh & 1
        size = 1 if (bh >> 1) & 3 == BLOCK_RLE else bh >> 3
        blocks += (bh & ~1 if clear_last else bh).to_bytes(3, "little")
        blocks += frame[pos + 3 : pos + 3 + size]
        pos += 3 + size
        if last:
            break
    return bytes(blocks)


class StreamingDecompressor:
    """Incremental frame decoder on the host (the reference's
    StreamingDecompressor): feed arbitrary byte chunks; decoded bytes come
    back as soon as whole blocks are in. Window history, repeat offsets,
    Repeat-mode FSE tables and the treeless Huffman table persist across
    chunk boundaries (RFC 8878 §3.1.1.5); checksums are checked
    incrementally (streaming XXH64, no full-output buffering);
    back-to-back frames and skippable frames are handled."""

    def __init__(self, window_cap: int = 1 << 23, verify_checksum: bool = True):
        self.window_cap = window_cap
        self.verify_checksum = verify_checksum
        self.reset()

    def reset(self) -> None:
        self._buf = bytearray()
        self._phase = "frame_header"
        self._hdr = None
        self._content_len = 0
        self.frames_completed = 0
        self._reset_frame_state()

    def _reset_frame_state(self) -> None:
        self._window = b""
        self._rep = list(REPCODE_INIT)
        self._seq_tables = None
        self._huff = None
        self._hash = XXH64State()

    @property
    def at_frame_boundary(self) -> bool:
        """True when no partial frame is pending (flush would succeed)."""
        return self._phase == "frame_header" and not self._buf

    def decompress_chunk(self, data: bytes) -> bytes:
        """Consume more compressed bytes; return the newly decoded bytes."""
        self._buf += data
        out = bytearray()
        while True:
            buf = self._buf
            if self._phase == "frame_header":
                if len(buf) < 4:
                    break
                magic = int.from_bytes(buf[:4], "little")
                if SKIPPABLE_MAGIC_MIN <= magic <= SKIPPABLE_MAGIC_MAX:
                    if len(buf) < 8:
                        break
                    size = int.from_bytes(buf[4:8], "little")
                    if len(buf) < 8 + size:
                        break
                    del self._buf[: 8 + size]
                    continue
                if magic != ZSTD_MAGIC:
                    raise ValueError(f"bad magic 0x{magic:08X}")
                if len(buf) < 5:
                    break
                fhd = buf[4]
                fcs_flag, single_segment, did_flag = fhd >> 6, (fhd >> 5) & 1, fhd & 3
                need = (5 + (0 if single_segment else 1) + (0, 1, 2, 4)[did_flag]
                        + ((1 if single_segment else 0), 2, 4, 8)[fcs_flag])
                if len(buf) < need:
                    break
                self._hdr = parse_frame_header(bytes(buf[:need]))
                del self._buf[:need]
                self._phase = "blocks"
                self._content_len = 0
                self._reset_frame_state()
                continue
            if self._phase == "blocks":
                if len(buf) < 3:
                    break
                bh = int.from_bytes(buf[:3], "little")
                last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
                body_len = 1 if btype == BLOCK_RLE else bsize
                if len(buf) < 3 + body_len:
                    break
                body = bytes(buf[3 : 3 + body_len])
                del self._buf[: 3 + body_len]
                if btype == BLOCK_RAW:
                    decoded = body
                elif btype == BLOCK_RLE:
                    decoded = body[:1] * bsize
                elif btype == BLOCK_COMPRESSED:
                    lit = decode_literals_section(body, self._huff)
                    self._huff = lit.huff_table
                    seqs, new_tables, _ = decode_sequences_section(body[lit.consumed :],
                                                                   self._seq_tables)
                    if seqs is not None:
                        self._seq_tables = new_tables
                    decoded, self._rep = execute_sequences(lit.data, seqs, self._rep,
                                                           window=self._window)
                else:
                    raise ValueError("reserved block type")
                out += decoded
                self._content_len += len(decoded)
                self._window = (self._window + decoded)[-self.window_cap :]
                if self.verify_checksum and self._hdr.has_checksum:
                    self._hash.update(decoded)
                if last:
                    cs = self._hdr.content_size
                    if cs is not None and self._content_len != cs:
                        raise ValueError(f"content size mismatch: {self._content_len} != {cs}")
                    self._phase = "checksum" if self._hdr.has_checksum else "frame_header"
                    if self._phase == "frame_header":
                        self.frames_completed += 1
                continue
            if self._phase == "checksum":
                if len(buf) < 4:
                    break
                stored = int.from_bytes(buf[:4], "little")
                del self._buf[:4]
                if self.verify_checksum and stored != (self._hash.digest() & 0xFFFFFFFF):
                    raise ValueError("content checksum mismatch")
                self.frames_completed += 1
                self._phase = "frame_header"
                continue
        return bytes(out)

    def flush(self) -> bytes:
        """Check that the stream ended at a frame boundary (blocks decode
        eagerly, so nothing is buffered)."""
        if not self.at_frame_boundary:
            raise ValueError("incomplete frame at flush")
        return b""
