"""Dictionary training (COVER-style) and dictionary compression.

The port's copy of tpu_zstd/dictionary.py. Training is numpy on the host
(d-mer counts by sorting, sliding-window segment scores, a greedy pick of
the best segments). Dictionaries are raw content: every byte is a match
source, and stock libzstd decodes the frames given the same content as a
raw-content dictionary. `write_structured_dictionary` wraps the content in
the magic-0xEC30A437 envelope with its ID.

`compress_with_dict` puts the dictionary's tail before each block as a
window prefix and compresses the batch on the card
(ops/pipeline.py `compress_blocks_dict`); `decompress_with_dict` decodes
with the port's host decoder, the dictionary as window history (the
reference tries libzstd first; the port does not use it).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .constants import BLOCK_RLE, DICT_MAGIC

DICT_SIZE_MIN = 256
DICT_SIZE_MAX = 128 * 1024


@dataclass
class CoverParams:
    """Training knobs."""

    d: int = 8           # d-mer length scored during selection
    segment: int = 256   # candidate segment length (k in COVER terms)
    max_samples_bytes: int = 4 << 20
    level: int = 3


@dataclass
class Dictionary:
    """Trained dictionary: raw content + optional ID."""

    content: bytes
    dict_id: int = 0

    def __len__(self) -> int:
        return len(self.content)


def _dmer_counts(data: np.ndarray, d: int) -> np.ndarray:
    """count[i] = frequency of the d-mer starting at i (0 past the end)."""
    n = len(data)
    if n < d:
        return np.zeros(n, dtype=np.int64)
    # 8-byte d-mers as u64 keys (d <= 8).
    key = np.zeros(n - d + 1, dtype=np.uint64)
    for k in range(d):
        key |= data[k : n - d + 1 + k].astype(np.uint64) << np.uint64(8 * k)
    order = np.argsort(key, kind="stable")
    sk = key[order]
    # run-length counts over the sorted keys
    boundary = np.empty(len(sk), dtype=bool)
    boundary[0] = True
    boundary[1:] = sk[1:] != sk[:-1]
    run_id = np.cumsum(boundary) - 1
    run_sizes = np.bincount(run_id)
    counts_sorted = run_sizes[run_id]
    counts = np.zeros(n, dtype=np.int64)
    counts[order] = counts_sorted
    return counts


def train_dictionary(
    samples: list[bytes],
    dict_size: int = 16384,
    params: CoverParams | None = None,
) -> Dictionary:
    """COVER-style selection of high-coverage segments from the samples."""
    params = params or CoverParams()
    dict_size = max(DICT_SIZE_MIN, min(DICT_SIZE_MAX, dict_size))
    if not samples:
        raise ValueError("no samples")
    blob = b"\x00".join(samples)  # separator avoids cross-sample d-mers
    blob = blob[: params.max_samples_bytes]
    data = np.frombuffer(blob, dtype=np.uint8)
    n = len(data)
    seg = min(params.segment, max(64, dict_size // 4))
    if n < seg:
        return Dictionary(blob[:dict_size], _dict_id(blob[:dict_size]))

    counts = _dmer_counts(data, params.d)
    # A d-mer that appears once covers nothing; score repeats only.
    score1 = np.where(counts > 1, counts, 0).astype(np.float64)
    # Sliding-window segment scores (cumsum trick).
    cs = np.concatenate([[0.0], np.cumsum(score1)])
    seg_scores = cs[seg:] - cs[:-seg]  # score of segment starting at i

    # Greedy top-segment selection with overlap suppression.
    order = np.argsort(-seg_scores, kind="stable")
    taken = np.zeros(n, dtype=bool)
    chosen: list[tuple[float, int]] = []
    total = 0
    for start in order:
        if total >= dict_size:
            break
        if seg_scores[start] <= 0:
            break
        if taken[start : start + seg].any():
            continue
        taken[start : start + seg] = True
        chosen.append((float(seg_scores[start]), int(start)))
        total += seg
    if not chosen:
        content = blob[:dict_size]
        return Dictionary(content, _dict_id(content))
    # Most valuable segments go last (closest to the payload: the cheapest
    # offsets).
    chosen.sort(key=lambda t: t[0])
    content = b"".join(blob[s : s + seg] for _, s in chosen)[:dict_size]
    return Dictionary(content, _dict_id(content))


def _dict_id(content: bytes) -> int:
    """Deterministic non-zero ID (FNV-1a of the first 1 KB)."""
    h = 2166136261
    for b in content[:1024]:
        h = ((h ^ b) * 16777619) & 0xFFFFFFFF
    return (h % 0xFFFFFFFE) + 1


def write_structured_dictionary(d: Dictionary) -> bytes:
    """Magic-envelope form: magic + dict_id + content (no entropy tables)."""
    return DICT_MAGIC.to_bytes(4, "little") + d.dict_id.to_bytes(4, "little") + d.content


def read_dictionary(data: bytes) -> Dictionary:
    if len(data) >= 8 and int.from_bytes(data[:4], "little") == DICT_MAGIC:
        return Dictionary(data[8:], int.from_bytes(data[4:8], "little"))
    return Dictionary(data, 0)


# --- Dictionary compression -----------------------------------------------------------


def compress_with_dict(
    items: list[bytes], dictionary: Dictionary, config=None, device=None
) -> list[bytes]:
    """Compress small records against a shared dictionary in one device
    batch, on `device` (None means CUDA).

    Each block's row holds the dictionary's last dict_cap bytes (dict_cap:
    the power of two from 1 KB covering the dictionary, up to 128 KB) before
    the payload, searched over the whole row. Frames carry no dictionary ID
    (raw-content semantics) and no checksum; the window covers dictionary
    and content, so no frame is single-segment.
    """
    from .api.config import CompressionConfig
    from .api.manager import _bucket
    from .format.frame import write_frame_header
    from .ops.pipeline import PipelineConfig, check_supported, compress_blocks_dict, resolve_device

    cfg = config or CompressionConfig.from_level(3)
    dcap = 1024
    while dcap < min(len(dictionary.content), DICT_SIZE_MAX):
        dcap *= 2
    dtail = dictionary.content[-dcap:]
    dlen = len(dtail)

    N = cfg.block_size
    pcfg = PipelineConfig(
        block_size=N, hash_log=cfg.hash_log, depth=cfg.search_depth,
        cap=cfg.compare_cap, min_match=cfg.min_match, dict_cap=dcap,
    )
    check_supported(pcfg)
    dev = resolve_device(device)
    spans = []
    chunks = []
    for data in items:
        n = len(data)
        nb = max(1, -(-n // N))
        spans.append((len(chunks), nb))
        arr = np.frombuffer(data, dtype=np.uint8)
        chunks += [arr[b * N : min((b + 1) * N, n)] for b in range(nb)]
    B = len(chunks)
    Bpad = _bucket(B)
    blocks_np = np.zeros((Bpad, dcap + N), dtype=np.uint8)
    if B:
        blocks_np[:B, dcap - dlen : dcap] = np.frombuffer(dtail, dtype=np.uint8)
    lens_np = np.zeros(Bpad, dtype=np.int32)
    for b, chunk in enumerate(chunks):
        blocks_np[b, dcap : dcap + len(chunk)] = chunk
        lens_np[b] = len(chunk)
    dlens_np = np.full(Bpad, dlen, dtype=np.int32)

    out = compress_blocks_dict(torch.from_numpy(blocks_np).to(dev),
                               torch.from_numpy(lens_np).to(dev),
                               torch.from_numpy(dlens_np).to(dev), pcfg)
    clens = out[1].cpu().numpy()
    btypes = out[2].cpu().numpy()
    contents = out[0][:, : max(1, int(clens[:B].max()) if B else 1)].cpu().numpy()

    outs = []
    for (first, nb), data in zip(spans, items):
        wlog = max(10, (dlen + max(len(data), 1) - 1).bit_length())
        parts = [write_frame_header(len(data), window_log=wlog)]
        for kk in range(nb):
            b = first + kk
            last = 1 if kk == nb - 1 else 0
            btype, clen = int(btypes[b]), int(clens[b])
            if btype == BLOCK_RLE:
                size, body = int(lens_np[b]), contents[b, :1]
            else:
                size, body = clen, contents[b, :clen]
            parts += [((size << 3) | (btype << 1) | last).to_bytes(3, "little"), body.tobytes()]
        outs.append(b"".join(parts))
    return outs


def decompress_with_dict(data: bytes, dictionary: Dictionary,
                         max_output_size: int | None = None) -> bytes:
    """Decode a dictionary frame on the host (format/frame.py
    `decompress_frame_with_window`, the dictionary content as window
    history). max_output_size is accepted and unused."""
    from .format.frame import decompress_frame_with_window

    return decompress_frame_with_window(data, dictionary.content)
