"""Batched block compression pipeline and host frame assembly.

Counterpart of tpu_zstd/ops/pipeline.py: the full LZ77 parse, the literal
section (Huffman or raw), the sequence section (per-block custom FSE tables
or the predefined ones) and the frame, byte-identical to the JAX package at
the same `PipelineConfig`. `DEFAULT_CONFIG` (Huffman literals, custom FSE) is
the default, as there; `SLICE_CONFIG` (raw literals, predefined tables) stays
as a named configuration. A batch is a (B, block_size) uint8 tensor plus (B,)
payload lengths; the work runs on the tensors' device.

Staged as in the JAX package: the parse runs first, the host reads max(nseq)
to pick a sequence-bucket width, then the encode and assembly run at that
width. `compress_blocks_staged_many` keeps one batch's parse in flight while
the previous batch's nseq crosses to the host. `compress_blocks_dict` runs
rows with a window prefix (`dict_cap` bytes before each payload: a
dictionary's tail or the stream before the block) with the JAX package's
coarser sequence ladder.
"""

from __future__ import annotations

import collections
import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from ..constants import BLOCK_COMPRESSED, BLOCK_RAW, BLOCK_RLE, BLOCK_SIZE_MAX
from ..format.frame import write_frame_header
from ..format.xxhash import content_checksum
from .bitpack import place
from .fse import encode_prepared, encode_sequences_predefined, prepare_sequences_auto
from .huffman import compress_literals_huffman, huff_payload_cap
from .lz77 import BlockSequences, parse_block


@dataclass(frozen=True)
class PipelineConfig:
    """Pipeline parameters; a copy of the JAX package's fields and defaults.
    The port runs the subset `check_supported` accepts."""

    block_size: int = BLOCK_SIZE_MAX
    hash_log: int = 17
    depth: int = 8
    cap: int = 8
    min_match: int = 4
    lazy: bool = True
    optimal: bool = False
    dict_cap: int = 0
    huffman_literals: bool = True
    custom_fse: bool = True
    seg_log: int = 10
    ckpt_every: int = 0
    lit_ckpt_every: int = 1024
    of_gate: tuple = (8, 12)
    mf_win_log: int = 13
    ldm: bool = False
    ldm_window: bool = False
    sample_log: int = 0
    dec_min_ml: int = 0

    @property
    def eff_mf_win_log(self) -> int:
        if self.dict_cap and not (self.ldm_window and self.ldm):
            return 0  # a dictionary prefix must stay visible to every position
        return self.mf_win_log

    @property
    def max_seqs(self) -> int:
        # block_size / 4 at min_match 3 too: a block that parses into more
        # sequences becomes Raw (the overflow poison of the parse).
        return self.block_size // 4

    @property
    def seq_cap(self) -> int:
        """Sequence-section byte capacity at the full sequence width."""
        return self.seq_cap_for(self.max_seqs)

    def seq_cap_for(self, msb: int) -> int:
        """Sequence-section byte capacity for an nseq bucket of msb entries
        (40 bits per sequence plus header room, 4096-aligned)."""
        return -(-((msb * 40) // 8 + 1024) // 4096) * 4096


DEFAULT_CONFIG = PipelineConfig()
# Raw literals and the predefined FSE tables (the port's first slice).
SLICE_CONFIG = PipelineConfig(huffman_literals=False, custom_fse=False)


def check_supported(cfg: PipelineConfig) -> None:
    """Raise NotImplementedError for a setting the port does not run."""
    N = cfg.block_size
    if cfg.min_match not in (3, 4):
        raise NotImplementedError("only min_match 3 and 4 are supported")
    if cfg.seg_log > 10 or N % (1 << cfg.seg_log):
        raise NotImplementedError("seg_log must be <= 10 and divide the block")
    if cfg.cap >= 1 << 10:
        raise NotImplementedError("cap must be < 1024")
    if cfg.optimal and min(cfg.cap, 127) - cfg.min_match >= 96:
        raise NotImplementedError("the optimal parse's cost bank holds 96 match lengths")
    if cfg.ckpt_every and not cfg.custom_fse:
        raise NotImplementedError("decode checkpoints (ckpt_every) need custom_fse")


def config_from_reference(d: dict) -> PipelineConfig:
    """The port's config from `dataclasses.asdict` of a JAX PipelineConfig.
    Raises ValueError on an unknown field and NotImplementedError on a
    setting the port does not run."""
    names = {f.name for f in dataclasses.fields(PipelineConfig)}
    unknown = sorted(set(d) - names)
    if unknown:
        raise ValueError(f"unknown PipelineConfig fields: {unknown}")
    kw = dict(d)
    if "of_gate" in kw:
        kw["of_gate"] = tuple(kw["of_gate"])
    cfg = PipelineConfig(**kw)
    check_supported(cfg)
    return cfg


def resolve_device(device=None) -> torch.device:
    """None means CUDA; raise when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda.is_available() is False")
    return dev


def _parse_one(blocks: torch.Tensor, lengths: torch.Tensor, cfg: PipelineConfig,
               dlens=None) -> BlockSequences:
    """Parse stage for a batch (one row per block; the JAX version is the
    per-block function it vmaps). Rows are (dict_cap + N): padding, then
    dlens window bytes, then the payload."""
    DC = cfg.dict_cap
    return parse_block(
        blocks,
        DC + lengths.to(torch.int64),
        max_seqs=cfg.max_seqs,
        hash_log=cfg.hash_log,
        depth=cfg.depth,
        cap=cfg.cap,
        min_match=cfg.min_match,
        lazy=cfg.lazy,
        seg_log=cfg.seg_log,
        of_gate=cfg.of_gate,
        mf_win_log=cfg.eff_mf_win_log,
        optimal=cfg.optimal,
        ldm=cfg.ldm,
        block_start=DC,
        win_start=0 if dlens is None else DC - dlens.to(torch.int64),
        sample_log=cfg.sample_log,
        dec_min_ml=cfg.dec_min_ml,
    )


def _lit_compressed_header(regen, comp, hdr_len) -> torch.Tensor:
    """Compressed_Literals_Block header bytes (B, 5) (RFC 8878 §3.1.1.3.1.2):
    LSB-first [type=2 (2b) | size_format (2b) | regen (rb) | comp (rb)] with
    rb = 10/14/18 for size_format 1/2/3 (always 4 streams)."""
    sf = hdr_len - 2                 # 3->1, 4->2, 5->3
    rb = (hdr_len - 3) * 4 + 10      # 10/14/18
    regen = regen & ((1 << rb) - 1)
    low = 2 | (sf << 2) | (regen << 4)
    shift_c = 4 + rb
    out = []
    for i in range(5):
        # comp bits land at bit (4 + rb): for byte i they sit at 8i - (4 + rb).
        s_pos = 8 * i - shift_c
        right = (comp >> torch.clamp(s_pos, 0, 31)) & 0xFF
        left = (comp << torch.clamp(-s_pos, 0, 31)) & 0xFF
        out.append(((low >> (8 * i)) & 0xFF) | torch.where(s_pos >= 0, right, left))
    return torch.stack(out, -1).to(torch.uint8)


def _assemble_one(blocks, n, lits, nlit, nseq, seq_bytes, seq_len, cfg: PipelineConfig):
    """Literal section + block-type decision + body composition, per row.

    Returns (content (B, N) uint8, content_len (B,), block_type (B,)): the
    block body without its 3-byte header (the frame assembler adds it, since
    the `last` flag is frame-level). With decode checkpoints and Huffman
    literals also (lit_ck (B, 4, nck), lit_used (B,)): the literal decode
    checkpoints and whether they are live (the block is Compressed with
    Huffman literals).
    """
    N = cfg.block_size
    B = blocks.shape[0]
    n = n.to(torch.int64)

    # Raw literals section header (RFC 8878 §3.1.1.3.1.1).
    lit_hdr_len = torch.where(nlit < 32, 1, torch.where(nlit < 4096, 2, 3))
    v2 = (nlit << 4) | (1 << 2)
    v3 = (nlit << 4) | (3 << 2)
    lh = torch.stack(
        [
            torch.where(nlit < 32, nlit << 3, torch.where(nlit < 4096, v2 & 0xFF, v3 & 0xFF)),
            torch.where(nlit < 4096, (v2 >> 8) & 0xFF, (v3 >> 8) & 0xFF),
            (v3 >> 16) & 0xFF,
        ],
        dim=1,
    ).to(torch.uint8)

    litcap = N + 4096
    litsec = place(lh, lit_hdr_len, 0, litcap) + place(lits[:, :N], nlit, lit_hdr_len, litcap)
    lit_sec_len = lit_hdr_len + nlit
    if cfg.huffman_literals:
        # Huffman literals where valid and smaller than the raw section.
        hcap = huff_payload_cap(N)
        hpay, hlen, h_ok, *lit_ck = compress_literals_huffman(
            lits[:, :N], nlit, hcap, cfg.lit_ckpt_every if cfg.ckpt_every else 0
        )
        h_hdr_len = torch.where(
            (nlit < 1024) & (hlen < 1024), 3,
            torch.where((nlit < 16384) & (hlen < 16384), 4, 5),
        )
        hh = _lit_compressed_header(nlit, hlen, h_hdr_len)
        huff_total = h_hdr_len + hlen
        use_h = h_ok & (huff_total < lit_sec_len)
        litcap_h = max(N + 4096, hcap + 4096)
        litsec_h = place(hh, h_hdr_len, 0, litcap_h) + place(hpay, hlen, h_hdr_len, litcap_h)
        litsec = torch.where(use_h[:, None], litsec_h, place(litsec, lit_sec_len, 0, litcap_h))
        lit_sec_len = torch.where(use_h, huff_total, lit_sec_len)
    body_len = lit_sec_len + seq_len

    # Block type decision. RLE: the whole block is one repeated byte.
    payload = blocks[:, cfg.dict_cap : cfg.dict_cap + N]
    pos = torch.arange(N, device=blocks.device)
    all_same = ((payload != payload[:, :1]) & (pos < n[:, None])).sum(-1) == 0
    is_rle = all_same & (n >= 2)
    is_comp = ~is_rle & (body_len < n) & (nseq > 0)
    btype = torch.where(is_rle, BLOCK_RLE, torch.where(is_comp, BLOCK_COMPRESSED, BLOCK_RAW))
    content_len = torch.where(is_rle, 1, torch.where(is_comp, body_len, n))

    # Body: literal section at 0 + sequence section rolled to lit_sec_len.
    # The body is used only when body_len < n <= N.
    body = place(litsec, lit_sec_len, 0, N) + place(seq_bytes, seq_len, lit_sec_len, N)
    content = torch.where(
        is_rle[:, None],
        payload[:, :1].expand(B, N),
        torch.where(is_comp[:, None], body, payload),
    )
    if cfg.ckpt_every and cfg.huffman_literals:
        return content, content_len, btype, lit_ck[0], is_comp & use_h
    return content, content_len, btype


def _parse_prep_stage(blocks: torch.Tensor, lengths: torch.Tensor, cfg: PipelineConfig):
    seqs = _parse_one(blocks, lengths, cfg)
    return seqs, seqs.nseq


def _encode_stage(blocks, lengths, seqs: BlockSequences, cfg: PipelineConfig, msb: int):
    """Sequence encode at bucket width msb, then assembly.

    Returns (content, clens, btypes); with decode checkpoints (custom FSE
    tables) the reference's (content, clens, btypes, ck_bits, ck_states,
    ck_rep, nseq[, lit_ck, lit_used, nlit]), the last three with Huffman
    literals.
    """
    cap = cfg.seq_cap_for(msb)
    ll, ml, ob = seqs.ll[:, :msb], seqs.ml[:, :msb], seqs.ob[:, :msb]
    ck = ()
    if cfg.custom_fse:
        off = seqs.off[:, :msb] if cfg.ckpt_every else None
        prep = prepare_sequences_auto(ll, ml, ob, seqs.nseq, msb, off)
        seq_bytes, seq_len, *ck = encode_prepared(prep, seqs.nseq, msb, cap, cfg.ckpt_every)
        ck = tuple(ck)
    else:  # check_supported: no checkpoints here
        seq_bytes, seq_len = encode_sequences_predefined(ll, ml, ob, seqs.nseq, msb, cap)
    out = _assemble_one(
        blocks, lengths, seqs.lits, seqs.nlit, seqs.nseq, seq_bytes, seq_len, cfg
    )
    if cfg.ckpt_every:
        lit_extra = out[3:] + (seqs.nlit,) if cfg.huffman_literals else ()
        return out[:3] + ck + (seqs.nseq,) + lit_extra
    return out


# Bucket ladder for the sequence encode: the smallest entry covering
# max(nseq) sets the encode width (all multiples of the state-chain CHUNK).
_BUCKETS = (2048, 4096, 8192, 12288, 16384, 20480, 21760, 24576, 28672)


def _pick_bucket(bmax: int, full: int) -> int:
    return next((b for b in _BUCKETS if b < full and bmax <= b), full)


def compress_blocks_staged(blocks: torch.Tensor, lengths: torch.Tensor, cfg: PipelineConfig):
    """Batched block compression: blocks (B, N) uint8 + lengths (B,) ->
    (contents (B, N) uint8, content_lens (B,), block_types (B,)), on the
    blocks' device; with decode checkpoints the `_encode_stage` tuple."""
    check_supported(cfg)
    seqs, nseq = _parse_prep_stage(blocks, lengths, cfg)
    msb = _pick_bucket(int(nseq.max()), cfg.max_seqs)
    return _encode_stage(blocks, lengths, seqs, cfg, msb)


def compress_blocks_dict(blocks: torch.Tensor, lengths: torch.Tensor, dlens: torch.Tensor,
                         cfg: PipelineConfig):
    """Batched compression of rows with a window prefix: blocks
    (B, dict_cap + N) uint8 laid out [padding | dlens window bytes |
    payload], lengths the payload lengths. Returns what `_assemble_one`
    does, on the blocks' device.

    The sequence encode is the JAX package's in-graph ladder: the tables
    are chosen once at the full sequence width, then the chains, deposit
    and assembly run at 2048, 4096 or the full width, the first covering
    max(nseq) (one scalar read by the host), always with the full width's
    section capacity."""
    check_supported(cfg)
    seqs = _parse_one(blocks, lengths, cfg, dlens)
    full = cfg.max_seqs
    rungs = [b for b in _BUCKETS[:2] if b < full] + [full]
    bmax = int(seqs.nseq.max())
    msb = rungs[sum(bmax > b for b in rungs[:-1])]
    if cfg.custom_fse:
        prep = prepare_sequences_auto(seqs.ll, seqs.ml, seqs.ob, seqs.nseq, full)
        seq_bytes, seq_len = encode_prepared(prep, seqs.nseq, msb, cfg.seq_cap)
    else:
        seq_bytes, seq_len = encode_sequences_predefined(
            seqs.ll[:, :msb], seqs.ml[:, :msb], seqs.ob[:, :msb], seqs.nseq, msb, cfg.seq_cap)
    return _assemble_one(blocks, lengths, seqs.lits, seqs.nlit, seqs.nseq, seq_bytes, seq_len,
                         cfg)


def compress_blocks_staged_many(batches, cfg: PipelineConfig):
    """Pipelined staged compression over an iterable of (blocks, lengths).

    Each batch's nseq goes to pinned host memory by a non-blocking copy
    recorded with an event; the host reads it one batch later, so the
    bucket choice does not stall the next batch's parse.
    Returns a list of (contents, content_lens, block_types) device tuples.
    """
    check_supported(cfg)
    results = []
    pending = collections.deque()
    for blocks, lengths in batches:
        seqs, nseq = _parse_prep_stage(blocks, lengths, cfg)
        if nseq.device.type == "cuda":
            host = torch.empty(nseq.shape, dtype=nseq.dtype, pin_memory=True)
            host.copy_(nseq, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
        else:
            host, ready = nseq, None
        pending.append((blocks, lengths, seqs, host, ready))
        if len(pending) >= 2:
            results.append(_drain_one(pending, cfg))
    while pending:
        results.append(_drain_one(pending, cfg))
    return results


def _drain_one(pending, cfg: PipelineConfig):
    blocks, lengths, seqs, host, ready = pending.popleft()
    if ready is not None:
        ready.synchronize()
    msb = _pick_bucket(int(host.max()), cfg.max_seqs)
    return _encode_stage(blocks, lengths, seqs, cfg, msb)


# --- Host-side framing ---------------------------------------------------------------


def _split_blocks(data: bytes, block_size: int) -> tuple[np.ndarray, np.ndarray]:
    n = len(data)
    nblocks = max(1, -(-n // block_size))
    blocks = np.zeros((nblocks, block_size), dtype=np.uint8)
    lengths = np.zeros(nblocks, dtype=np.int32)
    arr = np.frombuffer(data, dtype=np.uint8)
    for b in range(nblocks):
        chunk = arr[b * block_size : min((b + 1) * block_size, n)]
        blocks[b, : len(chunk)] = chunk
        lengths[b] = len(chunk)
    return blocks, lengths


def compress(
    data: bytes, cfg: PipelineConfig = DEFAULT_CONFIG, checksum: bool = False, device=None
) -> bytes:
    """Single-shot compression of one buffer into one zstd frame, on `device`
    (None means CUDA). checksum=True appends the content checksum. Blocks
    are compressed on their own: a dict_cap needs rows with their window
    prefix (`compress_blocks_dict`) and raises ValueError here."""
    check_supported(cfg)
    if cfg.dict_cap:
        raise ValueError("dict_cap needs rows with a window prefix: use compress_blocks_dict")
    dev = resolve_device(device)
    tail = [content_checksum(data).to_bytes(4, "little")] if checksum else []
    if len(data) == 0:
        # Empty raw last block.
        return b"".join([write_frame_header(0, checksum), (1).to_bytes(3, "little"), *tail])
    blocks, lengths = _split_blocks(data, cfg.block_size)
    contents, clens, btypes = compress_blocks_staged(
        torch.from_numpy(blocks).to(dev), torch.from_numpy(lengths).to(dev), cfg
    )[:3]
    contents = contents.cpu().numpy()
    clens = clens.cpu().numpy()
    btypes = btypes.cpu().numpy()
    parts = [write_frame_header(len(data), checksum)]
    nblocks = len(lengths)
    for b in range(nblocks):
        last = 1 if b == nblocks - 1 else 0
        btype = int(btypes[b])
        if btype == BLOCK_RLE:
            hdr = (int(lengths[b]) << 3) | (BLOCK_RLE << 1) | last
            parts.append(hdr.to_bytes(3, "little"))
            parts.append(contents[b, :1].tobytes())
        else:
            clen = int(clens[b])
            hdr = (clen << 3) | (btype << 1) | last
            parts.append(hdr.to_bytes(3, "little"))
            parts.append(contents[b, :clen].tobytes())
    return b"".join(parts + tail)
