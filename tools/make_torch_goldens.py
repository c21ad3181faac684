"""Write the full-width goldens the PyTorch port is held against.

Runs the JAX reference (tpu_zstd) on the CPU at the port's configuration
(raw literals, predefined FSE tables; every other field at DEFAULT_CONFIG)
over the bench corpus:

- one batch of 128 x 128 KB blocks (bench.make_corpus(128 * 131072)):
  per-block block type, content length and sha256 of the content;
- one frame of make_corpus(4 * 131072) through `compress`: length and sha256.

Stock libzstd (`zstandard`) must decode both frames before anything is
written. The result goes to tests/golden/torch_slice1.json, which
chip_smoke.py and the tier-1 tests read.

    JAX_PLATFORMS=cpu python tools/make_torch_goldens.py   # ~3 minutes
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import zstandard  # noqa: E402

from bench import make_corpus  # noqa: E402
from tpu_zstd.constants import BLOCK_RLE  # noqa: E402
from tpu_zstd.format.frame import write_frame_header  # noqa: E402
from tpu_zstd.ops.pipeline import (  # noqa: E402
    PipelineConfig,
    _split_blocks,
    compress,
    compress_blocks_staged,
)

CFG = PipelineConfig(huffman_literals=False, custom_fse=False)
OUT = ROOT / "tests" / "golden" / "torch_slice1.json"
BATCH_BLOCKS = 128
FRAME_BLOCKS = 4


def _frame(lengths, contents, clens, btypes) -> bytes:
    parts = [write_frame_header(int(lengths.sum()))]
    for b in range(len(lengths)):
        last = int(b == len(lengths) - 1)
        if int(btypes[b]) == BLOCK_RLE:
            parts += [((int(lengths[b]) << 3) | (BLOCK_RLE << 1) | last).to_bytes(3, "little"),
                      contents[b, :1].tobytes()]
        else:
            clen = int(clens[b])
            parts += [((clen << 3) | (int(btypes[b]) << 1) | last).to_bytes(3, "little"),
                      contents[b, :clen].tobytes()]
    return b"".join(parts)


def main() -> None:
    dctx = zstandard.ZstdDecompressor()
    t0 = time.perf_counter()
    data = make_corpus(BATCH_BLOCKS * CFG.block_size)
    blocks, lengths = _split_blocks(data, CFG.block_size)
    contents, clens, btypes = jax.device_get(
        compress_blocks_staged(jnp.asarray(blocks), jnp.asarray(lengths), CFG)
    )
    frame = _frame(lengths, contents, clens, btypes)
    if dctx.decompress(frame, max_output_size=len(data)) != data:
        raise SystemExit("libzstd failed to decode the batch frame")
    blocks_out = [
        {
            "btype": int(btypes[b]),
            "clen": int(clens[b]),
            "sha256": hashlib.sha256(contents[b, : int(clens[b])].tobytes()).hexdigest(),
        }
        for b in range(len(lengths))
    ]
    t_batch = time.perf_counter() - t0

    t0 = time.perf_counter()
    small = make_corpus(FRAME_BLOCKS * CFG.block_size)
    small_frame = compress(small, CFG)
    if dctx.decompress(small_frame, max_output_size=len(small)) != small:
        raise SystemExit("libzstd failed to decode the 4-block frame")
    t_frame = time.perf_counter() - t0

    body = sum(b["clen"] for b in blocks_out)
    doc = {
        "config": dataclasses.asdict(CFG),
        "batch": {
            "corpus": f"make_corpus({BATCH_BLOCKS} * {CFG.block_size})",
            "block_body_ratio": len(data) / body,
            "blocks": blocks_out,
        },
        "frame": {
            "corpus": f"make_corpus({FRAME_BLOCKS} * {CFG.block_size})",
            "len": len(small_frame),
            "sha256": hashlib.sha256(small_frame).hexdigest(),
        },
    }
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps(doc, indent=1) + "\n")
    counts = {t: sum(b["btype"] == t for b in blocks_out) for t in (0, 1, 2)}
    print(f"batch {t_batch:.1f}s frame {t_frame:.1f}s btypes {counts} "
          f"ratio {doc['batch']['block_body_ratio']:.4f} -> {OUT}")


if __name__ == "__main__":
    main()
