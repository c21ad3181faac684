"""The port's batch sharding (tpu_zstd_torch/parallel) in two processes on
the CPU: two ranks of a gloo process group (tcp://localhost) each run
`compress_blocks_sharded` and `compress_batch_distributed` on the same
batch of 4 KB blocks. Both ranks' outputs equal each other and the JAX
package's `compress_blocks_sharded` (and the frames its
`compress_batch_distributed` joins) on the same batch, and stock libzstd
decodes every frame. One test item; the ranks run in subprocesses because
a process joins one group at a time.
"""

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import zstandard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import pickle, sys
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, sys.argv[4])
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from tpu_zstd_torch.ops.pipeline import PipelineConfig
from tpu_zstd_torch.parallel import (compress_batch_distributed, compress_blocks_sharded,
                                     initialize, make_mesh)
with open(out + ".in", "rb") as fh:
    items, blocks, lengths, kw = pickle.load(fh)
initialize("gloo", f"tcp://localhost:{port}", world_size=2, rank=rank)
try:
    mesh = make_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.distributed) == (rank, 2, True), mesh
    cfg = PipelineConfig(**kw)
    sharded = compress_blocks_sharded(blocks, lengths, cfg, mesh)
    frames = compress_batch_distributed(items, cfg, device="cpu")
finally:
    dist.destroy_process_group()
with open(out, "wb") as fh:
    pickle.dump((sharded, frames), fh)
print("WORKER_OK", rank)
"""

# The block size and search of tests/test_multiprocess.py, 4 KB blocks.
CFG = dict(block_size=4096, hash_log=13, mf_win_log=0)


def _items():
    rng = np.random.default_rng(1807)
    from tpu_zstd_torch.corpus import make_corpus

    return [b"sharded compression payload " * 200, rng.integers(0, 256, 5000, np.uint8).tobytes(),
            b"Z" * 9000, make_corpus(11000)]


def _blocks(items, N):
    rows, lens = [], []
    for data in items:
        for p in range(0, max(len(data), 1), N):
            chunk = np.frombuffer(data[p : p + N], np.uint8)
            row = np.zeros(N, np.uint8)
            row[: len(chunk)] = chunk
            rows.append(row)
            lens.append(len(chunk))
    return np.stack(rows), np.asarray(lens, np.int32)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.timeout(900)
def test_two_rank_gloo_sharding_matches_jax(tmp_path):
    import jax.numpy as jnp  # noqa: F401  (JAX stays on the CPU; see conftest.py)

    from tpu_zstd.ops.pipeline import PipelineConfig as JCfg
    from tpu_zstd.parallel.multihost import compress_batch_distributed as j_distributed
    from tpu_zstd.parallel.sharding import compress_blocks_sharded as j_sharded

    items = _items()
    blocks, lengths = _blocks(items, CFG["block_size"])
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    outs = [tmp_path / f"out{r}.pkl" for r in (0, 1)]
    for o in outs:
        with open(f"{o}.in", "wb") as fh:
            pickle.dump((items, blocks, lengths, CFG), fh)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(outs[r]), ROOT],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
             for r in (0, 1)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=600)[0].decode(errors="replace"))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the gloo ranks timed out")
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in log, f"rank {r} failed:\n{log[-3000:]}"
    (sh0, fr0), (sh1, fr1) = (pickle.load(open(o, "rb")) for o in outs)
    for a, b in zip(sh0, sh1):
        assert np.array_equal(a, b), "the two ranks gathered different blocks"
    assert fr0 == fr1, "the two ranks joined different frames"

    jcfg = JCfg(**CFG)
    ref = [np.asarray(a) for a in j_sharded(blocks, lengths, jcfg)]
    contents, clens, btypes = sh0
    assert np.array_equal(clens, ref[1]) and np.array_equal(btypes, ref[2])
    bad = [b for b in range(len(lengths))
           if contents[b, : clens[b]].tobytes() != ref[0][b, : ref[1][b]].tobytes()]
    assert not bad, f"blocks {bad} differ from the JAX package's compress_blocks_sharded"
    assert fr0 == j_distributed(items, jcfg)
    dctx = zstandard.ZstdDecompressor()
    for f, d in zip(fr0, items):
        assert dctx.decompress(f, max_output_size=max(len(d), 1)) == d

