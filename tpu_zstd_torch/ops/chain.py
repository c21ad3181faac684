"""K5: FSE encoder state chains with per-row tables (CUDA kernel + plain
PyTorch version).

Counterpart of tpu_zstd/ops/pallas_chain.py `state_chain3_pallas`, with the
semantics of tpu_zstd/ops/fse_jax.py `_state_chain3_cf`; the kernel is
csrc/chain.cu. Each row is one FSE stream of one block (the LL, OF and ML
sequence streams, or the two interleaved Huffman-weight streams) with its own
closed-form tables:

    value  = ts + state
    nb     = (value + dnb[sym]) >> 16
    state' = st[(value >> nb) + dfs[sym]] - ts

The chain starts at init[rsym[0]]; step s consumes rsym[s + 1] and is live
while s + 1 < nseq (RLE rows have no live step). The chain is cut into
CHUNK-step chunks whose entry states are found by fixpoint iteration: walk
every chunk from a guessed entry, hand each chunk's final state to the next
chunk as its entry, repeat until no live chunk's entry changes (at most
chunks + 1 passes; ANS transitions contract, so two or three passes are
usual), then walk once more recording each step.

Outputs, rolled so that index t is the transition consuming rsym[t]:
pre (R, msb) the state before it, nb (R, msb) its bit count, both valid for
1 <= t < nseq (nb is 0 on every other step); fin (R,) the state after the
last live step (0 on RLE rows). Entries outside the live range are
unspecified and differ between the kernel, this plain version and the JAX
package; callers mask them.

Both versions read every operand as int32 (the kernel reads int32, int64
and bool operands as the caller holds them and converts as .to(torch.int32)
does) and compute a step in 64-bit integers, so they agree on every
table, also one outside the encoder's contract (st outside [ts, 2 ts)).
The kernel's design (a transition table, staged symbols, trajectories with
fix-up rounds that stop where a walk meets the recorded one, transfer maps
for rows that do not contract) is described in csrc/chain.cu.
"""

from __future__ import annotations

import torch

from . import _kernels

CHUNK = 128        # serial steps per chunk (one CUDA thread each)
MAX_CHUNKS = 256   # msb <= 32768
TS_MAX = 64        # state-table entries per row
S_MAX = 64         # symbols per row
STATS = 4          # kernel counters per row (see state_chain3)


def _prepare(st, dnb, dfs, init, tl, rle, rsym, nseq):
    R, msb = rsym.shape
    if msb % CHUNK or not 0 < msb // CHUNK <= MAX_CHUNKS:
        raise ValueError(f"state_chain3: msb {msb} must be a multiple of {CHUNK} up to "
                         f"{CHUNK * MAX_CHUNKS}")
    if st.shape != (R, TS_MAX) or dnb.shape[0] != R or dnb.shape[1] > S_MAX:
        raise ValueError(f"state_chain3: st {tuple(st.shape)} / dnb {tuple(dnb.shape)} "
                         f"for {R} rows")
    if dfs.shape != dnb.shape or init.shape != dnb.shape:
        raise ValueError("state_chain3: dnb, dfs and init must have one shape")
    if tl.shape != (R,) or rle.shape != (R,) or nseq.shape != (R,):
        raise ValueError("state_chain3: tl, rle and nseq must be (rows,)")


def state_chain3_plain(st, dnb, dfs, init, tl, rle, rsym, nseq):
    """The chunked fixpoint in PyTorch ops, all rows at once.

    st (R, 64); dnb, dfs, init (R, S); tl (R,) table logs; rle (R,) bool;
    rsym (R, msb) symbols in encoder order; nseq (R,). Returns int32
    (pre (R, msb), fin (R,), nb (R, msb)).
    """
    _prepare(st, dnb, dfs, init, tl, rle, rsym, nseq)
    R, msb = rsym.shape
    S = dnb.shape[1]
    nc = msb // CHUNK
    dev = rsym.device
    st, dnb, dfs, init, tl, nseq, rsym = (
        x.to(torch.int32).to(torch.int64) for x in (st, dnb, dfs, init, tl, nseq, rsym))
    rle = rle.to(torch.int32) != 0
    ts = (1 << tl)[:, None]
    sym0 = torch.clamp(rsym[:, :1], 0, S - 1)
    init_k = torch.where(rle, 0, init.gather(1, sym0)[:, 0])

    # Step s consumes rsym[s + 1]; lay steps out as (rows, chunks, CHUNK).
    st_sym = torch.clamp(torch.roll(rsym, -1, 1), 0, S - 1)
    dnb_s = dnb.gather(1, st_sym).reshape(R, nc, CHUNK)
    dfs_s = dfs.gather(1, st_sym).reshape(R, nc, CHUNK)
    t = torch.arange(msb, device=dev).reshape(nc, CHUNK)
    valid = ((t + 1)[None] < nseq[:, None, None]) & ~rle[:, None, None]
    real = valid[..., 0]  # live steps form a prefix: a chunk is live iff its first step is

    def step(state, i):
        value = ts + state
        nb = (value + dnb_s[..., i]) >> 16
        idx = torch.clamp((value >> torch.clamp(nb, 0, 31)) + dfs_s[..., i], 0, TS_MAX - 1)
        nxt = st.gather(1, idx) - ts
        v = valid[..., i]
        return torch.where(v, nxt, state), torch.where(v, nb, 0)

    e = init_k[:, None].expand(R, nc)
    for _ in range(nc + 1):
        f = e
        for i in range(CHUNK):
            f, _ = step(f, i)
        e_new = torch.cat([init_k[:, None], f[:, :-1]], 1)
        done = bool(((e_new == e) | ~real).all())
        e = e_new
        if done:
            break

    pre = torch.empty((R, nc, CHUNK), dtype=torch.int64, device=dev)
    nb = torch.empty_like(pre)
    state = e
    for i in range(CHUNK):
        pre[..., i] = state
        state, nb[..., i] = step(state, i)
    c_last = torch.clamp(torch.clamp(nseq - 2, min=0) // CHUNK, max=nc - 1)
    fin = torch.where(rle, 0, state.gather(1, c_last[:, None])[:, 0])
    pre = torch.where(rle[:, None], 0, torch.roll(pre.reshape(R, msb), 1, 1))
    nb = torch.roll(nb.reshape(R, msb), 1, 1)
    return pre.to(torch.int32), fin.to(torch.int32), nb.to(torch.int32)


def state_chain3(st, dnb, dfs, init, tl, rle, rsym, nseq, stats=None):
    """FSE state chains of R rows (see the module docstring). CPU tensors
    take the plain version; CUDA tensors launch the kernel.

    stats: optional (R, STATS) int32 CUDA tensor; the kernel writes per row
    its passes (pass 1 plus the fix-up rounds in which a chunk of the row
    re-walked), the steps walked in them, 1 if the row took the transfer
    maps and 1 if it took the 64-bit walk (a table outside the contract).
    """
    if rsym.device.type == "cpu":
        if stats is not None:
            raise ValueError("state_chain3: stats are the CUDA kernel's counters")
        return state_chain3_plain(st, dnb, dfs, init, tl, rle, rsym, nseq)
    _prepare(st, dnb, dfs, init, tl, rle, rsym, nseq)
    R, msb = rsym.shape
    # The kernel reads int32 and int64 operands (and a bool rle) as they are;
    # anything else gets an int32 copy.
    ops = []
    for x, name in zip((st, dnb, dfs, init, tl, rle, nseq),
                       ("st", "dnb", "dfs", "init", "tl", "rle", "nseq")):
        ok = (torch.int32, torch.int64) + ((torch.bool, torch.uint8) if name == "rle" else ())
        x = (x if x.dtype in ok else x.to(torch.int32)).contiguous()
        _kernels.check_cuda(x, None, f"state_chain3 {name}")
        ops.append(x)
    rsym = (rsym if rsym.dtype in (torch.int32, torch.int64) else rsym.to(torch.int32)).contiguous()
    if rsym.data_ptr() % 16:
        rsym = rsym.clone()
    _kernels.check_cuda(rsym, None, "state_chain3 rsym")
    esz = sum(x.element_size() << (4 * k) for k, x in enumerate(ops))
    if stats is not None:
        _kernels.check_cuda(stats, torch.int32, "state_chain3 stats")
        if stats.shape != (R, STATS):
            raise ValueError(f"state_chain3: stats must be ({R}, {STATS})")
    pre = torch.empty((R, msb), dtype=torch.int32, device=rsym.device)
    nb = torch.empty_like(pre)
    fin = torch.empty((R,), dtype=torch.int32, device=rsym.device)
    if R == 0:
        return pre, fin, nb
    _kernels.launch(
        "chain", "tz_state_chain3",
        *(x.data_ptr() for x in ops), esz, rsym.data_ptr(), int(rsym.dtype == torch.int64),
        pre.data_ptr(), nb.data_ptr(), fin.data_ptr(),
        None if stats is None else stats.data_ptr(), R, dnb.shape[1], msb,
    )
    return pre, fin, nb
