// K5: FSE encoder state chains with per-row (custom) tables.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_chain.py
// `state_chain3_pallas` (semantics of tpu_zstd/ops/fse_jax.py
// `_state_chain3_cf`). One row is one FSE stream of one block: the LL, OF or
// ML sequence stream, or one of the two interleaved Huffman-weight streams.
// Per row: a 64-entry state table st (values in [ts, 2ts)), per-symbol
// dnb / dfs / init (S <= 64 symbols), the table log, an RLE flag, nseq, and
// the symbols rsym (msb of them, encoder order). The chain starts at
// init[rsym[0]]; step s consumes rsym[s + 1] and is live while s + 1 < nseq:
//
//   value = ts + state;  nb = (value + dnb[sym]) >> 16;
//   state' = st[(value >> nb) + dfs[sym]] - ts
//
// Outputs, rolled by one so that index t is the transition consuming rsym[t]:
// pre (state before it), nb (its bit count, 0 on steps that are not live),
// and fin, the state after the last live step (0 on RLE rows).
//
// Design: one CTA per row, its tables in shared memory, one thread per
// 128-step chunk (msb / 128 <= 256 threads). Chunk entry states come from the
// reference's fixpoint: every live chunk walks from its guessed entry, the
// finals shift right by one chunk, and the passes stop when no live chunk's
// entry changed (at most chunks + 1 passes; ANS transitions contract, so two
// or three passes are usual). A chunk whose entry did not change keeps its
// final without walking again; chunks past the last live one never walk.
// Then one recording walk.
//
// Bound: bytes on paper (rsym read once, pre and nb written once), in
// practice the serial depth: each pass is 128 dependent shared-memory
// lookups per thread. Thread c reads rsym[c * 128 + i], so neighbouring
// threads read 512 bytes apart: the loads and the pre / nb stores are not
// coalesced (the first thing to change in a faster version).
#include <cuda_runtime.h>
#include <stdint.h>

#define CHAIN_CHUNK 128
#define CHAIN_MAX_CHUNKS 256
#define CHAIN_TS 64
#define CHAIN_SMAX 64

__global__ void __launch_bounds__(CHAIN_MAX_CHUNKS)
state_chain3_kernel(const int32_t* __restrict__ st, const int32_t* __restrict__ dnb,
                    const int32_t* __restrict__ dfs, const int32_t* __restrict__ init,
                    const int32_t* __restrict__ tl, const int32_t* __restrict__ rle,
                    const int32_t* __restrict__ rsym, const int32_t* __restrict__ nseq,
                    int32_t* __restrict__ pre, int32_t* __restrict__ nb_out,
                    int32_t* __restrict__ fin, int S, int msb) {
  __shared__ int s_st[CHAIN_TS];
  __shared__ int s_dnb[CHAIN_SMAX];
  __shared__ int s_dfs[CHAIN_SMAX];
  __shared__ int s_final[CHAIN_MAX_CHUNKS];
  __shared__ int s_changed;

  const int r = blockIdx.x;
  const int c = threadIdx.x;
  const int nc = msb / CHAIN_CHUNK;
  const int64_t base = (int64_t)r * msb;
  const int t0 = c * CHAIN_CHUNK;

  for (int j = c; j < CHAIN_TS; j += blockDim.x) s_st[j] = st[r * CHAIN_TS + j];
  for (int j = c; j < S; j += blockDim.x) {
    s_dnb[j] = dnb[(int64_t)r * S + j];
    s_dfs[j] = dfs[(int64_t)r * S + j];
  }
  __syncthreads();

  if (rle[r]) {  // uniform over the CTA
    for (int i = 0; i < CHAIN_CHUNK; ++i) {
      pre[base + t0 + i] = 0;
      nb_out[base + t0 + i] = 0;
    }
    if (c == 0) fin[r] = 0;
    return;
  }

  const int ts = 1 << tl[r];
  const int n = nseq[r];
  const int sym0 = min(max(rsym[base], 0), S - 1);
  const int init_state = init[(int64_t)r * S + sym0];
  // Live steps s = t0 + i of this chunk: s + 1 < n, a prefix of the chunk.
  const int live = max(0, min(CHAIN_CHUNK, n - 1 - t0));

  auto sym_at = [&](int i) {  // symbol consumed by step t0 + i
    int t = t0 + i + 1;
    if (t >= msb) t -= msb;
    return min(max(rsym[base + t], 0), S - 1);
  };
  auto next_state = [&](int state, int sym, int* nb_bits) {
    const int value = ts + state;
    const int nb = min(max((value + s_dnb[sym]) >> 16, 0), 31);
    const int idx = min(max((value >> nb) + s_dfs[sym], 0), CHAIN_TS - 1);
    *nb_bits = nb;
    return s_st[idx] - ts;
  };
  auto walk = [&](int state) {
    int nb;
    for (int i = 0; i < live; ++i) state = next_state(state, sym_at(i), &nb);
    return state;
  };

  // Fixpoint over the chunk entry states.
  int e = init_state;
  int f = 0;
  bool walked = false;
  for (int it = 0; it <= nc; ++it) {
    if (c == 0) s_changed = 0;
    if (live > 0 && !walked) {
      f = walk(e);
      walked = true;
    } else if (live == 0) {
      f = e;
    }
    s_final[c] = f;
    __syncthreads();
    const int e_new = c == 0 ? init_state : s_final[c - 1];
    if (live > 0 && e_new != e) s_changed = 1;
    __syncthreads();
    const int changed = s_changed;
    if (e_new != e) walked = false;
    e = e_new;
    __syncthreads();  // every thread read s_changed and s_final before the next pass
    if (!changed) break;
  }

  // Recording walk.
  int state = e;
  for (int i = 0; i < CHAIN_CHUNK; ++i) {
    int t = t0 + i + 1;
    if (t >= msb) t -= msb;
    pre[base + t] = state;
    int nb = 0;
    if (i < live) state = next_state(state, sym_at(i), &nb);
    nb_out[base + t] = nb;
  }
  const int c_last = min(max(n - 2, 0) / CHAIN_CHUNK, nc - 1);
  if (c == c_last) fin[r] = state;
}

extern "C" int tz_state_chain3(const void* st, const void* dnb, const void* dfs,
                               const void* init, const void* tl, const void* rle,
                               const void* rsym, const void* nseq, void* pre, void* nb,
                               void* fin, int R, int S, int msb, cudaStream_t stream) {
  const int nc = msb / CHAIN_CHUNK;
  if (msb % CHAIN_CHUNK || nc < 1 || nc > CHAIN_MAX_CHUNKS || S < 1 || S > CHAIN_SMAX)
    return (int)cudaErrorInvalidValue;
  state_chain3_kernel<<<R, nc, 0, stream>>>(
      (const int32_t*)st, (const int32_t*)dnb, (const int32_t*)dfs, (const int32_t*)init,
      (const int32_t*)tl, (const int32_t*)rle, (const int32_t*)rsym, (const int32_t*)nseq,
      (int32_t*)pre, (int32_t*)nb, (int32_t*)fin, S, msb);
  return (int)cudaGetLastError();
}
