// K8 / K9: sequence execution (RFC 8878 §3.1.1.4).
//
// Replaces the Pallas TPU kernels tpu_zstd/ops/pallas_exec.py
// `execute_sequences_pallas` (K8, one block per grid step) and
// `execute_sequences_pallas_mb` (K9, G blocks per grid step, regrouped by
// nseq). K9 differs from K8 only in how the TPU's sequential grid schedules
// blocks; on a GPU every block is its own CTA, so one kernel computes both.
// Semantics of tpu_zstd/ops/decode_jax.py `execute_sequences_device`: each
// sequence appends ll literal bytes, then ml bytes copied from `off` bytes
// back (the history: a window of W bytes before the block, then the bytes
// produced so far); the literals left after the last sequence follow.
//
// Design: one CTA per block (128 threads). Sequences are staged 1024 at a
// time in shared memory; the CTA walks them in order, every thread
// computing the same cursors. Literal runs and matches are copied by all
// threads, one byte per thread per round. A match with off < ml is periodic
// with period off: byte i of it equals byte (i mod off) of the off bytes
// before it, which are final, so overlapping matches also copy in one
// parallel pass (what copying in rounds of off bytes gives). Two barriers
// per sequence: after the literals (a match may read them) and after the
// match. Offsets are clamped to the history, lengths to the output, the
// literal count to the staged literals: a corrupt frame gives garbage,
// never an access out of bounds. Literals come front-compacted (B, L) or
// straight from K6's stream rows: position p is row 4b + min(p / seg, 3),
// column p - s * seg, seg = ceil(regen / 4). out_len is the bytes produced;
// bytes past it are left unwritten.
//
// Bound: bytes on paper (literals and sequences read once, output written
// once); in practice the sequence walk: two CTA barriers and a handful of
// shared-memory reads per sequence, one CTA per block, so ~128 SMs each
// walking ~10-25 K sequences in series.
#include <cuda_runtime.h>
#include <stdint.h>

#define EXEC_THREADS 128
#define EXEC_STAGE 1024

__global__ void __launch_bounds__(EXEC_THREADS)
exec_sequences_kernel(const uint8_t* __restrict__ lits, const uint8_t* __restrict__ syms,
                      const int32_t* __restrict__ regen, const int32_t* __restrict__ nlit_a,
                      const int32_t* __restrict__ ll_a, const int32_t* __restrict__ ml_a,
                      const int32_t* __restrict__ off_a, const int32_t* __restrict__ nseq_a,
                      const uint8_t* __restrict__ window, uint8_t* __restrict__ out,
                      int32_t* __restrict__ out_len, int L, int SEGC, int MS, int W, int N) {
  __shared__ int s_ll[EXEC_STAGE], s_ml[EXEC_STAGE], s_of[EXEC_STAGE];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  uint8_t* o = out + (long long)b * N;
  const uint8_t* win = window + (long long)b * W;
  const int nseq = min(nseq_a[b], MS);
  int seg = 1;
  int nl;
  const uint8_t* lrow = nullptr;
  const uint8_t* srow = nullptr;
  if (syms != nullptr) {
    nl = min(nlit_a[b], 4 * SEGC);
    seg = max((regen[b] + 3) >> 2, 1);
    srow = syms + (long long)b * 4 * SEGC;
  } else {
    nl = min(nlit_a[b], L);
    lrow = lits + (long long)b * L;
  }
  auto lit = [&](int p) -> uint8_t {
    if (srow == nullptr) return lrow[p];
    const int s = min(p / seg, 3);
    return srow[(long long)s * SEGC + min(p - s * seg, SEGC - 1)];
  };
  auto copy_lits = [&](int lc, int po, int n) {
    for (int i = tid; i < n; i += EXEC_THREADS) o[po + i] = lit(lc + i);
  };

  int lc = 0, po = 0;
  for (int s0 = 0; s0 < nseq; s0 += EXEC_STAGE) {
    const int n_here = min(EXEC_STAGE, nseq - s0);
    __syncthreads();  // the previous stage is fully walked
    for (int i = tid; i < n_here; i += EXEC_THREADS) {
      const long long k = (long long)b * MS + s0 + i;
      s_ll[i] = ll_a[k];
      s_ml[i] = ml_a[k];
      s_of[i] = off_a[k];
    }
    __syncthreads();
    for (int s = 0; s < n_here; ++s) {
      const int llv = max(min(min(s_ll[s], nl - lc), N - po), 0);
      copy_lits(lc, po, llv);
      lc += llv;
      po += llv;
      __syncthreads();  // the literal bytes are visible to the match
      const int hist = W + po;
      const int mlv = hist == 0 ? 0 : max(min(s_ml[s], N - po), 0);
      const int ofv = min(max(s_of[s], 1), max(hist, 1));
      if (ofv >= mlv) {
        for (int i = tid; i < mlv; i += EXEC_THREADS) {
          const int q = po - ofv + i;
          o[po + i] = q >= 0 ? o[q] : win[W + q];
        }
      } else {
        for (int i = tid; i < mlv; i += EXEC_THREADS) {
          const int q = po - ofv + i % ofv;
          o[po + i] = q >= 0 ? o[q] : win[W + q];
        }
      }
      po += mlv;
      __syncthreads();  // the match bytes are visible to what follows
    }
  }
  const int tail = max(min(nl - lc, N - po), 0);
  copy_lits(lc, po, tail);
  if (tid == 0) out_len[b] = po + tail;
}

extern "C" int tz_exec_sequences(const void* lits, const void* syms, const void* regen,
                                 const void* nlit, const void* ll, const void* ml,
                                 const void* off, const void* nseq, const void* window,
                                 void* out, void* out_len, int B, int L, int SEGC, int MS, int W,
                                 int N, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || MS <= 0 || W < 0 || (syms == nullptr && L <= 0) ||
      (syms != nullptr && SEGC <= 0))
    return (int)cudaErrorInvalidValue;
  exec_sequences_kernel<<<B, EXEC_THREADS, 0, stream>>>(
      (const uint8_t*)lits, (const uint8_t*)syms, (const int32_t*)regen, (const int32_t*)nlit,
      (const int32_t*)ll, (const int32_t*)ml, (const int32_t*)off, (const int32_t*)nseq,
      (const uint8_t*)window, (uint8_t*)out, (int32_t*)out_len, L, SEGC, MS, W, N);
  return (int)cudaGetLastError();
}
