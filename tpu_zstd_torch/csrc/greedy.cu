// K3: exact greedy / 1-step-lazy parse walk over independent segments.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_greedy.py
// `greedy_segments` (`_greedy_impl` / `_make_kernel`), whose step body is
// the lax.scan of tpu_zstd/ops/lz77_jax.py `greedy_parse`. Input per
// position: step | matched << 11 | defer << 12 (step <= seg <= 1024);
// output: take | is_lit << 1 as one byte.
//
// The walk is sequential inside a segment and independent across segments,
// so one thread walks one segment with the two-register state
// (next-allowed, match-end). Bound: bytes on paper (5 bytes per position),
// but in practice latency: each thread does seg dependent steps, and the
// 16384 segments of a 128 x 128 KB batch fill the card only ~4 warps deep.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void greedy_segments_kernel(const int32_t* __restrict__ packed,
                                       uint8_t* __restrict__ out, int64_t S, int seg) {
  const int64_t s = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
  if (s >= S) return;
  const int32_t* in = packed + s * seg;
  uint8_t* o = out + s * seg;
  const int step_mask = 2 * seg - 1;
  int na = 0, me = 0;
  for (int p = 0; p < seg; ++p) {
    const int x = in[p];
    const int stp = x & step_mask;
    const bool m = (x >> 11) & 1;
    const bool d = (x >> 12) & 1;
    const bool is_pp = na == p;
    const bool take = is_pp && m && !d;
    if (take) me = p + stp;
    if (is_pp) na = p + (take ? stp : 1);
    const bool is_lit = p >= me;
    o[p] = (uint8_t)((take ? 1 : 0) | (is_lit ? 2 : 0));
  }
}

extern "C" int tz_greedy_segments(const void* packed, void* out, int64_t S, int seg,
                                  cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (S + threads - 1) / threads;
  greedy_segments_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      (const int32_t*)packed, (uint8_t*)out, S, seg);
  return (int)cudaGetLastError();
}
