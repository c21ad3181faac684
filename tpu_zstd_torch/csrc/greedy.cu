// K3: exact greedy / 1-step-lazy parse walk over independent segments.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_greedy.py
// `greedy_segments` (`_greedy_impl` / `_make_kernel`), whose step body is
// the lax.scan of tpu_zstd/ops/lz77_jax.py `greedy_parse`. Input per
// position: step | matched << 11 | defer << 12 (step <= seg <= 1024);
// output: take | is_lit << 1 as one byte.
//
// The walk is sequential inside a segment and independent across segments:
// one thread walks one segment with the two-register state (next-allowed,
// match-end), a compare and two selects a step. Design:
// - A CTA is one warp and 32 segments (16384 segments of a 128 x 128 KB
//   batch: 512 CTAs, about 4 on each of the 132 SMs).
// - The warp stages tiles of 64 positions of its 32 segments in shared
//   memory with cp.async (16 bytes a copy when seg is a multiple of 4 and
//   the rows are 16-byte aligned, else 4), four tiles in flight. A
//   segment's row of a tile is 16 chunks of 16 bytes, chunk j stored at
//   j ^ (segment & 7), so each 16-byte read of 8 threads hits 8 distinct
//   bank groups and the walk reads four positions per load.
// - A thread packs its 16 output bytes into four registers and stores them
//   with one 16-byte store when seg is a multiple of 16 (byte stores
//   otherwise).
//
// Bound: bytes (4 read and 1 written per position: 84 MB, 0.025 ms at
// 16384 x 1024). The walk's dependent chain is ~2 operations a step, so a
// segment of 1024 positions takes a few microseconds once its input is in
// shared memory.
#include <cuda_runtime.h>
#include <stdint.h>

#define GREEDY_SEGS 32   // segments per CTA: one warp, one thread a segment
#define GREEDY_TP 64     // positions per staged tile
#define GREEDY_STAGES 4  // tiles in flight

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <bool VEC_IN, bool VEC_OUT>
__global__ void __launch_bounds__(GREEDY_SEGS)
greedy_segments_kernel(const int32_t* __restrict__ packed, uint8_t* __restrict__ out,
                       int64_t S, int seg) {
  __shared__ __align__(16) int32_t tile[GREEDY_STAGES][GREEDY_SEGS * GREEDY_TP];
  const int lane = threadIdx.x;
  const int64_t s0 = (int64_t)blockIdx.x * GREEDY_SEGS;
  const int nseg = (int)min((int64_t)GREEDY_SEGS, S - s0);
  const int ntiles = (seg + GREEDY_TP - 1) / GREEDY_TP;
  const int32_t* base = packed + s0 * seg;

  // Tile k into buffer k % STAGES: 32 rows x 16 chunks, lanes 0-15 on one
  // row's 256 contiguous bytes, lanes 16-31 on the next row's.
  auto load_tile = [&](int k) {
    int32_t* buf = tile[k % GREEDY_STAGES];
    for (int q = lane; q < GREEDY_SEGS * (GREEDY_TP / 4); q += GREEDY_SEGS) {
      const int r = q >> 4, j = q & 15;
      const int p = k * GREEDY_TP + j * 4;
      if (r >= nseg || p >= seg) continue;
      int32_t* dst = buf + r * GREEDY_TP + ((j ^ (r & 7)) << 2);
      const int32_t* src = base + (int64_t)r * seg + p;
      if (VEC_IN) {
        cp_async16(dst, src);
      } else {
        for (int e = 0; e < 4 && p + e < seg; ++e) cp_async4(dst + e, src + e);
      }
    }
    cp_async_commit();  // one group a tile (empty past the last tile)
  };

#pragma unroll
  for (int k = 0; k < GREEDY_STAGES - 1; ++k) load_tile(k);

  const bool active = lane < nseg;
  uint8_t* o = out + (s0 + lane) * seg;
  const int step_mask = 2 * seg - 1;
  int na = 0, me = 0;
  uint32_t ob[4] = {0, 0, 0, 0};  // output bytes of the current 16 positions
  for (int k = 0; k < ntiles; ++k) {
    load_tile(k + GREEDY_STAGES - 1);
    cp_async_wait<GREEDY_STAGES - 1>();  // tile k has landed (this thread's copies)
    __syncwarp();                         // ... and every other lane's
    const int32_t* row = tile[k % GREEDY_STAGES] + lane * GREEDY_TP;
    const int p0 = k * GREEDY_TP;
    const int pend = min(GREEDY_TP, seg - p0);
#pragma unroll
    for (int q = 0; q < GREEDY_TP / 4; ++q) {  // unrolled: ob[] stays in registers
      if (4 * q >= pend) break;
      const int4 v = *(const int4*)(row + ((q ^ (lane & 7)) << 2));
      const int xs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = p0 + 4 * q + e;
        const int x = xs[e];
        const int stp = x & step_mask;
        const bool mt = ((x >> 11) & 1) && !((x >> 12) & 1);
        const bool is_pp = na == p;
        const bool take = is_pp && mt;
        if (take) me = p + stp;
        if (is_pp) na = p + (take ? stp : 1);
        const uint32_t b = (take ? 1u : 0u) | (p >= me ? 2u : 0u);
        const int slot = (4 * q + e) & 15;
        ob[slot >> 2] |= b << (8 * (slot & 3));
      }
      const int done = 4 * q + 4;  // positions of this tile walked
      if (VEC_OUT) {
        if ((done & 15) == 0) {
          if (active)
            *(uint4*)(o + p0 + done - 16) = make_uint4(ob[0], ob[1], ob[2], ob[3]);
          ob[0] = ob[1] = ob[2] = ob[3] = 0;
        }
      } else {
        // Byte stores of the four positions just walked.
        const int slot = (4 * q) & 15;
        const uint32_t w = ob[slot >> 2];
        if (active)
          for (int e = 0; e < 4 && p0 + 4 * q + e < seg; ++e)
            o[p0 + 4 * q + e] = (uint8_t)(w >> (8 * e));
        ob[slot >> 2] = 0;
      }
    }
    __syncwarp();  // every lane is done with the buffer before it is refilled
  }
  cp_async_wait<0>();
}

extern "C" int tz_greedy_segments(const void* packed, void* out, int64_t S, int seg,
                                  cudaStream_t stream) {
  if (seg < 1 || seg > 1024 || S < 1) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (S + GREEDY_SEGS - 1) / GREEDY_SEGS;
  const bool vin = seg % 4 == 0 && ((uintptr_t)packed & 15) == 0;
  const bool vout = seg % 16 == 0 && ((uintptr_t)out & 15) == 0;
  const dim3 grid((unsigned)blocks);
  if (vin && vout)
    greedy_segments_kernel<true, true><<<grid, GREEDY_SEGS, 0, stream>>>(
        (const int32_t*)packed, (uint8_t*)out, S, seg);
  else if (vin)
    greedy_segments_kernel<true, false><<<grid, GREEDY_SEGS, 0, stream>>>(
        (const int32_t*)packed, (uint8_t*)out, S, seg);
  else
    greedy_segments_kernel<false, false><<<grid, GREEDY_SEGS, 0, stream>>>(
        (const int32_t*)packed, (uint8_t*)out, S, seg);
  return (int)cudaGetLastError();
}
