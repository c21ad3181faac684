// Bitonic sorting network over one row held in shared memory, shared by K12
// (sort.cu) and K13 (match.cu).
//
// Counterpart of the network of tpu_zstd/ops/pallas_sort.py `_sort_body` /
// `_ce_stage`: merge levels k = 2, 4, ..., W, and inside each the
// compare-exchange distances j = k/2, ..., 1; the element i keeps the
// smaller key when bit k of i is 0 (ascending run) and the larger one
// otherwise, so the last level (k = W) leaves the row ascending. Keys compare
// as signed int32, as jax.lax.sort orders int32. The row width W = 2^LOG_W
// and the block size T are template parameters, so every distance is a
// compile-time constant and the loops unroll. Each stage is W/2 pairs: pair
// p is the element i (p with a 0 bit inserted at bit j) and its partner
// i | j; T threads take W / 2T pairs each, then the block synchronises.
//
// Keys must be unique within the row (callers pack a position into the low
// bits); with SLOT the exchanges also move slot[], which then holds each
// sorted key's original index.
#pragma once
#include <stdint.h>

template <int LOG_W, int T, bool SLOT>
__device__ __forceinline__ void bitonic_sort_smem(int32_t* key, int32_t* slot) {
  constexpr int W = 1 << LOG_W;
  constexpr int HALF = W / 2;
  static_assert(HALF % T == 0, "the block size must divide W / 2");
  __syncthreads();
#pragma unroll
  for (int k = 2; k <= W; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int p0 = 0; p0 < HALF; p0 += T) {
        const int p = p0 + threadIdx.x;
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        const int q = i | j;
        const int32_t a = key[i];
        const int32_t b = key[q];
        const bool asc = (i & k) == 0;
        if ((a > b) == asc) {
          key[i] = b;
          key[q] = a;
          if (SLOT) {
            const int32_t t = slot[i];
            slot[i] = slot[q];
            slot[q] = t;
          }
        }
      }
      __syncthreads();
    }
  }
}
