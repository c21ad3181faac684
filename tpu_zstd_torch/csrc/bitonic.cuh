// Bitonic sorting network, shared by K12 (sort.cu) and K13 (match.cu).
//
// Counterpart of the network of tpu_zstd/ops/pallas_sort.py `_sort_body` /
// `_ce_stage`: merge levels k = 2, 4, ..., W, and inside each the
// compare-exchange distances j = k/2, ..., 1; the element i keeps the
// smaller key when bit k of i is 0 (ascending run) and the larger one
// otherwise, so the last level (k = W) leaves the row ascending. Keys compare
// as signed int32, as jax.lax.sort orders int32. Each stage is W/2 pairs:
// pair p is the element i (p with a 0 bit inserted at bit j) and its partner
// i | j.
//
// Rows that fit a CTA's shared memory sort in it (`bitonic_sort_smem`): the
// width 2^LOG_W and the block size T are template parameters, so every
// distance is a compile-time constant and the loops unroll; T threads take
// W / 2T pairs a stage, then the block synchronises.
//
// Wider rows (`bitonic_sort_wide`) run the same network in tiles of 2^LOG_T
// columns: every tile first sorts in shared memory with the directions its
// columns have in the row (levels k <= 2^LOG_T); then for each wider level k
// the stages whose partner lies in another tile (j >= 2^LOG_T) run as
// grid-wide passes over device memory, one launch a stage, and the stages
// inside a tile (j < 2^LOG_T) finish in shared memory, one launch a level.
//
// Keys must be unique within the row (callers pack a position into the low
// bits); with SLOT the exchanges also move slot[], which then holds each
// sorted key's original column.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void bitonic_ce(int32_t* key, int32_t* slot, int i, int q, bool asc,
                                           bool with_slot) {
  const int32_t a = key[i];
  const int32_t b = key[q];
  if ((a > b) == asc) {
    key[i] = b;
    key[q] = a;
    if (with_slot) {
      const int32_t t = slot[i];
      slot[i] = slot[q];
      slot[q] = t;
    }
  }
}

// Sorts key[0, 2^LOG_W) ascending when hi is 0. hi (0 or 2^LOG_W) is bit
// LOG_W of the row's first column in a wider row: the last level then runs
// descending, as the wider network wants that tile.
template <int LOG_W, int T, bool SLOT>
__device__ __forceinline__ void bitonic_sort_smem(int32_t* key, int32_t* slot, int hi = 0) {
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
        bitonic_ce(key, slot, i, i | j, ((i | hi) & k) == 0, SLOT);
      }
      __syncthreads();
    }
  }
}

// The stages j = 2^LOG_W / 2, ..., 1 of one level, every pair in direction asc.
template <int LOG_W, int T, bool SLOT>
__device__ __forceinline__ void bitonic_merge_smem(int32_t* key, int32_t* slot, bool asc) {
  constexpr int W = 1 << LOG_W;
  constexpr int HALF = W / 2;
  static_assert(HALF % T == 0, "the block size must divide W / 2");
  __syncthreads();
#pragma unroll
  for (int j = HALF; j > 0; j >>= 1) {
#pragma unroll
    for (int p0 = 0; p0 < HALF; p0 += T) {
      const int p = p0 + threadIdx.x;
      const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
      bitonic_ce(key, slot, i, i | j, asc, SLOT);
    }
    __syncthreads();
  }
}

namespace {

__host__ __device__ constexpr int bitonic_threads(int log_w) {
  return (1 << log_w) / 2 < 1024 ? (1 << log_w) / 2 : 1024;
}

// Tile t of the flat (R, 2^log_w) operands: its first flat element and the
// row column it starts at.
__device__ __forceinline__ void wide_tile(int log_t, int log_w, int64_t& base, int& col0) {
  base = (int64_t)blockIdx.x << log_t;
  col0 = (int)(base & ((1LL << log_w) - 1));
}

template <int LOG_T, bool SLOT>
__global__ void __launch_bounds__(bitonic_threads(LOG_T))
wide_presort_kernel(const int32_t* __restrict__ key_in, int32_t* __restrict__ key,
                    int32_t* __restrict__ slot, int log_w) {
  constexpr int TW = 1 << LOG_T;
  constexpr int T = bitonic_threads(LOG_T);
  extern __shared__ int32_t smem[];
  int32_t* s_key = smem;
  int32_t* s_slot = smem + TW;
  int64_t base;
  int col0;
  wide_tile(LOG_T, log_w, base, col0);
  for (int i = threadIdx.x; i < TW; i += T) {
    s_key[i] = key_in[base + i];
    if (SLOT) s_slot[i] = col0 + i;
  }
  bitonic_sort_smem<LOG_T, T, SLOT>(s_key, s_slot, col0 & TW);
  for (int i = threadIdx.x; i < TW; i += T) {
    key[base + i] = s_key[i];
    if (SLOT) slot[base + i] = s_slot[i];
  }
}

// One stage (k, j) with j >= the tile width, over all rows.
template <bool SLOT>
__global__ void __launch_bounds__(256)
wide_stage_kernel(int32_t* __restrict__ key, int32_t* __restrict__ slot, int64_t npairs,
                  int log_w, int k, int j) {
  const int hmask = (1 << (log_w - 1)) - 1;
  for (int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; p < npairs;
       p += (int64_t)gridDim.x * blockDim.x) {
    const int pc = (int)(p & hmask);
    const int i = ((pc & ~(j - 1)) << 1) | (pc & (j - 1));
    const int64_t row = (p >> (log_w - 1)) << log_w;
    const int64_t a = row + i, b = row + (i | j);
    const int32_t ka = key[a], kb = key[b];
    if ((ka > kb) == ((i & k) == 0)) {
      key[a] = kb;
      key[b] = ka;
      if (SLOT) {
        const int32_t t = slot[a];
        slot[a] = slot[b];
        slot[b] = t;
      }
    }
  }
}

// The stages of level k inside each tile.
template <int LOG_T, bool SLOT>
__global__ void __launch_bounds__(bitonic_threads(LOG_T))
wide_merge_kernel(int32_t* __restrict__ key, int32_t* __restrict__ slot, int log_w, int k) {
  constexpr int TW = 1 << LOG_T;
  constexpr int T = bitonic_threads(LOG_T);
  extern __shared__ int32_t smem[];
  int32_t* s_key = smem;
  int32_t* s_slot = smem + TW;
  int64_t base;
  int col0;
  wide_tile(LOG_T, log_w, base, col0);
  for (int i = threadIdx.x; i < TW; i += T) {
    s_key[i] = key[base + i];
    if (SLOT) s_slot[i] = slot[base + i];
  }
  bitonic_merge_smem<LOG_T, T, SLOT>(s_key, s_slot, (col0 & k) == 0);
  for (int i = threadIdx.x; i < TW; i += T) {
    key[base + i] = s_key[i];
    if (SLOT) slot[base + i] = s_slot[i];
  }
}

// Sorts each row of key_in (R, 2^log_w), log_w > LOG_T, ascending into key;
// with SLOT, slot (R, 2^log_w) receives each sorted key's original column.
template <int LOG_T, bool SLOT>
int bitonic_sort_wide(const int32_t* key_in, int32_t* key, int32_t* slot, int64_t R, int log_w,
                      cudaStream_t stream) {
  constexpr int TW = 1 << LOG_T;
  constexpr int T = bitonic_threads(LOG_T);
  const int smem = (SLOT ? 8 : 4) * TW;
  if (log_w <= LOG_T || log_w > 30) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(wide_presort_kernel<LOG_T, SLOT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(wide_merge_kernel<LOG_T, SLOT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t tiles = R << (log_w - LOG_T);
  const int64_t npairs = R << (log_w - 1);
  const unsigned stage_blocks =
      (unsigned)((npairs + 255) / 256 < 132 * 16 ? (npairs + 255) / 256 : 132 * 16);
  wide_presort_kernel<LOG_T, SLOT><<<(unsigned)tiles, T, smem, stream>>>(key_in, key, slot,
                                                                           log_w);
  for (int lev = LOG_T + 1; lev <= log_w; ++lev) {
    const int k = 1 << lev;
    for (int j = k >> 1; j >= TW; j >>= 1)
      wide_stage_kernel<SLOT><<<stage_blocks, 256, 0, stream>>>(key, slot, npairs, log_w, k, j);
    wide_merge_kernel<LOG_T, SLOT><<<(unsigned)tiles, T, smem, stream>>>(key, slot, log_w, k);
  }
  return (int)cudaGetLastError();
}

}  // namespace
