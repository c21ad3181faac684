// K13: fused window-local LZ77 match finder, one window a CTA.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_match.py
// `match_windows` (`_match_windows_impl` / `_make_match_kernel`). Per
// window of W = 2^LOG_W positions, with key = hash << LOG_W | pos (hash ==
// sentinel on dead rows):
//   1. sort the keys ascending (the network of bitonic.cuh);
//   2. for d = 1..depth compare each sorted row with the d-th previous one:
//      where both hashes are equal and real (below the sentinel) and the row
//      has a d-th predecessor, the match length is the count of equal
//      leading bytes of the two positions' suffix words (4 bytes a word,
//      stopping at the first word that differs); the strictly longest wins,
//      so the smallest offset wins a tie;
//   3. write (ml << LOG_W | off) back in position order.
//
// What the TPU kernel does in VMEM, this one does so: the TPU kernel carries
// the nwords suffix words through its first sort and sorts (pos, packed)
// again to restore position order. Here only the keys enter shared memory
// (4 bytes a position, 32 KB at W 8192): a sorted key's low LOG_W bits are
// its position, so the words of a row and of its predecessor are read from
// device memory at those positions (one window's words stay in L1/L2), and
// since the sorted positions are a permutation of the window, the restore
// sort becomes a store to out[pos]. Two shortcuts that change no result:
// equal hashes are contiguous in sorted order, so the depth loop stops at
// the first predecessor with another hash; and it stops once a match spans
// every carried word, since no later candidate can be strictly longer.
//
// Windows wider than 32768 positions (any power of two up to 2^30): the
// keys sort into a scratch row with the tiled network of bitonic.cuh (tiles
// of 32768 keys, the stages across tiles as passes over device memory), then
// a second kernel, one thread a sorted position, runs the same depth
// compares against the scratch row and the same store to out[pos].
//
// Bound: operations. One network of log2(W) (log2(W) + 1) / 2 stages of
// W / 2 compare-exchanges a window, plus the depth compares, against a few
// bytes a position of device memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

// The depth compares and the store of sorted position i of its window.
__device__ __forceinline__ void match_one(const int32_t* s_key, int i, int log_w,
                                          const int32_t* wrow, int64_t plane, int32_t* orow,
                                          int nwords, int depth, int sentinel) {
  const int pmask = (1 << log_w) - 1;
  const int32_t sk = s_key[i];
  const int32_t sh = sk >> log_w;
  const int sp = sk & pmask;
  int best_ml = 0, best_off = 0;
  if (sh < sentinel) {
    const int full = 4 * nwords;
    const int dmax = min(depth, i);
    for (int d = 1; d <= dmax; ++d) {
      const int32_t pk = s_key[i - d];
      if ((pk >> log_w) != sh) break;
      const int pp = pk & pmask;
      int ml = 0;
      for (int k = 0; k < nwords; ++k) {
        const uint32_t x = (uint32_t)(wrow[k * plane + sp] ^ wrow[k * plane + pp]);
        if (x != 0) {
          ml += (__ffs((int)x) - 1) >> 3;  // equal low bytes of a differing word
          break;
        }
        ml += 4;
      }
      if (ml > best_ml) {
        best_ml = ml;
        best_off = sp - pp;
        if (ml == full) break;
      }
    }
  }
  orow[sp] = (best_ml << log_w) | best_off;
}

__global__ void __launch_bounds__(256)
match_wide_kernel(const int32_t* __restrict__ skey, const int32_t* __restrict__ words,
                  int32_t* __restrict__ out, int64_t R, int log_w, int nwords, int depth,
                  int sentinel) {
  const int64_t n = R << log_w;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t base = (e >> log_w) << log_w;
    match_one(skey + base, (int)(e - base), log_w, words + base, n, out + base, nwords, depth,
              sentinel);
  }
}

template <int LOG_W>
__global__ void __launch_bounds__((1 << LOG_W) / 2 < 1024 ? (1 << LOG_W) / 2 : 1024)
match_windows_kernel(const int32_t* __restrict__ key, const int32_t* __restrict__ words,
                     int32_t* __restrict__ out, int64_t R, int nwords, int depth,
                     int sentinel) {
  constexpr int W = 1 << LOG_W;
  constexpr int T = W / 2 < 1024 ? W / 2 : 1024;
  extern __shared__ int32_t s_key[];
  const int64_t base = (int64_t)blockIdx.x * W;
  const int64_t plane = R * W;  // stride from one carried word to the next
  for (int i = threadIdx.x; i < W; i += T) s_key[i] = key[base + i];
  bitonic_sort_smem<LOG_W, T, false>(s_key, nullptr);
  for (int i = threadIdx.x; i < W; i += T)
    match_one(s_key, i, LOG_W, words + base, plane, out + base, nwords, depth, sentinel);
}

template <int LOG_W>
static int launch_match(const void* key, const void* words, void* out, int64_t R, int nwords,
                        int depth, int sentinel, cudaStream_t stream) {
  constexpr int W = 1 << LOG_W;
  constexpr int T = W / 2 < 1024 ? W / 2 : 1024;
  const size_t smem = sizeof(int32_t) * (size_t)W;
  cudaError_t err = cudaFuncSetAttribute(
      match_windows_kernel<LOG_W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  match_windows_kernel<LOG_W><<<(unsigned)R, T, smem, stream>>>(
      (const int32_t*)key, (const int32_t*)words, (int32_t*)out, R, nwords, depth, sentinel);
  return (int)cudaGetLastError();
}

// key, out: int32 (R, W); words: int32 (nwords, R, W); skey: int32 (R, W)
// scratch, used for windows wider than 32768 only.
extern "C" int tz_match_windows(const void* key, const void* words, void* out, void* skey,
                                int64_t R, int log_w, int nwords, int depth, int sentinel,
                                cudaStream_t stream) {
  if (log_w > 15) {
    if (skey == nullptr) return (int)cudaErrorInvalidValue;
    const int err = bitonic_sort_wide<15, false>((const int32_t*)key, (int32_t*)skey, nullptr,
                                                 R, log_w, stream);
    if (err != 0) return err;
    const int64_t n = R << log_w;
    match_wide_kernel<<<(unsigned)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16), 256,
                        0, stream>>>((const int32_t*)skey, (const int32_t*)words, (int32_t*)out,
                                     R, log_w, nwords, depth, sentinel);
    return (int)cudaGetLastError();
  }
  switch (log_w) {
    case 10: return launch_match<10>(key, words, out, R, nwords, depth, sentinel, stream);
    case 11: return launch_match<11>(key, words, out, R, nwords, depth, sentinel, stream);
    case 12: return launch_match<12>(key, words, out, R, nwords, depth, sentinel, stream);
    case 13: return launch_match<13>(key, words, out, R, nwords, depth, sentinel, stream);
    case 14: return launch_match<14>(key, words, out, R, nwords, depth, sentinel, stream);
    case 15: return launch_match<15>(key, words, out, R, nwords, depth, sentinel, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
