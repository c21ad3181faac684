// K13: fused window-local LZ77 match finder, one window a CTA.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_match.py
// `match_windows` (`_match_windows_impl` / `_make_match_kernel`). Per
// window of W = 2^LOG_W positions, with key = hash << LOG_W | pos (hash ==
// sentinel on dead rows, any int32 key otherwise; keys compare signed):
//   1. sort the keys ascending;
//   2. for d = 1..depth compare each sorted row with the d-th previous one:
//      where both hashes are equal and real (below the sentinel) and the row
//      has a d-th predecessor, the match length is the count of equal
//      leading bytes of the two positions' suffix words (4 bytes a word,
//      stopping at the first word that differs); the strictly longest wins,
//      so the smallest offset wins a tie;
//   3. write (ml << LOG_W | off) back in position order.
//
// The TPU kernel carries the nwords suffix words through its sort and sorts
// (pos, packed) again to restore position order. Here only the keys are
// sorted: a sorted key's low LOG_W bits are its position (the JAX kernel's
// contract), so the words of a row and of its predecessor are found by
// those positions, and since the sorted positions are a permutation of the
// window, the restore sort becomes a store to the position.
//
// Bound: bytes (the key and the nwords word rows read once, ml and off
// written once) or, where larger, the depth compares this data needs (6
// int32 operations a compared pair, 4 a position). Two things bind a plain
// design: the sort (91 barriered stages in shared memory at W 8192) and the
// compares' scattered 4-byte loads of the words from device memory (the
// first word of two positions with one hash is nearly always equal, so
// nearly every compare goes on to the second). So:
// - The keys sort in registers with the network of bitonic.cuh (16 keys a
//   thread over 512 threads at W 8192, 16-byte loads; 10 of its 91 stages
//   through shared memory).
// - While the keys sort, cp.async stages the window's first two suffix
//   words in shared memory (64 KB at W 8192; 96 KB with the keys: two CTAs
//   an SM). After the sort each thread gathers the words of its sorted keys
//   and stores them back in sorted order, so that the compares read a
//   position's words and its candidates' at neighbouring addresses, without
//   bank conflicts. Words from the third on come from device memory, only
//   for pairs whose first 8 bytes are equal.
// - The compares run one sorted position a thread, consecutive positions in
//   consecutive lanes, the next candidate's key loaded with the current
//   candidate's words. Two shortcuts change no result: equal hashes are
//   contiguous in sorted order, so the depth loop stops at the first
//   predecessor with another hash; and it stops once a match spans every
//   word, since no later candidate can be strictly longer. Their loops
//   diverge (a warp runs as long as its longest chain): at depth 8 the
//   compares take about 0.17 ms of the 0.43 at 2048 x 8192 (PERF.md).
// - The results go to shared memory at their positions, then out as ml and
//   off with 16-byte stores (the wrapper does not unpack them).
// Windows wider than 8192 positions (any power of two up to 2^30): the same
// kernel sorts tiles of 8192 keys into scratch, the merge-path passes of
// bitonic.cuh merge them into sorted windows, the last pass gathering the
// first two suffix words into sorted order by the keys' positions; then a
// second kernel, one thread a sorted position, runs the same compares
// against those rows in device memory, stores each packed result at its
// position, and a third splits them into ml and off.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

namespace {

constexpr int MATCH_LOG_TILE = 13;  // widest window one CTA takes: 8192

__host__ __device__ constexpr int match_log_e(int log_w) { return log_w <= 11 ? 3 : 4; }
// At W 8192 (the keys and two suffix words, 96 KB of shared memory) two
// CTAs an SM.
__host__ __device__ constexpr int match_min_blocks(int log_w) { return log_w == 13 ? 2 : 1; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

// Equal leading bytes of two little-endian words whose XOR is x != 0.
__device__ __forceinline__ int equal_bytes(uint32_t x) { return (__ffs((int)x) - 1) >> 3; }

// The depth compares of sorted position i of a window: key_at(j) is sorted
// key j, word_at(k, j, pos) suffix word k (0 or 1) of sorted key j, whose
// position is pos; words from 2 on come from wrow (word k of position pos at
// wrow[k * plane + pos]). Returns (ml << log_w | off).
template <class KeyAt, class WordAt>
__device__ __forceinline__ int32_t match_pos(KeyAt key_at, WordAt word_at, int i, int log_w,
                                             const int32_t* __restrict__ wrow, int64_t plane,
                                             int nwords, int depth, int sentinel) {
  const int pmask = (1 << log_w) - 1;
  const int32_t sk = key_at(i);
  const int32_t sh = sk >> log_w;
  const int sp = sk & pmask;
  int best_ml = 0, best_off = 0;
  if (sh < sentinel && nwords > 0) {
    const int full = 4 * nwords;
    const int dmax = min(depth, i);
    const int32_t a0 = word_at(0, i, sp);
    const int32_t a1 = nwords > 1 ? word_at(1, i, sp) : 0;
    int32_t pk = dmax > 0 ? key_at(i - 1) : 0;
    for (int d = 1; d <= dmax; ++d) {
      if ((pk >> log_w) != sh) break;
      const int pp = pk & pmask;
      // Both words of the candidate and the next candidate's key at once.
      const int32_t b0 = word_at(0, i - d, pp);
      const int32_t b1 = nwords > 1 ? word_at(1, i - d, pp) : 0;
      const int32_t next = d < dmax ? key_at(i - d - 1) : 0;
      uint32_t x = (uint32_t)(a0 ^ b0);
      int ml = 0;
      if (x == 0) {
        ml = 4;
        if (nwords > 1) {
          x = (uint32_t)(a1 ^ b1);
          if (x == 0) {
            ml = 8;
            for (int k = 2; k < nwords; ++k) {
              x = (uint32_t)(wrow[k * plane + sp] ^ wrow[k * plane + pp]);
              if (x != 0) break;
              ml += 4;
            }
          }
        }
      }
      if (x != 0) ml += equal_bytes(x);
      if (ml > best_ml) {
        best_ml = ml;
        best_off = sp - pp;
        if (ml == full) break;
      }
      pk = next;
    }
  }
  return (int32_t)(((uint32_t)best_ml << log_w) | (uint32_t)best_off);
}

// One window a CTA: sort the keys in registers; with sorted_out (tile
// mode), store the sorted keys there and stop; else stage the first two
// suffix words, put them in sorted order, run the compares and store the
// results in position order.
template <int LOG_W>
__global__ void __launch_bounds__(1 << (LOG_W - match_log_e(LOG_W)), match_min_blocks(LOG_W))
match_windows_kernel(const int32_t* __restrict__ key, const int32_t* __restrict__ words,
                     int32_t* __restrict__ ml_out, int32_t* __restrict__ off_out, int64_t R,
                     int nwords, int depth, int sentinel, int32_t* __restrict__ sorted_out) {
  constexpr int LOG_E = match_log_e(LOG_W);
  constexpr int E = 1 << LOG_E;
  constexpr int W = 1 << LOG_W;
  constexpr int T = W / E;
  extern __shared__ int4 smem4[];
  int32_t* s_key = reinterpret_cast<int32_t*>(smem4);  // swizzled in the network, then sorted
  int32_t* s_w = s_key + W;  // suffix words 0 and 1 by position, then in sorted order
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x << LOG_W;
  const int64_t plane = R << LOG_W;  // stride from one suffix word to the next
  const int staged = sorted_out == nullptr ? min(nwords, 2) : 0;
  for (int w = 0; w < staged; ++w) {
    for (int q = t; q < W / 4; q += T)
      cp_async16(s_w + w * W + 4 * q, words + w * plane + base + 4 * q);
  }
  asm volatile("cp.async.commit_group;\n");
  int32_t k[E], v[E];
  load_row<E>(key + base, t, k);
  network_sort<LOG_E, LOG_W - LOG_E, false>(k, v, s_key, nullptr);
  if (sorted_out != nullptr) {
    store_row<E>(sorted_out + base, t, k);
    return;
  }
  asm volatile("cp.async.wait_group 0;\n");
  __syncthreads();  // the network's last reads of s_key are done; the words are staged
  store_row<E>(s_key, t, k);
  // Each staged word into sorted order: gather by the sorted positions, then
  // store in place once every thread has read the word by position.
  for (int w = 0; w < staged; ++w) {
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = s_w[w * W + (k[e] & (W - 1))];
    __syncthreads();
    store_row<E>(s_w + w * W, t, v);
  }
  __syncthreads();
  const int32_t* wrow = words + base;
#pragma unroll
  for (int r = 0; r < E; ++r)
    v[r] = match_pos([&](int j) { return s_key[j]; },
                     [&](int w, int j, int) { return s_w[w * W + j]; }, r * T + t, LOG_W, wrow,
                     plane, nwords, depth, sentinel);
  __syncthreads();  // every compare has read s_w
#pragma unroll
  for (int r = 0; r < E; ++r) s_w[s_key[r * T + t] & (W - 1)] = v[r];
  __syncthreads();
  for (int q = t; q < W / 4; q += T) {
    const int4 p = reinterpret_cast<const int4*>(s_w)[q];
    reinterpret_cast<int4*>(ml_out + base)[q] =
        make_int4(p.x >> LOG_W, p.y >> LOG_W, p.z >> LOG_W, p.w >> LOG_W);
    reinterpret_cast<int4*>(off_out + base)[q] =
        make_int4(p.x & (W - 1), p.y & (W - 1), p.z & (W - 1), p.w & (W - 1));
  }
}

// Windows wider than one CTA: the compares of every sorted position against
// the sorted keys skey and the first two suffix words in sorted order (sw0,
// sw1), all in device memory, so that a position and its candidates are
// neighbours; the packed result goes to packed_out at the position (one
// scattered store; unpack_kernel then splits it with 16-byte accesses).
__global__ void __launch_bounds__(256)
match_wide_kernel(const int32_t* __restrict__ skey, const int32_t* __restrict__ sw0,
                  const int32_t* __restrict__ sw1, const int32_t* __restrict__ words,
                  int32_t* __restrict__ packed_out, int64_t R, int log_w, int nwords, int depth,
                  int sentinel) {
  const int64_t n = R << log_w;
  for (int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (int64_t)gridDim.x * blockDim.x) {
    const int64_t base = (e >> log_w) << log_w;
    const int32_t* krow = skey + base;
    const int32_t* w0 = sw0 + base;
    const int32_t* w1 = sw1 + base;
    packed_out[base + (krow[e - base] & ((1 << log_w) - 1))] =
        match_pos([&](int j) { return krow[j]; },
                  [&](int w, int j, int) { return (w ? w1 : w0)[j]; }, (int)(e - base), log_w,
                  words + base, n, nwords, depth, sentinel);
  }
}

// (ml << log_w | off) -> ml, off.
__global__ void __launch_bounds__(256)
unpack_kernel(const int4* __restrict__ packed, int4* __restrict__ ml, int4* __restrict__ off,
              int64_t n4, int log_w) {
  const int32_t pmask = (1 << log_w) - 1;
  for (int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; q < n4;
       q += (int64_t)gridDim.x * blockDim.x) {
    const int4 p = packed[q];
    ml[q] = make_int4(p.x >> log_w, p.y >> log_w, p.z >> log_w, p.w >> log_w);
    off[q] = make_int4(p.x & pmask, p.y & pmask, p.z & pmask, p.w & pmask);
  }
}

template <int LOG_W>
int launch_match(const int32_t* key, const int32_t* words, int32_t* ml, int32_t* off, int64_t R,
                 int nwords, int depth, int sentinel, int32_t* sorted_out, int64_t grid,
                 cudaStream_t stream) {
  // The keys, then (unless tile mode) word 0 / the results and word 1.
  const int bufs = sorted_out ? 1 : 1 + max(1, min(nwords, 2));
  const int smem = bufs * (int)sizeof(int32_t) << LOG_W;
  cudaError_t err = cudaFuncSetAttribute(match_windows_kernel<LOG_W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  match_windows_kernel<LOG_W><<<(unsigned)grid, 1 << (LOG_W - match_log_e(LOG_W)), smem, stream>>>(
      key, words, ml, off, R, nwords, depth, sentinel, sorted_out);
  return (int)cudaGetLastError();
}

}  // namespace

// key, ml, off: int32 (R, W); words: int32 (nwords, R, W); all 16-byte
// aligned; scratch: int32 (4, R, W), used for windows wider than 8192 only.
extern "C" int tz_match_windows(const void* key, const void* words, void* ml, void* off,
                                void* scratch, int64_t R, int log_w, int nwords, int depth,
                                int sentinel, cudaStream_t stream) {
  const int32_t* k = (const int32_t*)key;
  const int32_t* w = (const int32_t*)words;
  int32_t* m = (int32_t*)ml;
  int32_t* o = (int32_t*)off;
  switch (log_w) {
    case 10: return launch_match<10>(k, w, m, o, R, nwords, depth, sentinel, nullptr, R, stream);
    case 11: return launch_match<11>(k, w, m, o, R, nwords, depth, sentinel, nullptr, R, stream);
    case 12: return launch_match<12>(k, w, m, o, R, nwords, depth, sentinel, nullptr, R, stream);
    case 13: return launch_match<13>(k, w, m, o, R, nwords, depth, sentinel, nullptr, R, stream);
    default: break;
  }
  if (log_w <= MATCH_LOG_TILE || log_w > 30 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  // Scratch: two key buffers for the merge passes, then the first two
  // suffix words in sorted order, which the last pass gathers by position.
  const int64_t n = R << log_w;
  int32_t* s0 = (int32_t*)scratch;
  int32_t* s1 = s0 + n;
  int err = launch_match<MATCH_LOG_TILE>(k, w, m, o, R, nwords, depth, sentinel, s0,
                                        n >> MATCH_LOG_TILE, stream);
  if (err != 0) return err;
  // The passes alternate s0 -> s1 -> s0 ...; the last writes the other
  // buffer than the one it reads.
  int32_t* sorted = (log_w - MATCH_LOG_TILE) & 1 ? s1 : s0;
  Payloads pay = {};
  pay.n = min(nwords, 2);
  for (int p = 0; p < pay.n; ++p) {
    pay.in[p] = (int64_t)(w + p * n);
    pay.out[p] = (int64_t)(s0 + (2 + p) * n);
  }
  err = merge_rows<false>(s0, s1, nullptr, nullptr, sorted, pay, R, log_w, MATCH_LOG_TILE,
                          stream);
  if (err != 0) return err;
  // The packed results go to the key buffer the last pass did not write.
  int32_t* packed = sorted == s0 ? s1 : s0;
  const unsigned grid = (unsigned)(n / 256 < 132 * 16 ? n / 256 : 132 * 16);
  match_wide_kernel<<<grid, 256, 0, stream>>>(sorted, s0 + 2 * n, s0 + 3 * n, w, packed, R, log_w,
                                              nwords, depth, sentinel);
  unpack_kernel<<<grid, 256, 0, stream>>>((const int4*)packed, (int4*)m, (int4*)o, n / 4, log_w);
  return (int)cudaGetLastError();
}
