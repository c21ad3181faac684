// Row sort shared by K12 (sort.cu) and K13 (match.cu): a bitonic network in
// registers for rows of up to one CTA's width, and merge-path passes for
// wider rows.
//
// Counterpart of the network of tpu_zstd/ops/pallas_sort.py `_sort_body` /
// `_ce_stage`, which runs every compare-exchange stage over a row held in
// VMEM as lane and sublane rotates. Keys must be unique within a row and
// compare as signed int32; with SLOT every exchange also moves a slot (the
// element's original column), so payloads can follow by a gather.
//
// What bounds it on the H100: the network does log2(W) (log2(W) + 1) / 2
// stages of W / 2 compare-exchanges. Run as passes over shared memory with
// a barrier after each (91 at W 8192), the barriers and two shared loads an
// exchange set the time, far above the bytes the sort must move. So:
//
// 1. The network in registers (`network_sort`). Thread t of T holds the E
//    consecutive elements t E .. t E + E - 1 of a row of W = T E. A stage at
//    distance j < E exchanges two registers; E <= j < 32 E exchanges with
//    lane ^ (j / E) of the warp by `__shfl_xor_sync`; only j >= 32 E goes
//    through shared memory: every thread stores its E elements (16-byte
//    stores, chunk q at q ^ ((q >> 3) & 7), so each 8-thread phase hits 8
//    distinct bank groups), one barrier, every thread reads its partner's E
//    elements, one barrier. At W 8192 with E 16 that is 10 of the 91 stages
//    (20 barriers). Distances, register indices and (below the thread's
//    bits) directions are compile-time; an exchange is a compare and selects
//    (min and max where the direction is known), no branch. E 32 spilled
//    registers (K12) or halved the threads that run K13's compares, and was
//    slower in both.
// 2. Rows wider than one CTA sort in tiles of one CTA's width with the same
//    network, every tile ascending, then merge pairs of sorted runs until one
//    run spans the row (`merge_pass_kernel`, log2(W / tile) passes, each
//    reading and writing key and slot once). A CTA takes MERGE_C outputs: one
//    warp finds each end of its share on the merge path with a 32-way search
//    (32 probes a round), the share's two input runs are staged in shared
//    memory, each thread finds its own start by binary search and merges
//    MERGE_E elements, and the CTA stores its outputs with 16-byte stores.
//    Every CTA takes an equal share whatever the data. A bitonic network
//    across tiles would instead run one pass over device memory per
//    cross-tile stage. The last pass gathers the payloads (`Payloads`).
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;

// 16-byte chunk q of a shared buffer lives at chunk q ^ ((q >> 3) & 7).
__device__ __forceinline__ int swz_chunk(int q) { return q ^ ((q >> 3) & 7); }
// Word of element i in a buffer laid out by swz_chunk.
__device__ __forceinline__ int swz(int i) { return (swz_chunk(i >> 2) << 2) | (i & 3); }

// Thread t's E consecutive elements t E .. t E + E - 1 into / out of a
// swizzled shared buffer, as 16-byte accesses.
template <int E>
__device__ __forceinline__ void put_chunks(int32_t* buf, int t, const int32_t (&v)[E]) {
  int4* b = reinterpret_cast<int4*>(buf);
#pragma unroll
  for (int c = 0; c < E / 4; ++c)
    b[swz_chunk(t * (E / 4) + c)] = make_int4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
}

__device__ __forceinline__ int4 get_chunk(const int32_t* buf, int q) {
  return reinterpret_cast<const int4*>(buf)[swz_chunk(q)];
}

// Keep the partner's element q (slot qs) where it belongs on this side:
// the smaller key when keep_min, else the larger (keys are unique).
template <bool SLOT>
__device__ __forceinline__ void keep(int32_t& k, int32_t& s, int32_t q, int32_t qs,
                                     bool keep_min) {
  const bool take = (q < k) == keep_min;
  k = take ? q : k;
  if (SLOT) s = take ? qs : s;
}

// Compare-exchange of registers a (lower index) and b; desc: the pair's run
// is descending.
template <bool SLOT>
__device__ __forceinline__ void ce(int32_t& a, int32_t& b, int32_t& sa, int32_t& sb, bool desc) {
  if (SLOT) {
    const bool sw = (a > b) != desc;
    const int32_t ta = a, ts = sa;
    a = sw ? b : a;
    b = sw ? ta : b;
    sa = sw ? sb : sa;
    sb = sw ? ts : sb;
  } else {
    const bool sw = (a > b) != desc;
    const int32_t ta = a;
    a = sw ? b : a;
    b = sw ? ta : b;
  }
}

// The same with the direction known at compile time: min and max.
__device__ __forceinline__ void ce_keys(int32_t& a, int32_t& b, bool desc) {
  const int32_t lo = min(a, b), hi = max(a, b);
  a = desc ? hi : lo;
  b = desc ? lo : hi;
}

// Sorts the row of W = 2^(LOG_E + LOG_T) elements that the CTA's T threads
// hold, E = 2^LOG_E each (thread t: elements t E + e in k[e], s[e]),
// ascending. xk (and xs with SLOT) are shared buffers of W words for the
// exchanges across warps. Every thread of the CTA must call it.
template <int LOG_E, int LOG_T, bool SLOT>
__device__ __forceinline__ void network_sort(int32_t (&k)[1 << LOG_E], int32_t (&s)[1 << LOG_E],
                                             int32_t* xk, int32_t* xs) {
  constexpr int E = 1 << LOG_E;
  constexpr int LOG_W = LOG_E + LOG_T;
  static_assert(LOG_E >= 2 && LOG_T >= 5, "E >= 4 and at least one warp");
  const int t = threadIdx.x;
#pragma unroll
  for (int L = 1; L <= LOG_W; ++L) {
    // Level L merges runs of 2^L; an element's run is descending when bit L
    // of its index is set (never at the last level). At L >= LOG_E that bit
    // is the thread's.
    const bool tdesc = L < LOG_W && L >= LOG_E && ((t >> (L - LOG_E)) & 1);
#pragma unroll
    for (int b = L - 1; b >= 0; --b) {
      if (b < LOG_E) {  // partner in this thread's registers
#pragma unroll
        for (int e = 0; e < E; ++e) {
          if (e & (1 << b)) continue;
          if (!SLOT && (L < LOG_E || L == LOG_W))
            ce_keys(k[e], k[e | (1 << b)], L < LOG_E && ((e >> L) & 1));
          else
            ce<SLOT>(k[e], k[e | (1 << b)], s[e], s[e | (1 << b)],
                     L < LOG_E ? ((e >> L) & 1) : tdesc);
        }
      } else if (b < LOG_E + 5) {  // partner in this warp
        const int m = 1 << (b - LOG_E);
        const bool keep_min = ((t & m) == 0) != tdesc;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int32_t q = __shfl_xor_sync(FULL_MASK, k[e], m);
          const int32_t qs = SLOT ? __shfl_xor_sync(FULL_MASK, s[e], m) : 0;
          keep<SLOT>(k[e], s[e], q, qs, keep_min);
        }
      } else {  // partner in another warp: through shared memory
        const int m = 1 << (b - LOG_E);
        const bool keep_min = ((t & m) == 0) != tdesc;
        __syncthreads();  // the previous exchange's reads are done
        put_chunks<E>(xk, t, k);
        if (SLOT) put_chunks<E>(xs, t, s);
        __syncthreads();
        const int p = t ^ m;
#pragma unroll
        for (int c = 0; c < E / 4; ++c) {
          const int4 q = get_chunk(xk, p * (E / 4) + c);
          const int4 qs = SLOT ? get_chunk(xs, p * (E / 4) + c) : make_int4(0, 0, 0, 0);
          keep<SLOT>(k[4 * c], s[4 * c], q.x, qs.x, keep_min);
          keep<SLOT>(k[4 * c + 1], s[4 * c + 1], q.y, qs.y, keep_min);
          keep<SLOT>(k[4 * c + 2], s[4 * c + 2], q.z, qs.z, keep_min);
          keep<SLOT>(k[4 * c + 3], s[4 * c + 3], q.w, qs.w, keep_min);
        }
      }
    }
  }
}

// Thread t's E consecutive int32 from / to memory (16-byte aligned).
template <int E>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ src, int t,
                                         int32_t (&v)[E]) {
  const int4* p = reinterpret_cast<const int4*>(src) + t * (E / 4);
#pragma unroll
  for (int c = 0; c < E / 4; ++c) {
    const int4 x = p[c];
    v[4 * c] = x.x;
    v[4 * c + 1] = x.y;
    v[4 * c + 2] = x.z;
    v[4 * c + 3] = x.w;
  }
}

template <int E>
__device__ __forceinline__ void store_row(int32_t* dst, int t, const int32_t (&v)[E],
                                          int32_t add = 0) {
  int4* p = reinterpret_cast<int4*>(dst) + t * (E / 4);
#pragma unroll
  for (int c = 0; c < E / 4; ++c)
    p[c] = make_int4(v[4 * c] + add, v[4 * c + 1] + add, v[4 * c + 2] + add, v[4 * c + 3] + add);
}

// --- merge path ------------------------------------------------------------------

constexpr int MERGE_T = 256;                // threads a CTA
constexpr int MERGE_E = 16;                 // outputs a thread
constexpr int MERGE_C = MERGE_T * MERGE_E;  // outputs a CTA

// Elements of A among the first d outputs of merging the ascending runs A
// and B of length L each (unique keys): the smallest a in
// [max(0, d - L), min(d, L)] with a == min(d, L) or A[a] > B[d - 1 - a].
// Called by a whole warp: 32 probes a round narrow the range 32-fold.
__device__ __forceinline__ int path_split(const int32_t* __restrict__ A,
                                          const int32_t* __restrict__ B, int L, int d) {
  const int lane = threadIdx.x & 31;
  int lo = max(0, d - L), hi = min(d, L);
  while (hi > lo) {
    const int64_t n = hi - lo;
    const int a = lo + (int)((n * lane) >> 5);
    const unsigned m = __ballot_sync(FULL_MASK, A[a] > B[d - 1 - a]);
    const int f = m ? __ffs((int)m) - 1 : 32;
    const int a_hi = f < 32 ? lo + (int)((n * f) >> 5) : hi;
    lo = f > 0 ? lo + (int)((n * (f - 1)) >> 5) + 1 : lo;
    hi = a_hi;
  }
  return lo;
}

// The payloads a sort carries, passed by value (no pointer array in device
// memory, so no copy to the device before a launch): payload p is the int32
// (R, 2^log_w) rows at in[p] / out[p].
constexpr int MAX_PAY = 32;
struct Payloads {
  int64_t in[MAX_PAY];
  int64_t out[MAX_PAY];
  int n;
};

// One pass over (R, 2^log_w) rows made of sorted runs of 2^log_run: merges
// each pair of runs into one. kin/sin: keys and slots in; kout/sout: out.
// GATHER (the last pass): instead of storing the slots, each output gathers
// the element at its slot of every payload row; without SLOT the slot is the
// key's low log_w bits (K13's keys carry their position there).
template <bool SLOT, bool GATHER>
__global__ void __launch_bounds__(MERGE_T)
merge_pass_kernel(const int32_t* __restrict__ kin, const int32_t* __restrict__ sin,
                  int32_t* __restrict__ kout, int32_t* __restrict__ sout, Payloads pay,
                  int log_w, int log_run) {
  __shared__ int4 sm[(SLOT ? 2 : 1) * MERGE_C / 4];
  __shared__ int split[2];
  int32_t* sk = reinterpret_cast<int32_t*>(sm);
  int32_t* ss = sk + MERGE_C;
  const int t = threadIdx.x;
  const int64_t o = (int64_t)blockIdx.x * MERGE_C;
  const int64_t rb = (o >> log_w) << log_w;
  const int col = (int)(o - rb);
  const int L = 1 << log_run;
  const int64_t a_base = rb + (col & ~(2 * L - 1));
  const int d0 = col & (2 * L - 1);
  if (t < 64) {
    const int a = path_split(kin + a_base, kin + a_base + L, L, d0 + (t >> 5) * MERGE_C);
    if ((t & 31) == 0) split[t >> 5] = a;
  }
  __syncthreads();
  const int a0 = split[0];
  const int na = split[1] - a0, nb = MERGE_C - na;
  const int64_t b_base = a_base + L + (d0 - a0) - na;
  for (int i = t; i < MERGE_C; i += MERGE_T) {
    const int64_t g = i < na ? a_base + a0 + i : b_base + i;
    sk[i] = kin[g];
    if (SLOT) ss[i] = sin[g];
  }
  __syncthreads();
  // This thread's outputs dt .. dt + MERGE_E - 1 of the share.
  const int dt = t * MERGE_E;
  int lo = max(0, dt - nb), hi = min(dt, na);
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sk[mid] > sk[na + dt - 1 - mid]) hi = mid;
    else lo = mid + 1;
  }
  int ia = lo, ib = dt - lo;
  int32_t ka = ia < na ? sk[ia] : 0, kb = ib < nb ? sk[na + ib] : 0;
  int32_t ok[MERGE_E], os[MERGE_E];
#pragma unroll
  for (int r = 0; r < MERGE_E; ++r) {
    const bool ta = ib >= nb || (ia < na && ka < kb);
    ok[r] = ta ? ka : kb;
    if (SLOT) os[r] = ss[ta ? ia : na + ib];
    ia += ta;
    ib += !ta;
    const bool more = ta ? ia < na : ib < nb;
    const int32_t v = more ? sk[ta ? ia : na + ib] : 0;
    ka = ta ? v : ka;
    kb = ta ? kb : v;
  }
  __syncthreads();
  put_chunks<MERGE_E>(sk, t, ok);
  if (SLOT) put_chunks<MERGE_E>(ss, t, os);
  __syncthreads();
  const int32_t pmask = (int32_t)((1LL << log_w) - 1);
  for (int q = t; q < MERGE_C / 4; q += MERGE_T) {
    const int4 kq = get_chunk(sk, q);
    reinterpret_cast<int4*>(kout + o)[q] = kq;
    if (SLOT && !GATHER) reinterpret_cast<int4*>(sout + o)[q] = get_chunk(ss, q);
    if (!GATHER) continue;
    const int4 sl = SLOT ? get_chunk(ss, q)
                         : make_int4(kq.x & pmask, kq.y & pmask, kq.z & pmask, kq.w & pmask);
    for (int p = 0; p < pay.n; ++p) {
      const int32_t* in = reinterpret_cast<const int32_t*>(pay.in[p]) + rb;
      reinterpret_cast<int4*>(reinterpret_cast<int32_t*>(pay.out[p]) + o)[q] =
          make_int4(in[sl.x], in[sl.y], in[sl.z], in[sl.w]);
    }
  }
}

// Merges the sorted runs of 2^log_tile of (R, 2^log_w) rows into sorted rows.
// Buffers: keys kb0 (the tile sort's output), kb1; slots sb0 (the tile
// sort's), sb1 (SLOT only). Pass p reads buffer p % 2 and writes (p + 1) %
// 2; the last pass writes its keys to kfin (which must not be the last
// pass's input) and gathers the payloads (by slot with SLOT, else by the
// key's low bits). Returns the launch error.
template <bool SLOT>
int merge_rows(int32_t* kb0, int32_t* kb1, int32_t* sb0, int32_t* sb1, int32_t* kfin,
               Payloads pay, int64_t R, int log_w, int log_tile, cudaStream_t stream) {
  int32_t* kb[2] = {kb0, kb1};
  int32_t* sb[2] = {sb0, sb1};
  const unsigned grid = (unsigned)((R << log_w) / MERGE_C);
  for (int run = log_tile; run < log_w; ++run) {
    const int p = run - log_tile;
    const bool last = run == log_w - 1;
    int32_t* ko = last ? kfin : kb[(p + 1) & 1];
    if (last && pay.n > 0)
      merge_pass_kernel<SLOT, true><<<grid, MERGE_T, 0, stream>>>(
          kb[p & 1], sb[p & 1], ko, nullptr, pay, log_w, run);
    else if (last || !SLOT)
      merge_pass_kernel<false, false><<<grid, MERGE_T, 0, stream>>>(
          kb[p & 1], nullptr, ko, nullptr, pay, log_w, run);
    else
      merge_pass_kernel<true, false><<<grid, MERGE_T, 0, stream>>>(
          kb[p & 1], sb[p & 1], ko, sb[(p + 1) & 1], pay, log_w, run);
  }
  return (int)cudaGetLastError();
}

}  // namespace
