// K4: exact repeat-offset (repcode) assignment: a chunked walk with an exact
// fix-up, one CTA per block.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_rep.py `rep_codes`
// (`_rep_impl` / `_make_kernel`, step `_rep_step`). Input per sequence row:
// off | has_lit << 21 | valid << 22; output: the offset-base value (1..3 for
// a repcode, off + 3 otherwise), 0 on rows with valid == 0. The history is
// the 3-entry move-to-front state with known-flags; it starts all zero and
// unknown, because blocks are compressed independently while the decoder
// carries rep history across blocks (RFC 8878 §3.1.1.5). Invalid rows keep
// the state.
//
// Bound: bytes (4 read and 4 written per row). A walk of one thread per
// block is bound instead by its chain of dependent steps (~150 ns a row from
// device memory), so the rows of each block are split into chunks walked in
// parallel:
//   - one CTA of 1024 threads per block; the block's rows are staged in
//     shared memory (tiles of 32768 rows, 16-byte coalesced loads; one word
//     of skew every 32 rows keeps the chunk walks free of bank conflicts);
//   - speculative walk: thread t walks chunk t (rows / 1024 rows) from the
//     all-unknown state (chunk 0 from the true state carried into the tile)
//     and keeps each row's repcode (2 bits) beside its input in shared
//     memory;
//   - exact fix-up in rounds: every chunk whose start state changed (the
//     end state of the nearest earlier chunk with a valid row: a chunk of
//     invalid rows, such as those past a block's last sequence, passes the
//     state on unchanged and is not walked) re-walks in lockstep from its
//     old and its new start, rewriting the codes, until the two states are
//     equal (values and known-flags): from that row on the old walk is
//     right, so the old end state stands. A chunk that reaches its end
//     without meeting passes on the new end state. Rounds end when no start
//     changed (`__syncthreads_or`). Chunk 0 is exact from the start and
//     chunk c after at most c rounds, so this is exact for every input.
//     After a valid row, v0 is that row's offset, so a chunk usually forgets
//     its start within a few rows and one or two rounds suffice; offsets
//     alternating between two values keep an old v2 and never meet: then
//     every round re-walks whole chunks in lockstep and the true state moves
//     on by one chunk a round. After 16 rounds one thread finishes the tile
//     in chunk order instead (a chunk whose start is the true state stands,
//     any other is walked once from it): a serial walk over shared memory
//     in the worst case;
//   - the codes are decoded to offset-base values and written back
//     coalesced.
// Optional stats (5 int32 per block): chunks, chunks whose re-walk reached
// the chunk's end without meeting, fix-up rounds, rows re-walked, tiles the
// one thread finished.
#include <cuda_runtime.h>
#include <stdint.h>

#define REP_THREADS 1024
#define REP_TILE 32768
#define REP_IN_MASK ((1 << 23) - 1)
#define REP_MAX_ROUNDS 16  // fix-up rounds before one thread finishes the tile

struct RepState {
  int v0, v1, v2, k;  // k: known-flags, bit i for entry i
};

__device__ __forceinline__ bool rep_eq(const RepState& a, const RepState& b) {
  return a.v0 == b.v0 && a.v1 == b.v1 && a.v2 == b.v2 && a.k == b.k;
}

__host__ __device__ __forceinline__ int rep_skew(int r) { return r + (r >> 5); }

// One row of the walk: returns the repcode (1..3) or 0, and updates s.
__device__ __forceinline__ int rep_step(RepState& s, int x) {
  if (!((x >> 22) & 1)) return 0;
  const int off = x & ((1 << 21) - 1);
  const bool ll = (x >> 21) & 1;
  const bool k0 = s.k & 1, k1 = (s.k >> 1) & 1, k2 = (s.k >> 2) & 1;
  const bool h0 = k0 && off == s.v0;
  const bool h1 = k1 && off == s.v1;
  const bool h2 = k2 && off == s.v2;
  const bool hm1 = k0 && off == s.v0 - 1 && off != 0;  // ll == 0 repcode 3
  const int code = ll ? (h0 ? 1 : h1 ? 2 : h2 ? 3 : 0) : (h1 ? 1 : h2 ? 2 : hm1 ? 3 : 0);
  if (ll && h0) return code;  // history unchanged
  // History update in the host rule's priority order.
  const bool swap = ll ? (!h0 && h1) : h1;
  const bool rot = ll ? (!h0 && !h1 && h2) : (!h1 && h2);
  const int n0 = swap ? s.v1 : rot ? s.v2 : off;
  const bool nk0 = swap ? k1 : rot ? k2 : true;
  int v2 = s.v2;
  bool nk2 = k2;
  if (!swap) {
    v2 = s.v1;
    nk2 = k1;
  }
  s.v2 = v2;
  s.v1 = s.v0;
  s.v0 = n0;
  s.k = (int)nk0 | ((int)k0 << 1) | ((int)nk2 << 2);
  return code;
}

__device__ __forceinline__ int4 rep_pack(const RepState& s) {
  return make_int4(s.v0, s.v1, s.v2, s.k);
}

__device__ __forceinline__ RepState rep_unpack(const int4& p) { return {p.x, p.y, p.z, p.w}; }

// Re-walk rows [lo, hi) in lockstep from the start state the stored codes
// were walked from (a) and a new one (b), rewriting the codes, until the
// two states are equal. Returns whether they met; b ends as the new walk's
// state where it stopped.
__device__ __forceinline__ bool rep_rewalk(int* sx, int lo, int hi, RepState a, RepState& b,
                                           int& rewalked) {
  int r = lo;
  for (; r < hi && !rep_eq(a, b); ++r) {
    const int d = rep_skew(r);
    const int x = sx[d] & REP_IN_MASK;
    rep_step(a, x);
    sx[d] = x | (rep_step(b, x) << 23);
  }
  rewalked += r - lo;
  return rep_eq(a, b);
}

__device__ __forceinline__ int rep_decode(int w) {
  const int code = (w >> 23) & 3;
  if (code) return code;
  return ((w >> 22) & 1) ? (w & ((1 << 21) - 1)) + 3 : 0;
}

__global__ void __launch_bounds__(REP_THREADS, 1)
rep_codes_kernel(const int32_t* __restrict__ packed, int32_t* __restrict__ out,
                 int32_t* __restrict__ stats, int rows) {
  extern __shared__ int4 rep_smem[];
  int4* s_end = rep_smem;                  // each chunk's end state
  int4* s_start = rep_smem + REP_THREADS;  // each chunk's start state (one-thread finish)
  int* sx = reinterpret_cast<int*>(rep_smem + 2 * REP_THREADS);  // skewed rows
  __shared__ int s_scan[REP_THREADS / 32];
  __shared__ int4 s_carry;
  __shared__ int s_unmet, s_rounds, s_rewalked, s_chunks, s_serial;
  const int tid = threadIdx.x;
  const int32_t* in = packed + (int64_t)blockIdx.x * rows;
  int32_t* o = out + (int64_t)blockIdx.x * rows;
  if (tid == 0) s_unmet = s_rounds = s_rewalked = s_chunks = s_serial = 0;
  RepState carry = {0, 0, 0, 0};
  for (int t0 = 0; t0 < rows; t0 += REP_TILE) {
    const int n = min(REP_TILE, rows - t0);
    const bool vec = ((reinterpret_cast<uintptr_t>(in + t0) |
                       reinterpret_cast<uintptr_t>(o + t0)) & 15) == 0;
    const int nv = vec ? n >> 2 : 0;
    for (int q = tid; q < nv; q += REP_THREADS) {
      const int4 v = reinterpret_cast<const int4*>(in + t0)[q];
      const int d = rep_skew(4 * q);  // the 4 rows share one 32-row group
      sx[d] = v.x & REP_IN_MASK;
      sx[d + 1] = v.y & REP_IN_MASK;
      sx[d + 2] = v.z & REP_IN_MASK;
      sx[d + 3] = v.w & REP_IN_MASK;
    }
    for (int r = 4 * nv + tid; r < n; r += REP_THREADS) sx[rep_skew(r)] = in[t0 + r] & REP_IN_MASK;
    __syncthreads();

    // Speculative walk of each chunk.
    const int lc = (n + REP_THREADS - 1) / REP_THREADS;
    const int nch = (n + lc - 1) / lc;
    const int lo = min(tid * lc, n), hi = min(lo + lc, n);
    RepState start = {0, 0, 0, 0};
    if (tid == 0) start = carry;
    RepState e = start;
    bool any_valid = false;
    for (int r = lo; r < hi; ++r) {
      const int d = rep_skew(r);
      const int x = sx[d];
      any_valid |= (x >> 22) & 1;
      sx[d] = x | (rep_step(e, x) << 23);
    }
    s_end[tid] = make_int4(e.v0, e.v1, e.v2, e.k);
    // A chunk without a valid row passes its start state on unchanged, so
    // each chunk starts from the end of the nearest earlier chunk that has
    // one (an exclusive max-scan of chunk indices); the invalid rows past a
    // block's last sequence then cost no round.
    const bool active = any_valid;
    int pred, last;
    {
      const int lane = tid & 31, warp = tid >> 5;
      int inc = active ? tid : -1;
      for (int d = 1; d < 32; d <<= 1) inc = max(inc, __shfl_up_sync(0xffffffffu, inc, d));
      if (lane == 31) s_scan[warp] = inc;
      __syncthreads();
      if (warp == 0) {
        int w = s_scan[lane];
        for (int d = 1; d < 32; d <<= 1) w = max(w, __shfl_up_sync(0xffffffffu, w, d));
        s_scan[lane] = w;
      }
      __syncthreads();
      pred = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) pred = -1;
      if (warp) pred = max(pred, s_scan[warp - 1]);
      last = s_scan[REP_THREADS / 32 - 1];
    }

    // Exact fix-up in rounds.
    bool unmet = false;
    int rewalked = 0;
    bool serial = false;
    for (int round = 0;; ++round) {
      RepState ns = carry;
      if (pred >= 0) ns = rep_unpack(s_end[pred]);
      const bool changed = active && !rep_eq(ns, start);
      __syncthreads();  // every chunk has read its predecessor's end state
      if (changed) {
        RepState b = ns;
        if (!rep_rewalk(sx, lo, hi, start, b, rewalked)) {
          unmet = true;  // reached the end without meeting the old walk
          s_end[tid] = rep_pack(b);
        }
        start = ns;
      }
      const int any = __syncthreads_or(changed);
      if (tid == 0 && stats != nullptr) s_rounds += any;
      if (!any) break;
      if (round + 1 == REP_MAX_ROUNDS) {
        serial = true;
        break;
      }
    }
    if (serial) {
      // Still changing after REP_MAX_ROUNDS rounds: chunks that do not meet
      // move the true state on by one chunk a round, each round re-walking
      // them in lockstep. One thread finishes in chunk order instead: a chunk
      // whose start is the true state stands; any other is walked once from
      // the true state.
      s_start[tid] = rep_pack(start);
      s_start[tid].w |= active ? 8 : 0;
      __syncthreads();
      if (tid == 0) {
        RepState st = carry;
        for (int i = 0; i < nch; ++i) {
          const int4 q = s_start[i];
          if (!(q.w & 8)) continue;
          if (rep_eq(rep_unpack(make_int4(q.x, q.y, q.z, q.w & 7)), st)) {
            st = rep_unpack(s_end[i]);
            continue;
          }
          const int clo = i * lc, chi = min(clo + lc, n);
          for (int r = clo; r < chi; ++r) {
            const int d = rep_skew(r);
            const int x = sx[d] & REP_IN_MASK;
            sx[d] = x | (rep_step(st, x) << 23);
          }
          rewalked += chi - clo;
        }
        s_carry = rep_pack(st);
      }
      __syncthreads();
      carry = rep_unpack(s_carry);
    } else if (last >= 0) {
      carry = rep_unpack(s_end[last]);
    }
    if (stats != nullptr) {
      if (unmet) atomicAdd(&s_unmet, 1);
      if (rewalked) atomicAdd(&s_rewalked, rewalked);
      if (tid == 0) {
        s_chunks += nch;
        s_serial += serial;
      }
    }

    // Decode the codes and write back.
    for (int q = tid; q < nv; q += REP_THREADS) {
      const int d = rep_skew(4 * q);
      reinterpret_cast<int4*>(o + t0)[q] =
          make_int4(rep_decode(sx[d]), rep_decode(sx[d + 1]), rep_decode(sx[d + 2]),
                    rep_decode(sx[d + 3]));
    }
    for (int r = 4 * nv + tid; r < n; r += REP_THREADS) o[t0 + r] = rep_decode(sx[rep_skew(r)]);
    __syncthreads();  // before the next tile overwrites the rows and states
  }
  if (stats != nullptr && tid == 0) {
    int32_t* st = stats + 5 * (int64_t)blockIdx.x;
    st[0] = s_chunks;
    st[1] = s_unmet;
    st[2] = s_rounds;
    st[3] = s_rewalked;
    st[4] = s_serial;
  }
}

static size_t rep_smem_bytes(int rows) {
  const int n = rows < REP_TILE ? rows : REP_TILE;
  return 2 * sizeof(int4) * REP_THREADS + sizeof(int) * (size_t)(rep_skew(n - 1) + 1);
}

extern "C" int tz_rep_codes(const void* packed, void* out, void* stats, int S, int rows,
                            cudaStream_t stream) {
  if (S <= 0 || rows <= 0) return (int)cudaErrorInvalidValue;
  const size_t smem = rep_smem_bytes(rows);
  cudaError_t err = cudaFuncSetAttribute(rep_codes_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  rep_codes_kernel<<<S, REP_THREADS, smem, stream>>>((const int32_t*)packed, (int32_t*)out,
                                                     (int32_t*)stats, rows);
  return (int)cudaGetLastError();
}
