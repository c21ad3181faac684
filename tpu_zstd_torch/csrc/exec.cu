// K8 / K9: sequence execution (RFC 8878 §3.1.1.4), parallel inside a block.
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
// Bound: bytes (literals and sequences read once, output written once). The
// TPU kernel walks the sequences one by one; on the card that walk costs a
// CTA barrier or two per sequence, ~300 ns, against ~0.05 ns of bytes. This
// kernel walks no sequence list in order. One CTA of 1024 threads per block:
//   - positions by a scan: exclusive prefix sums of ll + ml (output start)
//     and of ll (literal start) over the block's sequences, 8192 sequences a
//     pass, give each sequence's output, literal and match start, written to
//     a table in device scratch (16 bytes a sequence, the wrapper's
//     `torch.empty`); a last entry holds the tail literals;
//   - the output in tiles of 8192 bytes, in order, the block's bytes so far
//     in shared memory. Each tile marks where its sequences start and fills
//     every byte's sequence by a CTA-wide max-scan; every byte then gets its
//     value at once when it is a literal (read from the front-compacted
//     literals or from K6's stream rows) or a match byte whose source lies
//     before the tile (window or shared memory), else the in-tile position
//     it copies. A match byte's source is one hop per match:
//     mstart - off + (j - mstart) % off, which lies before the match, so an
//     overlapping match (off < ml) resolves in one hop. Pointers left inside
//     the tile resolve by pointer doubling in shared memory (ptr = ent[ptr],
//     in place), rounds separated by `__syncthreads_or` until none is left:
//     log2 of the tile's chain depth rounds, not one barrier a sequence;
//   - each tile's bytes go to shared memory and to the output, coalesced.
// Clamps: the scans saturate (output positions at N, literal positions at
// 2^30), each offset is clamped to [1, W + match start], literal reads to
// their buffer, and a source before the window reads 0: a corrupt sequence
// list gives garbage, never an access out of bounds. On valid lists out_len
// is the bytes produced (nlit + sum of ml); bytes past it are left unwritten.
// Literals come front-compacted (B, L) or straight from K6's stream rows:
// position p is row 4b + min(p / seg, 3), column p - s * seg,
// seg = ceil(regen / 4). Blocks whose output does not fit in shared memory
// beside the tile arrays keep their bytes in the output instead.
// Optional stats (3 int32 per block): tiles, doubling rounds summed over the
// tiles, the most rounds of one tile.
#include <cuda_runtime.h>
#include <stdint.h>

#define EXEC_THREADS 1024
#define EXEC_TILE 8192  // EXEC_THREADS * 8: the max-scan gives 8 bytes a thread
#define EXEC_SEQ_PER_THREAD 8
#define EXEC_LIT_CAP (1 << 30)
#define EXEC_SMEM_MAX 232448
#define EXEC_TILE_SMEM (EXEC_TILE * (int)(sizeof(int) + sizeof(int16_t)))

__device__ __forceinline__ int sat_add(int a, int b, int cap) { return min(a + b, cap); }

// CTA-wide scan of two saturating sums (min(a + b, cap) is associative on
// values >= 0): the exclusive prefixes through ea / el, the CTA totals
// through ta / tl.
__device__ __forceinline__ void scan2(int a, int l, int cap_a, int cap_l, int* s_a, int* s_l,
                                      int& ea, int& el, int& ta, int& tl) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, il = l;
  for (int d = 1; d < 32; d <<= 1) {
    const int xa = __shfl_up_sync(0xffffffffu, ia, d);
    const int xl = __shfl_up_sync(0xffffffffu, il, d);
    if (lane >= d) {
      ia = sat_add(ia, xa, cap_a);
      il = sat_add(il, xl, cap_l);
    }
  }
  if (lane == 31) {
    s_a[warp] = ia;
    s_l[warp] = il;
  }
  __syncthreads();
  if (warp == 0) {
    int wa = s_a[lane], wl = s_l[lane];
    for (int d = 1; d < 32; d <<= 1) {
      const int xa = __shfl_up_sync(0xffffffffu, wa, d);
      const int xl = __shfl_up_sync(0xffffffffu, wl, d);
      if (lane >= d) {
        wa = sat_add(wa, xa, cap_a);
        wl = sat_add(wl, xl, cap_l);
      }
    }
    s_a[lane] = wa;  // inclusive over warps
    s_l[lane] = wl;
  }
  __syncthreads();
  const int pa = warp ? s_a[warp - 1] : 0, pl = warp ? s_l[warp - 1] : 0;
  // Exclusive within the warp: the inclusive value of the lane before.
  const int xa = __shfl_up_sync(0xffffffffu, ia, 1);
  const int xl = __shfl_up_sync(0xffffffffu, il, 1);
  ea = sat_add(pa, lane ? xa : 0, cap_a);
  el = sat_add(pl, lane ? xl : 0, cap_l);
  ta = s_a[31];
  tl = s_l[31];
  __syncthreads();  // s_a / s_l are reused by the next scan
}

__global__ void __launch_bounds__(EXEC_THREADS, 1)
exec_sequences_kernel(const uint8_t* __restrict__ lits, const uint8_t* __restrict__ syms,
                      const int32_t* __restrict__ regen, const int32_t* __restrict__ nlit_a,
                      const int32_t* __restrict__ ll_a, const int32_t* __restrict__ ml_a,
                      const int32_t* __restrict__ off_a, const int32_t* __restrict__ nseq_a,
                      const uint8_t* __restrict__ window, uint8_t* out,
                      int32_t* __restrict__ out_len, int4* tbl_all, int32_t* __restrict__ stats,
                      int L, int SEGC, int MS, int W, int N, int buf_in_smem) {
  extern __shared__ int4 exec_smem[];
  int* seg_of = reinterpret_cast<int*>(exec_smem);                  // EXEC_TILE
  int16_t* ent = reinterpret_cast<int16_t*>(seg_of + EXEC_TILE);     // EXEC_TILE
  uint8_t* sbuf = reinterpret_cast<uint8_t*>(ent + EXEC_TILE);       // N when in smem
  __shared__ int s_a[32], s_l[32];
  __shared__ int s_len;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  uint8_t* o = out + (int64_t)b * N;
  uint8_t* buf = buf_in_smem ? sbuf : o;  // the block's bytes so far
  const uint8_t* win = window + (int64_t)b * W;
  int4* tbl = tbl_all + (int64_t)b * (MS + 1);
  const int nseq = max(min(nseq_a[b], MS), 0);
  int seg = 1;
  int nl;
  const uint8_t* lrow = nullptr;
  const uint8_t* srow = nullptr;
  if (syms != nullptr) {
    nl = max(min(nlit_a[b], 4 * SEGC), 0);
    seg = max((regen[b] + 3) >> 2, 1);
    srow = syms + (int64_t)b * 4 * SEGC;
  } else {
    nl = max(min(nlit_a[b], L), 0);
    lrow = lits + (int64_t)b * L;
  }
  auto lit = [&](int p) -> uint8_t {
    if (srow == nullptr) return lrow[min(p, L - 1)];
    const int s = min(p / seg, 3);
    return srow[(int64_t)s * SEGC + min(p - s * seg, SEGC - 1)];
  };

  // --- positions by a scan: the sequence table ---------------------------------------
  int carry_o = 0, carry_l = 0;
  for (int s0 = 0; s0 < nseq; s0 += EXEC_THREADS * EXEC_SEQ_PER_THREAD) {
    const int base = s0 + tid * EXEC_SEQ_PER_THREAD;
    int llv[EXEC_SEQ_PER_THREAD], adv[EXEC_SEQ_PER_THREAD], ofv[EXEC_SEQ_PER_THREAD];
    int ta = 0, tl = 0;
#pragma unroll
    for (int i = 0; i < EXEC_SEQ_PER_THREAD; ++i) {
      const int s = base + i;
      int l = 0, m = 0, f = 1;
      if (s < nseq) {
        const int64_t k = (int64_t)b * MS + s;
        l = min(max(ll_a[k], 0), N);
        m = min(max(ml_a[k], 0), N);
        f = off_a[k];
      }
      llv[i] = l;
      adv[i] = l + m;
      ofv[i] = f;
      ta = sat_add(ta, l + m, N);
      tl = sat_add(tl, l, EXEC_LIT_CAP);
    }
    int ea, el, tot_a, tot_l;
    scan2(ta, tl, N, EXEC_LIT_CAP, s_a, s_l, ea, el, tot_a, tot_l);
    int pos = sat_add(carry_o, ea, N), lp = sat_add(carry_l, el, EXEC_LIT_CAP);
#pragma unroll
    for (int i = 0; i < EXEC_SEQ_PER_THREAD; ++i) {
      const int s = base + i;
      if (s < nseq) {
        const int ms = min(pos + llv[i], N);
        const int of = min(max(ofv[i], 1), max(W + ms, 1));
        tbl[s] = make_int4(pos, ms, lp, of);
      }
      pos = sat_add(pos, adv[i], N);
      lp = sat_add(lp, llv[i], EXEC_LIT_CAP);
    }
    carry_o = sat_add(carry_o, tot_a, N);
    carry_l = sat_add(carry_l, tot_l, EXEC_LIT_CAP);
  }
  if (tid == 0) {  // the tail literals: an entry with no match
    const int end = min(carry_o + max(nl - carry_l, 0), N);
    tbl[nseq] = make_int4(carry_o, end, carry_l, 1);
    s_len = end;
  }
  __syncthreads();  // the table is visible to the whole CTA
  const int olen = s_len;

  // --- the output in tiles ------------------------------------------------------------
  int slo = 0;  // the sequence covering the tile's first byte, or one before it
  int rounds_sum = 0, rounds_max = 0, tiles = 0;
  for (int t0 = 0; t0 < olen; t0 += EXEC_TILE) {
    const int t1 = min(t0 + EXEC_TILE, olen);
    const int len = t1 - t0;
    for (int k = tid; k < EXEC_TILE; k += EXEC_THREADS) seg_of[k] = -1;
    __syncthreads();
    // Mark where the tile's sequences start (the one covering t0 at 0).
    for (int sb = slo;; sb += EXEC_THREADS) {
      const int s = sb + tid;
      bool more = false;
      if (s <= nseq) {
        const int os = tbl[s].x;
        const int oe = s < nseq ? tbl[s + 1].x : olen;
        if (oe > os && os < t1 && oe > t0) seg_of[max(os, t0) - t0] = s;
        more = s < nseq && oe < t1;
      }
      if (!__syncthreads_or(tid == EXEC_THREADS - 1 && more)) break;
    }
    // Every byte's sequence: an inclusive max-scan, 8 bytes a thread.
    {
      int4* q = reinterpret_cast<int4*>(seg_of + tid * 8);
      int4 u = q[0], v = q[1];
      u.y = max(u.y, u.x);
      u.z = max(u.z, u.y);
      u.w = max(u.w, u.z);
      v.x = max(v.x, u.w);
      v.y = max(v.y, v.x);
      v.z = max(v.z, v.y);
      v.w = max(v.w, v.z);
      int inc = v.w;
      for (int d = 1; d < 32; d <<= 1) {
        const int x = __shfl_up_sync(0xffffffffu, inc, d);
        if (lane >= d) inc = max(inc, x);
      }
      if (lane == 31) s_a[warp] = inc;
      __syncthreads();
      if (warp == 0) {
        int w = s_a[lane];
        for (int d = 1; d < 32; d <<= 1) {
          const int x = __shfl_up_sync(0xffffffffu, w, d);
          if (lane >= d) w = max(w, x);
        }
        s_a[lane] = w;
      }
      __syncthreads();
      int pre = __shfl_up_sync(0xffffffffu, inc, 1);
      if (lane == 0) pre = -1;
      if (warp) pre = max(pre, s_a[warp - 1]);
      u.x = max(u.x, pre);
      u.y = max(u.y, pre);
      u.z = max(u.z, pre);
      u.w = max(u.w, pre);
      v.x = max(v.x, pre);
      v.y = max(v.y, pre);
      v.z = max(v.z, pre);
      v.w = max(v.w, pre);
      q[0] = u;
      q[1] = v;
    }
    __syncthreads();
    // Each byte: its value, or the in-tile position it copies.
    bool ptr = false;
    for (int k = tid; k < len; k += EXEC_THREADS) {
      const int j = t0 + k;
      const int4 e = tbl[seg_of[k]];
      int v;
      if (j < e.y) {
        v = -1 - (int)lit(e.z + (j - e.x));
      } else {
        const int of = e.w, d = j - e.y;
        const int p = d < of ? j - of : e.y - of + d % of;
        if (p >= t0) {
          v = p - t0;
          ptr = true;
        } else {
          v = -1 - (int)(p >= 0 ? buf[p] : p >= -W ? win[W + p] : 0);
        }
      }
      ent[k] = (int16_t)v;
    }
    int rounds = 0;
    bool left = __syncthreads_or(ptr);
    while (left) {  // pointer doubling inside the tile
      bool still = false;
      for (int k = tid; k < len; k += EXEC_THREADS) {
        int v = ent[k];
        if (v >= 0) {
          v = ent[v];
          ent[k] = (int16_t)v;
          still |= v >= 0;
        }
      }
      ++rounds;
      left = __syncthreads_or(still);
    }
    for (int k = tid; k < len; k += EXEC_THREADS) {
      const uint8_t v = (uint8_t)(-1 - ent[k]);
      if (buf_in_smem) buf[t0 + k] = v;
      o[t0 + k] = v;
    }
    slo = seg_of[len - 1];
    rounds_sum += rounds;
    rounds_max = max(rounds_max, rounds);
    ++tiles;
    __syncthreads();  // the tile's bytes are visible; seg_of and ent are free
  }
  if (tid == 0) {
    out_len[b] = olen;
    if (stats != nullptr) {
      stats[3 * b] = tiles;
      stats[3 * b + 1] = rounds_sum;
      stats[3 * b + 2] = rounds_max;
    }
  }
}

extern "C" int tz_exec_sequences(const void* lits, const void* syms, const void* regen,
                                 const void* nlit, const void* ll, const void* ml,
                                 const void* off, const void* nseq, const void* window,
                                 void* out, void* out_len, void* tbl, void* stats, int B, int L,
                                 int SEGC, int MS, int W, int N, cudaStream_t stream) {
  if (B <= 0 || N <= 0 || MS <= 0 || W < 0 || N > (1 << 30) - 1 ||
      (syms == nullptr && L <= 0) || (syms != nullptr && SEGC <= 0))
    return (int)cudaErrorInvalidValue;
  const int static_smem = 2 * 32 * (int)sizeof(int) + 64;
  const size_t buf_bytes = ((size_t)N + 15) & ~(size_t)15;
  const int in_smem = EXEC_TILE_SMEM + buf_bytes + static_smem <= EXEC_SMEM_MAX;
  const size_t smem = EXEC_TILE_SMEM + (in_smem ? buf_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(exec_sequences_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  exec_sequences_kernel<<<B, EXEC_THREADS, smem, stream>>>(
      (const uint8_t*)lits, (const uint8_t*)syms, (const int32_t*)regen, (const int32_t*)nlit,
      (const int32_t*)ll, (const int32_t*)ml, (const int32_t*)off, (const int32_t*)nseq,
      (const uint8_t*)window, (uint8_t*)out, (int32_t*)out_len, (int4*)tbl, (int32_t*)stats, L,
      SEGC, MS, W, N, in_smem);
  return (int)cudaGetLastError();
}
