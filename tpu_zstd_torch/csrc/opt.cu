// K10: segment-local optimal parse, the BTOPT-style backward DP.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_opt.py `opt_steps`
// (`_opt_impl` / `_make_kernel`), with the per-row bank semantics of its CPU
// twin `_opt_scan`. For each segment row of `seg` positions, walking
// backward:
//
//   cost[p] = min( lit + cost[p+1],
//                  min_{l in [mm, cap]} min(c1(l), c2(l)) )
//   c1(l) = ml_p  >= l ? mc_p  + MLC[l] + cost[p+l] : BIG
//   c2(l) = ml2_p >= l ? mc2_p + MLC[l] + cost[p+l] : BIG
//
// with costs past the segment end 0 and BIG = 1 << 28. Input per position
// (int32): ml | ofc << 7 | ml2 << 12 | ofc2 << 19; mc = bank[ofc] + ofc * 16,
// MLC[l] = bank[32 + l - mm]. The literal comes first and lengths go in
// increasing order; only a strictly smaller cost replaces the best, so a
// literal or a shorter length wins a tie. Sums are int32 and wrap (the adds
// are unsigned). Output: 1 for a literal, else the chosen length (int32).
//
// Design. A row is walked by a group of G = 4 lanes of one warp (8 rows a
// warp), lane j taking the lengths mm + j + 4k, so a step costs
// ceil((lmax - mm + 1) / 4) length iterations, lmax = min(cap, max(ml, ml2)),
// instead of lmax - mm + 1 in one thread; 16384 rows make 2048 warps, all
// resident on the 132 SMs. The lanes reduce by __shfl_xor_sync butterflies;
// then the literal; then, on the exact path, the one BIG candidate that the
// lengths past lmax give (the first of them, when BIG is strictly below the
// best so far).
// - Two paths, chosen once a warp. Where every live row's literal price and
//   bank entries lie in [0, 2^12) and seg <= 1024 (the encoder's prices are
//   far below), every cost stays below 2^22 and every candidate below 2^23:
//   nothing wraps, BIG never wins, and a candidate and its step pack into one
//   int32 key, cost << 7 | l (the literal's (lit + cost[p+1]) << 7 | 1),
//   whose least value is the first strict minimum; both bands cost
//   min(mc, mc2) + MLC + cost where both reach l. The fast path keeps
//   cost << 7 in the ring and MLC << 7 | l in registers, so a length is one
//   3-input add and a min, and the group reduces one key a round. Elsewhere
//   the exact path computes both candidates in wrapping int32 and reduces
//   (cost, length) pairs.
// - Staging. A warp owns its rows and never waits for another warp (no CTA
//   barrier). It stages tiles of 16 positions of them with cp.async (16
//   bytes a copy when seg is a multiple of 4 and the rows are 16-byte
//   aligned, else 4), the next tile in flight while it walks the current
//   one; turns each tile into one 16-byte record a position (fast: lmax,
//   min(mc, mc2) << 7, the longer band's mc << 7 and the two-band limit;
//   exact: the packed word, mc, mc2), so the 4 lanes of a row read one
//   broadcast record a step, prefetched a step ahead; and writes the steps
//   with 16-byte stores.
// - Each row's costs live in a ring of 128 slots written twice (slot s and
//   s + 128), rows 4 banks apart, so the 32 lanes' reads hit 32 banks and a
//   tile's reads and writes sit at fixed offsets from two bases: the fast
//   path walks a full tile fully unrolled, 4 lengths a lane loaded at once.
//
// - A build with -DOPT_FAST_PRICE=0 takes the exact path everywhere
//   (tools/torch_opt_bench.py times it beside the fast path). `stats`, where
//   given, gets 1 a row walked on the fast path, else 0.
//
// Bound: operations. The function needs 2 int32 operations per (position,
// length) that the data offers (a 3-input add and a min, with the band
// chosen once a position) and 12 per position (four fields, lmax, the
// two-band limit, the cheaper band's mc and the longer band's, the literal's
// add and its min; chip_smoke.py opt_bound_ms). The walk is a dependent
// chain a step (ring reads, the length iterations, two shuffle rounds, the
// ring write), and 16 warps an SM issue it: the time is the issue rate of
// their integer instructions, a step's fixed work (record, reduction,
// writes) repeated by the 4 lanes of a row.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define OPT_G 4               // lanes a row
#define OPT_RW (32 / OPT_G)   // rows a warp
#define OPT_BATCH 4           // lengths a lane loads at once
#define OPT_KMAX 24           // lengths a lane: cap - mm <= 95, so 96 / OPT_G
#define OPT_WARPS 4           // warps a CTA
#define OPT_TP 16             // positions a tile
#define OPT_TS (OPT_TP + 4)   // a tile row's stride in words
#define OPT_RS (4 * OPT_TP + 4)   // a record row's stride in words
#define OPT_RING (256 + OPT_G)    // a ring row's stride in words: rows 4 banks apart
#define OPT_OFS 36            // an mc table row's stride in words
// A warp's shared memory, in words: two input tiles (the current one then
// holds the steps), the records, the rings and the mc tables of its rows.
// Every part starts 16-byte aligned.
#define OPT_IN (2 * OPT_RW * OPT_TS)
#define OPT_REC (OPT_RW * OPT_RS)
#define OPT_RINGS (OPT_RW * OPT_RING)
#define OPT_WORDS (OPT_IN + OPT_REC + OPT_RINGS + OPT_RW * OPT_OFS)
#define OPT_SCALE 16
#define OPT_BIG (1 << 28)
#ifndef OPT_FAST_PRICE
#define OPT_FAST_PRICE (1 << 12)  // fast path: prices in [0, 2^12)
#endif
#define OPT_NONE 255          // the length of "no length" on the exact path

static __device__ __forceinline__ void opt_cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
static __device__ __forceinline__ void opt_cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// Stages tile t (positions [16 t, 16 t + 16) of the warp's rows) into
// buffer t & 1 with cp.async.
static __device__ __forceinline__ void opt_stage(int t, int32_t* s_in,
                                                 const int32_t* __restrict__ packed,
                                                 int64_t row0, int nrows, int seg, int vec,
                                                 int lane) {
  if (t < 0) return;
  int32_t* dst = s_in + (t & 1) * OPT_RW * OPT_TS;
  const int t0 = t * OPT_TP, tn = min(OPT_TP, seg - t0);
  if (vec) {
    for (int i = lane; i < OPT_RW * (OPT_TP / 4); i += 32) {
      const int rr = i / (OPT_TP / 4), q = (i % (OPT_TP / 4)) * 4;
      if (rr < nrows && q < tn)
        opt_cp_async16(dst + rr * OPT_TS + q, packed + (row0 + rr) * seg + t0 + q);
    }
  } else {
    for (int i = lane; i < OPT_RW * OPT_TP; i += 32) {
      const int rr = i / OPT_TP, q = i % OPT_TP;
      if (rr < nrows && q < tn)
        opt_cp_async4(dst + rr * OPT_TS + q, packed + (row0 + rr) * seg + t0 + q);
    }
  }
  asm volatile("cp.async.commit_group;\n");
}

// One step of the fast path for position p: the lane's lengths against the
// ring (cost[p + l] << 7 at rb[l - lbj]), the key reduced over the group,
// then cost[p] << 7 written to both ring slots (wb) and the step to xo.
// Returns cost[p] << 7. Loads past lmax are skipped: rb[l - lbj] lies in the
// ring's 256 slots only for l <= cap.
static __device__ __forceinline__ unsigned opt_fast_step(const int4 rc, const int32_t* rb,
                                                         const int (&mlck)[OPT_KMAX], int key,
                                                         int lbj, int32_t* wb, int32_t* xo) {
  const int dall = rc.x - lbj, dboth = rc.w - lbj;
#pragma unroll
  for (int k0 = 0; k0 < OPT_KMAX; k0 += OPT_BATCH) {
    if (k0 * OPT_G > dall) break;
    int v[OPT_BATCH];
#pragma unroll
    for (int u = 0; u < OPT_BATCH; ++u) {
      const int d = (k0 + u) * OPT_G;
      v[u] = d <= dall ? rb[d] : 0;
    }
#pragma unroll
    for (int u = 0; u < OPT_BATCH; ++u) {
      const int d = (k0 + u) * OPT_G;
      if (d <= dall) key = min(key, v[u] + mlck[k0 + u] + (d <= dboth ? rc.y : rc.z));
    }
  }
#pragma unroll
  for (int o = OPT_G / 2; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(0xffffffffu, key, o));
  const int best = key & ~127;
  wb[0] = best;  // slot p & 127 held cost[p + 128], which no later step reads
  wb[128] = best;
  *xo = key & 127;
  __syncwarp();
  return (unsigned)best;
}

// One step of the exact path for position p (ring slot p7): returns cost[p]
// and writes the step to xo.
static __device__ __forceinline__ unsigned opt_exact_step(const int4 rc, int32_t* ring, int p7,
                                                          const int32_t* mlc_g, unsigned lit,
                                                          unsigned prev, int lbj, int mm,
                                                          int cap, int32_t* xo) {
  const int32_t* base = ring + ((p7 + lbj) & 127);  // cost[p + l] at l - lbj
  const int x = rc.x, ml = x & 127, ml2 = (x >> 12) & 127;
  const unsigned mc = (unsigned)rc.y, mc2 = (unsigned)rc.z;
  const int lmax = min(cap, max(ml, ml2));
  int lc = INT_MAX, ll = OPT_NONE;
#pragma unroll
  for (int k0 = 0; k0 < OPT_KMAX; k0 += OPT_BATCH) {
    if (lbj + k0 * OPT_G > lmax) break;
    int v[OPT_BATCH];
#pragma unroll
    for (int u = 0; u < OPT_BATCH; ++u) v[u] = base[(k0 + u) * OPT_G];
#pragma unroll
    for (int u = 0; u < OPT_BATCH; ++u) {
      const int l = lbj + (k0 + u) * OPT_G;
      if (l <= lmax) {
        const unsigned ahead = (unsigned)v[u] + (unsigned)__ldg(mlc_g + (k0 + u) * OPT_G);
        const int cst = min(ml >= l ? (int)(mc + ahead) : OPT_BIG,
                            ml2 >= l ? (int)(mc2 + ahead) : OPT_BIG);
        if (cst < lc) {
          lc = cst;
          ll = l;
        }
      }
    }
  }
#pragma unroll
  for (int o = OPT_G / 2; o > 0; o >>= 1) {
    const int oc = __shfl_xor_sync(0xffffffffu, lc, o);
    const int ol = __shfl_xor_sync(0xffffffffu, ll, o);
    if (oc < lc || (oc == lc && ol < ll)) {
      lc = oc;
      ll = ol;
    }
  }
  int best = (int)(lit + prev), chosen = 1;
  if (lc < best) {
    best = lc;
    chosen = ll;
  }
  // Lengths past lmax cost BIG; the first of them is the only one that can
  // win.
  if (lmax < cap && OPT_BIG < best) {
    best = OPT_BIG;
    chosen = max(lmax + 1, mm);
  }
  ring[p7] = best;  // slot p7 held cost[p + 128], which no later step reads
  ring[p7 + 128] = best;
  *xo = chosen;
  __syncwarp();
  return (unsigned)best;
}

// One warp's walk over its rows, tile by tile, on the fast (FAST) or the
// exact path. Fast: the ring holds cost << 7 and a candidate is the key
// cost << 7 | l, the literal's (lit + cost[p+1]) << 7 | 1, so the least key
// is the first strict minimum (a tie keeps the literal or the shorter
// length; a literal and a length of 1 both give step 1) and its low bits are
// the step.
template <bool FAST>
static __device__ __forceinline__ void opt_walk(
    const int32_t* __restrict__ packed, int32_t* __restrict__ out, const int32_t* mlc_g,
    const int (&mlck)[OPT_KMAX], unsigned lit, int32_t* s_in, int32_t* s_rec, int32_t* ring,
    const int32_t* s_ofb, int64_t row0, int nrows, int seg, int mm, int cap, int vec,
    int lane) {
  const int r = lane / OPT_G, lbj = mm + lane % OPT_G;  // the lane's row and first length
  const int ntiles = (seg + OPT_TP - 1) / OPT_TP;
  opt_stage(ntiles - 1, s_in, packed, row0, nrows, seg, vec, lane);
  unsigned prev = 0;  // cost[p + 1] (fast: << 7)
  const unsigned lit7 = lit << 7 | 1;
  for (int t = ntiles - 1; t >= 0; --t) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();  // tile t (and the tables) visible to the warp; tile t + 1 stored
    opt_stage(t - 1, s_in, packed, row0, nrows, seg, vec, lane);
    const int t0 = t * OPT_TP, tn = min(OPT_TP, seg - t0);
    int32_t* tile = s_in + (t & 1) * OPT_RW * OPT_TS;
    // One record a (row, position) of the tile; rows past S hold garbage
    // that is walked and never stored.
    for (int i = lane; i < OPT_RW * OPT_TP; i += 32) {
      const int rr = i / OPT_TP, q = i % OPT_TP;
      const int x = tile[rr * OPT_TS + q];
      const int ml = x & 127, ml2 = (x >> 12) & 127;
      const int mc = s_ofb[rr * OPT_OFS + ((x >> 7) & 31)];
      const int mc2 = s_ofb[rr * OPT_OFS + ((x >> 19) & 15)];
      *reinterpret_cast<int4*>(s_rec + rr * OPT_RS + 4 * q) =
          FAST ? make_int4(min(cap, max(ml, ml2)), min(mc, mc2) << 7,
                           (ml >= ml2 ? mc : mc2) << 7, min(cap, min(ml, ml2)))
               : make_int4(x, mc, mc2, 0);
    }
    __syncwarp();
    const int4* recs = reinterpret_cast<const int4*>(s_rec + r * OPT_RS);
    int32_t* xout = tile + r * OPT_TS;  // the tile's input is consumed: steps go here
    if (FAST) {
      // A tile's positions share p & ~15, so p & 127 = (t0 & 127) + c: the
      // ring is read and written at fixed offsets from two bases a tile.
      const int32_t* rb = ring + (t0 & 127) + lbj;
      int32_t* wb = ring + (t0 & 127);
      int4 nrec = recs[tn - 1];
      if (tn == OPT_TP) {
#pragma unroll
        for (int c = OPT_TP - 1; c >= 0; --c) {
          const int4 rc = nrec;
          if (c > 0) nrec = recs[c - 1];
          prev = opt_fast_step(rc, rb + c, mlck, (int)(lit7 + prev), lbj, wb + c, xout + c);
        }
      } else {
        for (int c = tn - 1; c >= 0; --c) {
          const int4 rc = nrec;
          if (c > 0) nrec = recs[c - 1];
          prev = opt_fast_step(rc, rb + c, mlck, (int)(lit7 + prev), lbj, wb + c, xout + c);
        }
      }
    } else {
      for (int c = tn - 1; c >= 0; --c)
        prev = opt_exact_step(recs[c], ring, (t0 + c) & 127, mlc_g, lit, prev, lbj, mm, cap,
                              xout + c);
    }
    if (vec) {
      for (int i = lane; i < OPT_RW * (OPT_TP / 4); i += 32) {
        const int rr = i / (OPT_TP / 4), q = (i % (OPT_TP / 4)) * 4;
        if (rr < nrows && q < tn)
          *reinterpret_cast<int4*>(out + (row0 + rr) * seg + t0 + q) =
              *reinterpret_cast<const int4*>(tile + rr * OPT_TS + q);
      }
    } else {
      for (int i = lane; i < OPT_RW * OPT_TP; i += 32) {
        const int rr = i / OPT_TP, q = i % OPT_TP;
        if (rr < nrows && q < tn) out[(row0 + rr) * seg + t0 + q] = tile[rr * OPT_TS + q];
      }
    }
  }
}

__global__ void __launch_bounds__(OPT_WARPS * 32)
opt_steps_kernel(const int32_t* __restrict__ packed, const int32_t* __restrict__ lit_bits,
                 const int32_t* __restrict__ bank, int32_t* __restrict__ out,
                 int32_t* __restrict__ stats, int64_t S, int seg, int mm, int cap, int vec) {
  extern __shared__ __align__(16) int32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane / OPT_G, j = lane % OPT_G;
  const int64_t row0 = ((int64_t)blockIdx.x * OPT_WARPS + warp) * OPT_RW;
  if (row0 >= S) return;
  const int nrows = (int)min((int64_t)OPT_RW, S - row0);
  const bool live = r < nrows;
  const int64_t row = row0 + r;
  int32_t* s_in = smem + warp * OPT_WORDS;
  int32_t* s_rec = s_in + OPT_IN;
  int32_t* s_ring = s_rec + OPT_REC;
  int32_t* s_ofb = s_ring + OPT_RINGS;

  // Per-row tables and the path: mc per offset code, zeroed rings, MLC per
  // lane, the literal price.
  bool fast = seg <= 1024;
  for (int i = lane; i < OPT_RW * 32; i += 32) {
    const int rr = i >> 5, o = i & 31;
    const int b = rr < nrows ? bank[(row0 + rr) * 128 + o] : 0;
    fast &= b >= 0 && b < OPT_FAST_PRICE;
    s_ofb[rr * OPT_OFS + o] = (int)((unsigned)b + o * OPT_SCALE);
  }
  for (int i = lane; i < OPT_RINGS; i += 32) s_ring[i] = 0;
  const unsigned lit = live ? (unsigned)lit_bits[row] : 0u;
  fast &= !live || lit < (unsigned)OPT_FAST_PRICE;
  int mlck[OPT_KMAX];  // fast: MLC << 7 | l
#pragma unroll
  for (int k = 0; k < OPT_KMAX; ++k) {
    const int d = j + k * OPT_G;  // l - mm
    const int m = (live && d <= cap - mm) ? bank[row * 128 + 32 + d] : 0;
    fast &= m >= 0 && m < OPT_FAST_PRICE;
    mlck[k] = m << 7 | (mm + d);
  }
  // Exact path: MLC[mm + j + 4k] at 4k (rows past S read row0's).
  const int32_t* mlc_g = bank + (live ? row : row0) * 128 + 32 + j;
  int32_t* ring = s_ring + r * OPT_RING;
  fast = __all_sync(0xffffffffu, fast);
  if (stats != nullptr && live && j == 0) stats[row] = fast;
  if (fast)
    opt_walk<true>(packed, out, mlc_g, mlck, lit, s_in, s_rec, ring, s_ofb, row0, nrows, seg,
                   mm, cap, vec, lane);
  else
    opt_walk<false>(packed, out, mlc_g, mlck, lit, s_in, s_rec, ring, s_ofb, row0, nrows, seg,
                    mm, cap, vec, lane);
}

extern "C" int tz_opt_steps(const void* packed, const void* lit_bits, const void* bank,
                            void* out, void* stats, int64_t S, int seg, int mm, int cap,
                            cudaStream_t stream) {
  const size_t smem = sizeof(int32_t) * OPT_WARPS * OPT_WORDS;
  cudaError_t err = cudaFuncSetAttribute(
      opt_steps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec = seg % 4 == 0 && (uintptr_t)packed % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int64_t rows = (int64_t)OPT_WARPS * OPT_RW;
  opt_steps_kernel<<<(unsigned)((S + rows - 1) / rows), OPT_WARPS * 32, smem, stream>>>(
      (const int32_t*)packed, (const int32_t*)lit_bits, (const int32_t*)bank, (int32_t*)out,
      (int32_t*)stats, S, seg, mm, cap, vec);
  return (int)cudaGetLastError();
}
