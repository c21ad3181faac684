// K10: segment-local optimal parse, the BTOPT-style backward DP.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_opt.py `opt_steps`
// (`_opt_impl` / `_make_kernel`), with the per-row bank semantics of its CPU
// twin `_opt_scan`. For each segment row of `seg` positions, walking
// backward:
//
//   cost[p] = min( lit + cost[p+1],
//                  min_{l in [mm, ml_p]}  mc_p  + MLC[l] + cost[p+l],
//                  min_{l in [mm, ml2_p]} mc2_p + MLC[l] + cost[p+l] )
//
// with costs past the segment end 0. Input per position (int32):
// ml | ofc << 7 | ml2 << 12 | ofc2 << 19; mc = bank[ofc] + ofc * 16,
// MLC[l] = bank[32 + l - mm]. Lengths go in increasing order and only a
// strictly smaller cost replaces the best, so a literal or a shorter length
// wins a tie. Output: 1 for a literal, else the chosen length (int32).
//
// Design: one thread walks one segment row, 128 rows a CTA. Shared memory
// holds each row's 128-lane bank and its cost ring of cap + 2 slots (the
// ring is indexed by position, so it cannot live in registers), laid out
// lane-major so that the threads of a warp touch consecutive words. The
// packed input and the steps go through shared-memory tiles of 32 positions
// x 128 rows, so every global load and store is a warp reading or writing 32
// consecutive words of one row. Lengths stop at max(ml, ml2): past both the
// cost is BIG and never wins, so the work follows the data.
//
// Bound: operations. ~8 int32 operations per (position, length) that the
// data offers; each thread runs a dependent chain of seg steps, and 16384
// rows fill the card one CTA (4 warps) an SM deep, so latency, not the
// integer rate, sets the time of this simple version.
#include <cuda_runtime.h>
#include <stdint.h>

#define OPT_T 128      // rows (threads) a CTA
#define OPT_TP 32      // positions a tile
#define OPT_LANES 128  // bank lanes a row
#define OPT_SCALE 16
#define OPT_BIG (1 << 28)

__global__ void __launch_bounds__(OPT_T)
opt_steps_kernel(const int32_t* __restrict__ packed, const int32_t* __restrict__ lit_bits,
                 const int32_t* __restrict__ bank, int32_t* __restrict__ out, int64_t S,
                 int seg, int mm, int cap) {
  extern __shared__ int32_t smem[];
  const int ST = OPT_T + 1;  // padded stride of the cooperatively filled arrays
  const int R = cap + 2;
  int32_t* s_bank = smem;                        // [OPT_LANES][ST]
  int32_t* s_ring = s_bank + OPT_LANES * ST;     // [R][OPT_T]
  int32_t* s_in = s_ring + R * OPT_T;            // [OPT_TP][ST]
  int32_t* s_out = s_in + OPT_TP * ST;           // [OPT_TP][ST]

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * OPT_T;
  const int64_t row = row0 + tid;
  const bool live = row < S;

  for (int j = tid; j < OPT_LANES * OPT_T; j += OPT_T) {
    const int r = j / OPT_LANES, k = j % OPT_LANES;
    s_bank[k * ST + r] = (row0 + r < S) ? bank[(row0 + r) * OPT_LANES + k] : 0;
  }
  for (int q = 0; q < R; ++q) s_ring[q * OPT_T + tid] = 0;
  const int lit = live ? lit_bits[row] : 0;
  int base = (seg - 1) % R;  // ring slot of position p

  for (int t0 = ((seg - 1) / OPT_TP) * OPT_TP; t0 >= 0; t0 -= OPT_TP) {
    const int tn = min(OPT_TP, seg - t0);
    __syncthreads();  // s_bank filled; the previous tile stored
    for (int j = tid; j < OPT_TP * OPT_T; j += OPT_T) {
      const int r = j / OPT_TP, c = j % OPT_TP;
      s_in[c * ST + r] = (row0 + r < S && c < tn) ? packed[(row0 + r) * seg + t0 + c] : 0;
    }
    __syncthreads();
    if (live) {
      for (int c = tn - 1; c >= 0; --c) {
        const int x = s_in[c * ST + tid];
        const int ml = x & 127, ofc = (x >> 7) & 31;
        const int ml2 = (x >> 12) & 127, ofc2 = (x >> 19) & 15;
        const int mc = s_bank[ofc * ST + tid] + ofc * OPT_SCALE;
        const int mc2 = s_bank[ofc2 * ST + tid] + ofc2 * OPT_SCALE;
        int nx = base + 1;
        if (nx >= R) nx -= R;
        int best = lit + s_ring[nx * OPT_T + tid];
        int chosen = 1;
        const int lmax = min(cap, max(ml, ml2));
        for (int l = mm; l <= lmax; ++l) {
          int q = base + l;
          if (q >= R) q -= R;
          const int ahead = s_ring[q * OPT_T + tid] + s_bank[(32 + l - mm) * ST + tid];
          int cst = OPT_BIG;
          if (ml >= l) cst = mc + ahead;
          if (ml2 >= l) cst = min(cst, mc2 + ahead);
          if (cst < best) {
            best = cst;
            chosen = l;
          }
        }
        // Slot base held cost[p + R], which no later step reads.
        s_ring[base * OPT_T + tid] = best;
        s_out[c * ST + tid] = chosen;
        base = base == 0 ? R - 1 : base - 1;
      }
    }
    __syncthreads();
    for (int j = tid; j < OPT_TP * OPT_T; j += OPT_T) {
      const int r = j / OPT_TP, c = j % OPT_TP;
      if (row0 + r < S && c < tn) out[(row0 + r) * seg + t0 + c] = s_out[c * ST + r];
    }
  }
}

extern "C" int tz_opt_steps(const void* packed, const void* lit_bits, const void* bank,
                            void* out, int64_t S, int seg, int mm, int cap,
                            cudaStream_t stream) {
  const size_t smem =
      sizeof(int32_t) * ((size_t)OPT_LANES * (OPT_T + 1) + (size_t)(cap + 2) * OPT_T +
                         2 * (size_t)OPT_TP * (OPT_T + 1));
  cudaError_t err = cudaFuncSetAttribute(
      opt_steps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (S + OPT_T - 1) / OPT_T;
  opt_steps_kernel<<<(unsigned)blocks, OPT_T, smem, stream>>>(
      (const int32_t*)packed, (const int32_t*)lit_bits, (const int32_t*)bank, (int32_t*)out,
      S, seg, mm, cap);
  return (int)cudaGetLastError();
}
