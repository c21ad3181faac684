// K2: per-block variable-length segment concatenation, several operands a
// launch.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_concat.py
// `concat_varlen` (`_batched` / `_kern`). For block b, segment w of an
// operand is src[b, w, off[b, w] : off[b, w] + cnt[b, w]]; segments land in
// window order at exclusive-prefix offsets in out[b, :out_len]. As in the
// TPU kernel each count is clamped at what is left of out_len, so segment w
// covers out[P[w] : P[w + 1]], P the row's inclusive prefix of the counts
// clamped at out_len (P[0] = 0), and the rest of the row is zero.
//
// The TPU kernel walks the windows in order inside one grid step (a rotate
// plus a masked read-modify-write a window), one call an operand. The parse
// (ops/lz77.py) joins three operands of one batch: the literal bytes, the
// sequence starts and the packed (ml, off) words, each cast around the
// int32 kernel. Here one launch takes every operand as a descriptor passed
// by value (source, its strides and type, offsets, counts, destination and
// its type), and CONCAT_PARTS CTAs a (block row, operand):
//   - warp 0 scans the row's counts with warp shuffles into P and copies
//     the offsets into shared memory (each lane loads its windows' counts
//     at once, then one shuffle scan of the lanes' sums);
//   - the output row is cut into 16-byte units aligned on the destination
//     (a head and a tail of single elements where the row does not start
//     or end on 16 bytes), and the units into groups of 512 elements, the
//     CTA's part of them taken by its warps in turn. A warp finds its
//     group's first window by a binary search of P; in each of 16 rounds
//     its lanes read the source of 32 consecutive elements (coalesced; all
//     16 loads in flight before any is used), into a stage in shared
//     memory, from which each lane stores 16-byte units. A group past the
//     row's total is zeros, so the kernel writes every byte of the output
//     and no memset precedes it;
//   - each value is the low 32 bits of the source element, plus w << shift
//     where the operand asks for its window's base, as the int32 TPU kernel
//     computes on `x.to(torch.int32)`; it is stored as the destination type
//     takes it from int32: its low byte (uint8), itself (int32) or
//     sign-extended (int64).
// Bound: bytes (each live source element read once, each output byte
// written once). What sets the time is latency: a group costs a round trip
// to device memory (a launch for one row of 14774 literals takes ~0.012 ms,
// PERF.md), so every warp keeps 16 loads in flight and a row is split over
// CONCAT_PARTS CTAs (a block of all literals reads 1 MB: alone on one SM it
// set the time of the whole launch).
// Inputs outside the contract (src_off < 0 or past the window, counts < 0)
// are clamped so that no read leaves the window; elements past the window's
// width read as zero, as the plain version leaves them.
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// Threads and CTAs a (row, operand); a build may set them
// (tools/torch_concat_bench.py --sweep times other values).
#ifndef CONCAT_THREADS
#define CONCAT_THREADS 256
#endif
#ifndef CONCAT_PARTS
#define CONCAT_PARTS 8
#endif
#define CONCAT_MAX_OPS 4
#define CONCAT_MAX_NW 1024
#define CONCAT_ROUNDS 16                  // elements a lane a group
#define CONCAT_STAGE (32 * CONCAT_ROUNDS * 8)  // stage bytes a warp
#define CONCAT_SCAN_CHUNK 4               // counts a lane loads at once

// Flags of a descriptor.
#define CF_SRC64 1      // source elements are int64 (else int32)
#define CF_OFF64 2      // offsets are int64 (else int32)
#define CF_CNT64 4      // counts are int64 (else int32)
#define CF_DST_SHIFT 4  // bits 4-5: destination 0 uint8, 1 int32, 2 int64

// One operand, as the wrapper packs it: ten int64 fields.
struct ConcatOp {
  int64_t src;        // device pointer: (B, NW, >= width), unit stride in the last dim
  int64_t src_bs;     // source elements between block rows
  int64_t src_ws;     // source elements between windows
  int64_t width;      // elements of a window that may be read
  int64_t off;        // device pointer (B, NW), or 0: every offset 0
  int64_t cnt;        // device pointer (B, NW)
  int64_t dst;        // device pointer (B, out_len)
  int64_t out_len;
  int64_t flags;
  int64_t win_shift;  // >= 0: window w's values get w << win_shift added
};

struct ConcatArgs {
  ConcatOp op[CONCAT_MAX_OPS];
};

__device__ __forceinline__ int64_t imin64(int64_t a, int64_t b) { return a < b ? a : b; }
__device__ __forceinline__ int64_t imax64(int64_t a, int64_t b) { return a > b ? a : b; }

__device__ __forceinline__ int64_t load_index(int64_t p, bool is64, int64_t i) {
  return is64 ? reinterpret_cast<const int64_t*>(p)[i]
              : (int64_t)reinterpret_cast<const int32_t*>(p)[i];
}

// The window whose segment holds output element j: the last w with
// P[w] <= j, given P[0] = 0 <= j < P[NW].
__device__ __forceinline__ int find_window(const int32_t* P, int NW, int j) {
  int lo = 0, hi = NW;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (P[mid] <= j)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// One destination element: the int32 value as an ES-byte type holds it.
template <int ES>
__device__ __forceinline__ void store_one(char* p, uint32_t v) {
  if constexpr (ES == 1)
    *reinterpret_cast<uint8_t*>(p) = (uint8_t)v;
  else if constexpr (ES == 4)
    *reinterpret_cast<uint32_t*>(p) = v;
  else
    *reinterpret_cast<int64_t*>(p) = (int64_t)(int32_t)v;
}

// One row of one operand: ES bytes a destination element, SW 32-bit words a
// source element. A warp takes a group of 512 elements at a time: in round r
// its lanes read the source of elements r * 32 + lane (consecutive lanes,
// consecutive elements), into the warp's stage in shared memory; then each
// lane stores ES of the group's 16-byte units. Groups past the row's total
// are zeros.
template <int ES, int SW>
__device__ void concat_row(const ConcatOp& op, const int32_t* P, const int32_t* OFF, int NW,
                           int64_t b, char* stage) {
  constexpr int E = 16 / ES;  // elements a unit
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int out_len = (int)op.out_len;
  const int total = P[NW];
  const int64_t width = op.width, ws = op.src_ws * SW;
  const int shift = (int)op.win_shift;  // < 0: no window base
  const uint32_t* srow = reinterpret_cast<const uint32_t*>(op.src) + b * op.src_bs * SW;
  char* dst = reinterpret_cast<char*>(op.dst) + b * (int64_t)out_len * ES;
  const int head = min((int)(((16 - ((uintptr_t)dst & 15)) & 15) / ES), out_len);
  const int units = (out_len - head) / E;
  const int live = total > head ? min(units, (total - head + E - 1) / E) : 0;
  auto base = [shift](int w) { return shift >= 0 ? (uint32_t)((uint64_t)w << shift) : 0u; };
  // Element j's value, its window found from w on (w, the window's first
  // element p0 and end p1 carried from call to call, j never decreasing).
  auto value = [&](int j, int& w, int& p0, int& p1) -> uint32_t {
    if (j >= total) return 0u;
    while (j >= p1) {
      p0 = p1;
      p1 = P[++w + 1];
    }
    const int64_t s = (int64_t)OFF[w] + (j - p0);
    return s < width ? __ldg(srow + w * ws + s * SW) + base(w) : 0u;
  };
  // A group is 512 elements (16 rounds of 32, every lane one a round):
  // 32 * ES units, ES of them a lane. This CTA takes part blockIdx.z of
  // gridDim.z of the row's groups; the groups past the live ones are zeros.
  constexpr int GE = 32 * CONCAT_ROUNDS, UPG = GE / E;
  const int live_groups = (live + UPG - 1) / UPG, groups = (units + UPG - 1) / UPG;
  const int g1 = (int)((int64_t)groups * (blockIdx.z + 1) / gridDim.z);
  for (int g = (int)((int64_t)groups * blockIdx.z / gridDim.z) + warp; g < g1; g += nwarps) {
    if (g >= live_groups) {
#pragma unroll
      for (int k = 0; k < ES; ++k) {
        const int u = g * UPG + k * 32 + lane;
        if (u < units)
          *reinterpret_cast<uint4*>(dst + (int64_t)(head + u * E) * ES) = make_uint4(0, 0, 0, 0);
      }
      continue;
    }
    const int j0 = head + g * GE;  // < total
    int w = find_window(P, NW, j0);
    int p0 = P[w], p1 = P[w + 1];
    const int64_t s0 = (int64_t)OFF[w] + (j0 - p0);
    if (j0 + GE <= p1 && s0 + GE <= width) {
      // The group inside one window's segment: coalesced loads, all in flight.
      const uint32_t* q = srow + w * ws + (s0 + lane) * SW;
      const uint32_t add = base(w);
      uint32_t x[CONCAT_ROUNDS];
#pragma unroll
      for (int r = 0; r < CONCAT_ROUNDS; ++r) x[r] = __ldg(q + r * 32 * SW);
#pragma unroll
      for (int r = 0; r < CONCAT_ROUNDS; ++r)
        store_one<ES>(stage + (r * 32 + lane) * ES, x[r] + add);
    } else {
      // Across windows: the source indices first (branches), then the loads
      // with no branch between them, so that all are in flight at once; a
      // dead element reads the row's first word and keeps 0.
      int64_t idx[CONCAT_ROUNDS];
      uint32_t add[CONCAT_ROUNDS];
#pragma unroll
      for (int r = 0; r < CONCAT_ROUNDS; ++r) {
        const int j = j0 + r * 32 + lane;
        idx[r] = -1;
        if (j < total) {
          while (j >= p1) {
            p0 = p1;
            p1 = P[++w + 1];
          }
          const int64_t s = (int64_t)OFF[w] + (j - p0);
          if (s < width) idx[r] = w * ws + s * SW;
        }
        add[r] = base(w);
      }
      uint32_t x[CONCAT_ROUNDS];
#pragma unroll
      for (int r = 0; r < CONCAT_ROUNDS; ++r) x[r] = __ldg(srow + (idx[r] < 0 ? 0 : idx[r]));
#pragma unroll
      for (int r = 0; r < CONCAT_ROUNDS; ++r)
        store_one<ES>(stage + (r * 32 + lane) * ES, idx[r] < 0 ? 0u : x[r] + add[r]);
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < ES; ++k) {
      const int u = g * UPG + k * 32 + lane;
      if (u < units)
        *reinterpret_cast<uint4*>(dst + (int64_t)(head + u * E) * ES) =
            reinterpret_cast<const uint4*>(stage)[k * 32 + lane];
    }
    __syncwarp();
  }
  if (blockIdx.z == 0 && threadIdx.x == blockDim.x - 1) {  // the head and the tail, one by one
    int w = 0, p0 = 0, p1 = P[1];
    for (int j = 0; j < head; ++j) store_one<ES>(dst + (int64_t)j * ES, value(j, w, p0, p1));
    const int t0 = head + units * E;
    if (t0 < total) {
      w = find_window(P, NW, t0);
      p0 = P[w];
      p1 = P[w + 1];
    }
    for (int j = t0; j < out_len; ++j) store_one<ES>(dst + (int64_t)j * ES, value(j, w, p0, p1));
  }
}

__global__ void __launch_bounds__(CONCAT_THREADS)
concat_kernel(const __grid_constant__ ConcatArgs args, int NW) {
  extern __shared__ uint4 concat_smem[];
  // A warp's stage: one group's output, 512 elements of up to 8 bytes.
  char* stage = reinterpret_cast<char*>(concat_smem) + (threadIdx.x >> 5) * CONCAT_STAGE;
  int32_t* P = reinterpret_cast<int32_t*>(concat_smem) + CONCAT_THREADS / 32 * CONCAT_STAGE / 4;
  int32_t* OFF = P + NW + 1;  // P: NW + 1 clamped prefixes; OFF: NW source offsets
  const ConcatOp op = args.op[blockIdx.y];
  const int64_t b = blockIdx.x;
  if (threadIdx.x < 32) {
    // Lane l takes windows [l * k, l * k + k): their counts (clamped at
    // out_len, which leaves min(prefix, out_len) as it is) and offsets are
    // loaded CONCAT_SCAN_CHUNK at a time, all in flight, then the lanes'
    // sums are scanned with shuffles and each lane writes its prefixes.
    const int lane = threadIdx.x;
    const bool off64 = op.flags & CF_OFF64, cnt64 = op.flags & CF_CNT64;
    const int k = (NW + 31) >> 5, i0 = lane * k;
    int64_t sum = 0;
    for (int t0 = 0; t0 < k; t0 += CONCAT_SCAN_CHUNK) {
      int64_t c[CONCAT_SCAN_CHUNK], o[CONCAT_SCAN_CHUNK];
#pragma unroll
      for (int t = 0; t < CONCAT_SCAN_CHUNK; ++t) {
        const int i = i0 + t0 + t;
        const bool in = t0 + t < k && i < NW;
        c[t] = in ? load_index(op.cnt, cnt64, b * NW + i) : 0;
        o[t] = in && op.off ? load_index(op.off, off64, b * NW + i) : 0;
      }
#pragma unroll
      for (int t = 0; t < CONCAT_SCAN_CHUNK; ++t) {
        const int i = i0 + t0 + t;
        if (t0 + t < k && i < NW) {
          const int32_t ci = (int32_t)imin64(imax64(c[t], 0), op.out_len);
          P[i + 1] = ci;
          OFF[i] = (int32_t)imin64(imax64(o[t], 0), op.width);
          sum += ci;
        }
      }
    }
    int64_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int64_t t = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += t;
    }
    int64_t run = incl - sum;
    for (int t = 0; t < k && i0 + t < NW; ++t) {
      run += P[i0 + t + 1];
      P[i0 + t + 1] = (int32_t)imin64(run, op.out_len);
    }
    if (lane == 0) P[0] = 0;
  }
  __syncthreads();
  const int kind = (int)(op.flags >> CF_DST_SHIFT) & 3;
  const bool s64 = op.flags & CF_SRC64;
  if (kind == 0)
    s64 ? concat_row<1, 2>(op, P, OFF, NW, b, stage) : concat_row<1, 1>(op, P, OFF, NW, b, stage);
  else if (kind == 1)
    s64 ? concat_row<4, 2>(op, P, OFF, NW, b, stage) : concat_row<4, 1>(op, P, OFF, NW, b, stage);
  else
    s64 ? concat_row<8, 2>(op, P, OFF, NW, b, stage) : concat_row<8, 1>(op, P, OFF, NW, b, stage);
}

// descs: nops descriptors of 10 int64 each (struct ConcatOp), on the host.
// Every operand has B rows of NW windows; one CTA a (row, operand).
extern "C" int tz_concat_fused(const void* descs, int nops, int B, int NW,
                               cudaStream_t stream) {
  if (nops < 1 || nops > CONCAT_MAX_OPS || B < 0 || NW < 1 || NW > CONCAT_MAX_NW)
    return (int)cudaErrorInvalidValue;
  ConcatArgs args;
  memset(&args, 0, sizeof(args));
  memcpy(args.op, descs, sizeof(ConcatOp) * nops);
  if (B == 0) return 0;
  dim3 grid(B, nops, CONCAT_PARTS);
  const size_t smem = CONCAT_THREADS / 32 * CONCAT_STAGE + sizeof(int32_t) * (2 * NW + 1);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        concat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  concat_kernel<<<grid, CONCAT_THREADS, smem, stream>>>(args, NW);
  return (int)cudaGetLastError();
}
