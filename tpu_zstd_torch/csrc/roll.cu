// K1: per-row circular right roll, out[r, (j + s[r]) mod W] = x[r, j].
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_roll.py `roll_rows`
// (`_pallas_roll_2d` with `_kern32` / `_kern8`). The TPU version rotates
// (Q, 128) vector tiles and carries bytes as u32 words because its rotate is
// 32-bit only (a word roll plus a borrow from the neighbouring word).
//
// Bound: bytes. It reads each input element and each row's shift once and
// writes each output element once. The pipeline rolls rows of every shape:
// 128 byte rows of 110-190 KB, and the deposit trees' int64 word rows of
// widths 2-16384 with up to millions of rows. Per element, a thread that
// divides its flat index by W, reloads shift[r] and takes it modulo W in 64
// bits spends more time on integer arithmetic than on the 1-8 bytes it moves.
//
// Design: one kernel works on row bytes (row width WB = W * elem bytes, the
// shift s * elem bytes), in units of 16 output bytes, or of one element for
// 4- and 8-byte rows whose rows are not 16-byte aligned:
//   - each CTA owns a contiguous range of units; its first row comes from
//     one 64-bit division per CTA, and its threads normalise the shifts of
//     the rows it touches (64-bit modulo only for a shift outside [-W, W))
//     into shared memory;
//   - a unit finds its row with one 32-bit multiply-high by a reciprocal the
//     host computes (Granlund-Montgomery), never with a divide;
//   - a 16-byte output unit's source is 16 contiguous bytes of the row, at
//     most two aligned 16-byte vectors (circularly, when the row is 16-byte
//     aligned): both are loaded and combined in registers with
//     `__funnelshift_r`, then stored as one aligned vector. The TPU kernel's
//     word roll plus borrow, done on 16-byte vectors;
//   - rows that are not 16-byte aligned (byte rows of odd width) take the
//     same vector path inside a row, and copy byte by byte the unit that
//     straddles two rows, the unit whose source wraps and the buffer's end;
//   - narrow rows are not special: a CTA covers many whole rows, so loads
//     and stores stay contiguous across row boundaries and nothing is
//     launched per row.
#include <cuda_runtime.h>
#include <stdint.h>

#define ROLL_THREADS 256
#define ROLL_MAX_ROWS 8192  // most rows a CTA may touch (its shift table in shared memory)

enum { ROLL_ALIGNED = 0, ROLL_BYTES = 1, ROLL_ELEMS = 2 };

// q / d for q < 2^32 with the host's (m, l) for d: l = ceil(log2 d),
// m = floor(2^32 (2^l - d) / d) + 1.
__device__ __forceinline__ uint32_t fast_div(uint32_t q, uint32_t m, int l) {
  return (uint32_t)(((unsigned long long)__umulhi(q, m) + q) >> l);
}

__device__ __forceinline__ int norm_shift(long long s, int W) {
  if (s >= 0 && s < W) return (int)s;
  if (s < 0 && s >= -(long long)W) return (int)(s + W);
  long long r = s % W;  // once per row, only for a shift outside [-W, W)
  return (int)(r < 0 ? r + W : r);
}

// Bytes d .. d + 15 of the 32 bytes a:b (little-endian words).
__device__ __forceinline__ uint4 funnel16(uint4 a, uint4 b, int d) {
  const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  const int sh = (d & 3) * 8;
#define FS(i) __funnelshift_r(v[i], v[(i) + 1], sh)
  switch (d >> 2) {
    case 0: return make_uint4(FS(0), FS(1), FS(2), FS(3));
    case 1: return make_uint4(FS(1), FS(2), FS(3), FS(4));
    case 2: return make_uint4(FS(2), FS(3), FS(4), FS(5));
    default: return make_uint4(FS(3), FS(4), FS(5), FS(6));
  }
#undef FS
}

// 16 source bytes starting at address p (no wrap): one or two aligned vectors.
__device__ __forceinline__ uint4 load16_at(const uint8_t* p) {
  const uintptr_t a = (uintptr_t)p;
  const uint4* v = (const uint4*)(a & ~(uintptr_t)15);
  const int d = (int)(a & 15);
  const uint4 lo = __ldg(v);
  return d ? funnel16(lo, __ldg(v + 1), d) : lo;
}

// MODE ROLL_ALIGNED: x 16-byte aligned, WB % 16 == 0, units of 16 bytes.
// MODE ROLL_BYTES: anything else with 1-byte elements, units of 16 bytes.
// MODE ROLL_ELEMS: 4- or 8-byte elements (type T), units of one element.
template <int MODE, typename T>
__global__ void __launch_bounds__(ROLL_THREADS)
roll_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
            const int64_t* __restrict__ shift, long long total_bytes, int W, int WB, int E,
            int upt, uint32_t magic, int mlog) {
  constexpr int US = MODE == ROLL_ELEMS ? (int)sizeof(T) : 16;
  extern __shared__ int s_ns[];  // normalised shift in bytes of each row the CTA touches
  __shared__ long long s_row0;
  __shared__ int s_base, s_nrows;
  const long long units = (total_bytes + US - 1) / US;
  const long long unit0 = (long long)blockIdx.x * blockDim.x * upt;
  if (threadIdx.x == 0) {
    const long long b0 = unit0 * US;
    long long b1 = (unit0 + (long long)blockDim.x * upt) * US;
    if (b1 > total_bytes) b1 = total_bytes;
    const long long r0 = b0 / WB;  // once per CTA
    s_row0 = r0;
    s_base = (int)(b0 - r0 * WB);
    s_nrows = (int)((b1 - 1) / WB - r0 + 1);
  }
  __syncthreads();
  const long long r0 = s_row0;
  const int base = s_base, nrows = s_nrows;
  for (int i = threadIdx.x; i < nrows; i += blockDim.x)
    s_ns[i] = norm_shift(shift[r0 + i], W) * E;
  __syncthreads();
  const uint8_t* xr0 = x + r0 * WB;
  for (int j = 0; j < upt; ++j) {
    const int ul = j * blockDim.x + threadIdx.x;
    const long long u = unit0 + ul;
    if (u >= units) break;
    const uint32_t qq = (uint32_t)base + (uint32_t)ul * US;  // byte offset from row r0
    const int rl = (int)fast_div(qq, magic, mlog);
    const int k = (int)(qq - (uint32_t)rl * (uint32_t)WB);  // byte column in the row
    const uint8_t* row = xr0 + (long long)rl * WB;
    if (MODE == ROLL_ELEMS) {
      int src = k - s_ns[rl];
      if (src < 0) src += WB;
      ((T*)out)[u] = *(const T*)(row + src);
    } else if (MODE == ROLL_ALIGNED) {
      int src = k - s_ns[rl];
      if (src < 0) src += WB;
      const int a = src & ~15, d = src & 15;
      const uint4 lo = __ldg((const uint4*)(row + a));
      uint4 v = lo;
      if (d) {
        const int bnext = a + 16 == WB ? 0 : a + 16;  // the row's first vector follows its last
        v = funnel16(lo, __ldg((const uint4*)(row + bnext)), d);
      }
      ((uint4*)out)[u] = v;
    } else {
      const long long q = u * 16;
      bool done = false;
      if (q + 16 <= total_bytes && k + 16 <= WB) {
        int src = k - s_ns[rl];
        if (src < 0) src += WB;
        if (src + 16 <= WB) {
          ((uint4*)out)[u] = load16_at(row + src);
          done = true;
        }
      }
      if (!done) {  // straddles two rows, wraps, or ends the buffer
        int kk = k, rr = rl;
        for (int b = 0; b < 16 && q + b < total_bytes; ++b, ++kk) {
          while (kk >= WB) {
            kk -= WB;
            ++rr;
          }
          int src = kk - s_ns[rr];
          if (src < 0) src += WB;
          out[q + b] = xr0[(long long)rr * WB + src];
        }
      }
    }
  }
}

template <int MODE, typename T>
static int launch_roll(const void* x, void* out, const void* shift, long long total_bytes,
                       int W, int WB, int E, cudaStream_t stream) {
  const int US = MODE == ROLL_ELEMS ? E : 16;
  // Units per thread: as many as keep a CTA's rows within its shift table.
  int upt = MODE == ROLL_ELEMS ? 8 : 4;
  long long max_rows;
  while ((max_rows = ((long long)ROLL_THREADS * upt * US - 1) / WB + 2) > ROLL_MAX_ROWS && upt > 1)
    upt >>= 1;
  const long long per_cta = (long long)ROLL_THREADS * upt;
  const long long units = (total_bytes + US - 1) / US;
  const long long blocks = (units + per_cta - 1) / per_cta;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  int l = 0;
  while ((1LL << l) < WB) ++l;
  const uint32_t m = (uint32_t)((((1ULL << l) - (unsigned long long)WB) << 32) / WB + 1);
  const size_t smem = (size_t)max_rows * sizeof(int);
  roll_kernel<MODE, T><<<(unsigned)blocks, ROLL_THREADS, smem, stream>>>(
      (const uint8_t*)x, (uint8_t*)out, (const int64_t*)shift, total_bytes, W, WB, E, upt, m, l);
  return (int)cudaGetLastError();
}

extern "C" int tz_roll_rows(const void* x, void* out, const void* shift, int64_t rows,
                            int64_t width, int elem_size, cudaStream_t stream) {
  if (elem_size != 1 && elem_size != 4 && elem_size != 8) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || width <= 0 || width * elem_size >= (1LL << 30)) return (int)cudaErrorInvalidValue;
  if ((uintptr_t)out & 15) return (int)cudaErrorMisalignedAddress;  // the wrapper's fresh tensor
  const int W = (int)width, E = elem_size, WB = W * E;
  const long long total = rows * (long long)WB;
  const bool aligned = WB % 16 == 0 && ((uintptr_t)x & 15) == 0;
  if (aligned) return launch_roll<ROLL_ALIGNED, uint8_t>(x, out, shift, total, W, WB, E, stream);
  if (E == 1) return launch_roll<ROLL_BYTES, uint8_t>(x, out, shift, total, W, WB, E, stream);
  if (E == 4) return launch_roll<ROLL_ELEMS, uint32_t>(x, out, shift, total, W, WB, E, stream);
  return launch_roll<ROLL_ELEMS, uint64_t>(x, out, shift, total, W, WB, E, stream);
}
