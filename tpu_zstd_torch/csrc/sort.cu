// K12: ascending sort of each row by a unique signed int32 key, carrying
// payload rows.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_sort.py `sort_rows`
// (`_sort_rows_impl` / `_make_kernel`), a bitonic network over a row held in
// VMEM that moves the key and every payload through each compare-exchange.
//
// Bound: bytes, each operand read once and written once (0.12 ms for 3
// operands at 2048 x 8192 on the H100). Run as 91 barriered passes over
// shared memory at W 8192, the bitonic network takes ten times that
// (PERF.md). The network's work does not depend on the data, so the design
// keeps it in registers as far as it can (bitonic.cuh); the network's
// instructions, not the bytes, still set the time (PERF.md).
// - Rows of up to 8192 columns: one CTA a row. Each of 512 threads holds 16
//   consecutive keys and their slots (original columns) in registers, loaded
//   with 16-byte loads, and runs the register network of bitonic.cuh; only
//   the 10 stages across warps use shared memory (key and slot, 8 bytes a
//   column: 64 KB at W 8192, two CTAs an SM). The sorted keys are stored
//   from registers with 16-byte stores. The payloads never enter the
//   network: each payload row is staged in shared memory, two at a time
//   (the exchange buffers), with 16-byte loads, then every thread reads its
//   16 elements there by slot and stores them with 16-byte stores.
// - Wider rows (any power of two up to 2^30): the same kernel sorts tiles of
//   8192 columns ascending into scratch (key and slot), then merge-path
//   passes of bitonic.cuh merge pairs of runs, log2(W / 8192) passes, the
//   last of which gathers each payload by slot from device memory (a
//   permutation inside one row, which L2 holds) and writes the keys.
// - The payload pointers reach the kernel by value (up to MAX_PAY a launch;
//   the wrapper launches again for more), so a call copies nothing to the
//   device before its launch: a pointer array in device memory cost a
//   blocking host-to-device copy a call.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

namespace {

constexpr int SORT_LOG_TILE = 13;  // widest row one CTA sorts: 8192 columns

// Elements a thread: E = 2^sort_log_e(log_w), T = W / E threads.
__host__ __device__ constexpr int sort_log_e(int log_w) { return log_w <= 11 ? 3 : 4; }
// At W 8192 two CTAs an SM (64 KB of shared memory each).
__host__ __device__ constexpr int sort_min_blocks(int log_w) { return log_w == 13 ? 2 : 1; }

// One CTA a row (or a tile of a wider row): sort the key with its slot;
// then either store the key and gather the npay payloads by slot (slot_out
// null), or store the key and the slot as the row column (tile mode: the
// tile is part of a row of 2^log_w_row columns).
template <int LOG_W>
__global__ void __launch_bounds__(1 << (LOG_W - sort_log_e(LOG_W)), sort_min_blocks(LOG_W))
sort_rows_kernel(const int32_t* __restrict__ key, int32_t* __restrict__ key_out,
                 const Payloads pay, int32_t* __restrict__ slot_out, int log_w_row) {
  constexpr int LOG_E = sort_log_e(LOG_W);
  constexpr int E = 1 << LOG_E;
  constexpr int W = 1 << LOG_W;
  constexpr int T = W / E;
  extern __shared__ int4 smem4[];
  int32_t* xk = reinterpret_cast<int32_t*>(smem4);
  int32_t* xs = xk + W;
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x << LOG_W;
  int32_t k[E], s[E];
  load_row<E>(key + base, t, k);
#pragma unroll
  for (int e = 0; e < E; ++e) s[e] = t * E + e;
  network_sort<LOG_E, LOG_W - LOG_E, true>(k, s, xk, xs);
  store_row<E>(key_out + base, t, k);
  if (slot_out != nullptr) {
    store_row<E>(slot_out + base, t, s, (int32_t)(base & ((1LL << log_w_row) - 1)));
    return;
  }
  for (int p = 0; p < pay.n; p += 2) {  // two payload rows a round, in xk and xs
    const bool two = p + 1 < pay.n;
    const int4* in0 = reinterpret_cast<const int4*>(pay.in[p]) + (base >> 2);
    const int4* in1 = two ? reinterpret_cast<const int4*>(pay.in[p + 1]) + (base >> 2) : nullptr;
    __syncthreads();  // the previous readers of xk and xs are done
    for (int q = t; q < W / 4; q += T) {
      reinterpret_cast<int4*>(xk)[q] = in0[q];
      if (two) reinterpret_cast<int4*>(xs)[q] = in1[q];
    }
    __syncthreads();
    int32_t v[E];
#pragma unroll
    for (int e = 0; e < E; ++e) v[e] = xk[s[e]];
    store_row<E>(reinterpret_cast<int32_t*>(pay.out[p]) + base, t, v);
    if (two) {
#pragma unroll
      for (int e = 0; e < E; ++e) v[e] = xs[s[e]];
      store_row<E>(reinterpret_cast<int32_t*>(pay.out[p + 1]) + base, t, v);
    }
  }
}

template <int LOG_W>
int launch_sort(const int32_t* key, int32_t* key_out, const Payloads& pay, int32_t* slot_out,
                int log_w_row, int64_t grid, cudaStream_t stream) {
  const int smem = 2 * (int)sizeof(int32_t) << LOG_W;
  cudaError_t err = cudaFuncSetAttribute(sort_rows_kernel<LOG_W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  sort_rows_kernel<LOG_W><<<(unsigned)grid, 1 << (LOG_W - sort_log_e(LOG_W)), smem, stream>>>(
      key, key_out, pay, slot_out, log_w_row);
  return (int)cudaGetLastError();
}

}  // namespace

// key, key_out: int32 (R, 2^log_w), 16-byte aligned; pay_in / pay_out: host
// arrays of npay <= MAX_PAY device pointers (int32 (R, 2^log_w) payloads,
// 16-byte aligned); scratch: int32 (3, R, 2^log_w), used for rows wider than
// 8192 only.
extern "C" int tz_sort_rows(const void* key, void* key_out, const void* pay_in,
                            const void* pay_out, void* scratch, int npay, int64_t R, int log_w,
                            cudaStream_t stream) {
  if (npay < 0 || npay > MAX_PAY) return (int)cudaErrorInvalidValue;
  const int32_t* k = (const int32_t*)key;
  int32_t* ko = (int32_t*)key_out;
  Payloads pay = {};
  for (int p = 0; p < npay; ++p) {
    pay.in[p] = ((const int64_t*)pay_in)[p];
    pay.out[p] = ((const int64_t*)pay_out)[p];
  }
  pay.n = npay;
  switch (log_w) {
    case 10: return launch_sort<10>(k, ko, pay, nullptr, 10, R, stream);
    case 11: return launch_sort<11>(k, ko, pay, nullptr, 11, R, stream);
    case 12: return launch_sort<12>(k, ko, pay, nullptr, 12, R, stream);
    case 13: return launch_sort<13>(k, ko, pay, nullptr, 13, R, stream);
    default: break;
  }
  if (log_w <= SORT_LOG_TILE || log_w > 30 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  // Buffers: x (scratch 0) and key_out for the keys, scratch 1 and 2 for the
  // slots. The last merge pass reads pass (M - 1) % 2's buffer and writes
  // key_out, so x takes that parity.
  const int64_t n = R << log_w;
  int32_t* x = (int32_t*)scratch;
  const int passes = log_w - SORT_LOG_TILE;
  int32_t* kb0 = passes & 1 ? x : ko;
  int32_t* kb1 = passes & 1 ? ko : x;
  int32_t* sb0 = npay ? x + n : nullptr;
  const Payloads none = {};
  int err = launch_sort<SORT_LOG_TILE>(k, kb0, none, sb0, log_w, n >> SORT_LOG_TILE, stream);
  if (err != 0) return err;
  if (npay == 0)
    return merge_rows<false>(kb0, kb1, nullptr, nullptr, ko, pay, R, log_w, SORT_LOG_TILE,
                             stream);
  return merge_rows<true>(kb0, kb1, sb0, x + 2 * n, ko, pay, R, log_w, SORT_LOG_TILE, stream);
}
