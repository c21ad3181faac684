// K12: ascending sort of each row by a unique signed int32 key, carrying
// payload rows.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_sort.py `sort_rows`
// (`_sort_rows_impl` / `_make_kernel`), a bitonic network over a row held in
// VMEM that moves the key and every payload through each compare-exchange.
//
// Design: one CTA a row. The key and a slot index (the element's original
// column) live in dynamic shared memory, 8 bytes a column: 64 KB at W 8192,
// 128 KB at W 16384, so the launch opts in above 48 KB. The network of
// bitonic.cuh sorts (key, slot); the payloads never enter shared memory:
// after the network each payload row is gathered by slot from device memory
// (a permutation inside one row, which L2 holds), so any operand count fits.
// Rows wider than 16384 (any power of two up to 2^30) take the tiled network
// of bitonic.cuh (tiles of 16384 columns, the stages across tiles as passes
// over device memory) on the output key row and a (key, slot) scratch row,
// then the same gather of each payload by slot in a last kernel.
//
// Bound: on paper bytes (each operand read and written once), but each row
// runs log2(W) (log2(W) + 1) / 2 network stages of W / 2 compare-exchanges
// in shared memory, one barrier a stage, so the shared-memory traffic and
// the barriers set the time of this simple version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitonic.cuh"

template <int LOG_W>
__global__ void __launch_bounds__((1 << LOG_W) / 2 < 1024 ? (1 << LOG_W) / 2 : 1024)
sort_rows_kernel(const int32_t* __restrict__ key, int32_t* __restrict__ key_out,
                 const int64_t* __restrict__ pay_in, const int64_t* __restrict__ pay_out,
                 int npay) {
  constexpr int W = 1 << LOG_W;
  constexpr int T = W / 2 < 1024 ? W / 2 : 1024;
  extern __shared__ int32_t smem[];
  int32_t* s_key = smem;
  int32_t* s_slot = smem + W;
  const int64_t base = (int64_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W; i += T) {
    s_key[i] = key[base + i];
    s_slot[i] = i;
  }
  bitonic_sort_smem<LOG_W, T, true>(s_key, s_slot);
  for (int i = threadIdx.x; i < W; i += T) key_out[base + i] = s_key[i];
  for (int p = 0; p < npay; ++p) {
    const int32_t* src = reinterpret_cast<const int32_t*>(pay_in[p]) + base;
    int32_t* dst = reinterpret_cast<int32_t*>(pay_out[p]) + base;
    for (int i = threadIdx.x; i < W; i += T) dst[i] = src[s_slot[i]];
  }
}

template <int LOG_W>
static int launch_sort(const void* key, void* key_out, const void* pay_in, const void* pay_out,
                       int npay, int64_t R, cudaStream_t stream) {
  constexpr int W = 1 << LOG_W;
  constexpr int T = W / 2 < 1024 ? W / 2 : 1024;
  const size_t smem = 2 * sizeof(int32_t) * (size_t)W;
  cudaError_t err = cudaFuncSetAttribute(
      sort_rows_kernel<LOG_W>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  sort_rows_kernel<LOG_W><<<(unsigned)R, T, smem, stream>>>(
      (const int32_t*)key, (int32_t*)key_out, (const int64_t*)pay_in, (const int64_t*)pay_out,
      npay);
  return (int)cudaGetLastError();
}

// Wide rows: payload p of element i is the payload at column slot[i] of its row.
__global__ void __launch_bounds__(256)
gather_payloads_kernel(const int32_t* __restrict__ slot, const int64_t* __restrict__ pay_in,
                       const int64_t* __restrict__ pay_out, int npay, int64_t n, int log_w) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t src = ((i >> log_w) << log_w) + slot[i];
    for (int p = 0; p < npay; ++p) {
      const int32_t* in = reinterpret_cast<const int32_t*>(pay_in[p]);
      reinterpret_cast<int32_t*>(pay_out[p])[i] = in[src];
    }
  }
}

// pay_in / pay_out: device arrays of npay payload pointers (int32 (R, W) each);
// slot: int32 (R, W) scratch, used for rows wider than 16384 only.
extern "C" int tz_sort_rows(const void* key, void* key_out, const void* pay_in,
                            const void* pay_out, void* slot, int npay, int64_t R, int log_w,
                            cudaStream_t stream) {
  if (log_w > 14) {
    if (slot == nullptr) return (int)cudaErrorInvalidValue;
    const int err = bitonic_sort_wide<14, true>((const int32_t*)key, (int32_t*)key_out,
                                                (int32_t*)slot, R, log_w, stream);
    if (err != 0 || npay == 0) return err;
    const int64_t n = R << log_w;
    gather_payloads_kernel<<<(unsigned)((n + 255) / 256 < 132 * 16 ? (n + 255) / 256 : 132 * 16),
                             256, 0, stream>>>((const int32_t*)slot, (const int64_t*)pay_in,
                                               (const int64_t*)pay_out, npay, n, log_w);
    return (int)cudaGetLastError();
  }
  switch (log_w) {
    case 10: return launch_sort<10>(key, key_out, pay_in, pay_out, npay, R, stream);
    case 11: return launch_sort<11>(key, key_out, pay_in, pay_out, npay, R, stream);
    case 12: return launch_sort<12>(key, key_out, pay_in, pay_out, npay, R, stream);
    case 13: return launch_sort<13>(key, key_out, pay_in, pay_out, npay, R, stream);
    case 14: return launch_sort<14>(key, key_out, pay_in, pay_out, npay, R, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
