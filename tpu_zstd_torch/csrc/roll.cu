// K1: per-row circular right roll, out[r, (j + s[r]) mod W] = x[r, j].
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_roll.py `roll_rows`
// (`_pallas_roll_2d` with `_kern32` / `_kern8`). The TPU version rotates
// (Q, 128) vector tiles and carries bytes as u32 words because its rotate is
// 32-bit only; on Hopper every thread simply reads its source element, so
// one kernel serves 1-, 4- and 8-byte elements.
//
// Bound: bytes. It reads each input element once and writes each output
// element once (2 * rows * W * elem bytes); the design is a grid-stride copy
// over the flattened (row, column) index whose reads and writes are both
// contiguous apart from one wrap per row.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename T>
__global__ void roll_rows_kernel(const T* __restrict__ x, T* __restrict__ out,
                                 const int64_t* __restrict__ shift, int64_t rows,
                                 int64_t width) {
  const int64_t total = rows * width;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t r = i / width;
    const int64_t k = i - r * width;
    int64_t s = shift[r] % width;
    if (s < 0) s += width;
    int64_t j = k - s;
    if (j < 0) j += width;
    out[i] = x[r * width + j];
  }
}

template <typename T>
static void launch_roll(const void* x, void* out, const void* shift, int64_t rows,
                        int64_t width, cudaStream_t stream) {
  const int threads = 256;
  int64_t blocks = (rows * width + threads - 1) / threads;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  roll_rows_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      (const T*)x, (T*)out, (const int64_t*)shift, rows, width);
}

extern "C" int tz_roll_rows(const void* x, void* out, const void* shift, int64_t rows,
                            int64_t width, int elem_size, cudaStream_t stream) {
  switch (elem_size) {
    case 1: launch_roll<uint8_t>(x, out, shift, rows, width, stream); break;
    case 4: launch_roll<uint32_t>(x, out, shift, rows, width, stream); break;
    case 8: launch_roll<uint64_t>(x, out, shift, rows, width, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
