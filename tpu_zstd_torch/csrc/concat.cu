// K2: per-block variable-length segment concatenation.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_concat.py
// `concat_varlen` (`_batched` / `_kern`). For block b, segment w is
// x[b, w, off[b, w] : off[b, w] + cnt[b, w]]; segments land in window order
// at exclusive-prefix offsets in out[b, :out_len]. As in the TPU kernel each
// count is clamped at what is left of out_len, which makes the clamped
// offset of segment w equal to min(prefix_w, out_len); the caller zeroes the
// output, so the tail stays zero.
//
// The TPU kernel walks the windows in order inside one grid step (a rotate
// plus a masked read-modify-write per window). On Hopper the windows are
// independent once each knows its offset, so one thread block per
// (batch row, window) sums the NW preceding counts and copies its segment.
// Bound: bytes (each copied element read once and written once).
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void concat_varlen_kernel(const int32_t* __restrict__ x,
                                     const int32_t* __restrict__ src_off,
                                     const int32_t* __restrict__ counts,
                                     int32_t* __restrict__ out, int NW, int W,
                                     int out_len) {
  const int w = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int32_t* cnt = counts + b * NW;
  __shared__ int64_t prefix;
  if (threadIdx.x == 0) {
    int64_t p = 0;
    for (int v = 0; v < w; ++v) p += cnt[v];
    prefix = p;
  }
  __syncthreads();
  const int64_t S = prefix < out_len ? prefix : out_len;
  int64_t c = cnt[w];
  if (c > out_len - S) c = out_len - S;
  const int32_t* src = x + (b * NW + w) * (int64_t)W + src_off[b * NW + w];
  int32_t* dst = out + b * out_len + S;
  for (int64_t i = threadIdx.x; i < c; i += blockDim.x) dst[i] = src[i];
}

extern "C" int tz_concat_varlen(const void* x, const void* src_off, const void* counts,
                                void* out, int B, int NW, int W, int out_len,
                                cudaStream_t stream) {
  dim3 grid(NW, B);
  concat_varlen_kernel<<<grid, 256, 0, stream>>>(
      (const int32_t*)x, (const int32_t*)src_off, (const int32_t*)counts, (int32_t*)out,
      NW, W, out_len);
  return (int)cudaGetLastError();
}
