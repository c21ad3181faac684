// K6: chunk-parallel 4-stream Huffman literal decode (RFC 8878 §4.2.2).
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_decode.py
// `decode_huffman_lanes` (semantics of tpu_zstd/ops/decode_jax.py
// `decode_huffman_device`). A block's literals are 4 backward Huffman
// streams; the encoder publishes, per stream, the unread-bit cursor before
// every `stride`-th forward symbol (format/accel.py), so each chunk of
// `stride` symbols decodes independently: peek table_log bits (zero-padded
// past the stream start), look up the packed (symbol << 4 | nb_bits) entry,
// consume nb_bits.
//
// Design: one CTA per block, its <= 2048-entry table in shared memory; one
// thread per (stream, chunk) row (rows 4b + s, chunk c; a CTA of
// min(4 * chunks, 256) threads loops over the rows). A thread starts at the
// stream's data end for chunk 0 and at record c-1 for chunk c, and reads
// its stream's own bytes in device memory through a 64-bit container: no
// per-chunk word slice is staged, so no checkpoint record is ever used as a
// chunk's end bound (the TPU staging did that with forward-filled records
// and mis-decoded ~0.3 % of blocks).
//
// Bound: bytes on paper (streams read once, symbols written once); in
// practice the serial chain of dependent table lookups per thread
// (~stride steps of shared-memory latency) and the few threads per CTA
// (128 at 128 KB blocks and stride 1024). Output stores are one byte per
// thread per step, strided by the row width: not coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitreader.cuh"

#define HUF_TSIZE 2048
#define HUF_MAX_TL 11

__global__ void decode_huffman_kernel(const uint8_t* __restrict__ streams,
                                      const int32_t* __restrict__ tbits,
                                      const int32_t* __restrict__ dtable,
                                      const int32_t* __restrict__ table_log,
                                      const int32_t* __restrict__ nsym,
                                      const int32_t* __restrict__ ck, uint8_t* __restrict__ out,
                                      int SW, int K, int stride, int NC) {
  __shared__ int s_tab[HUF_TSIZE];
  const int b = blockIdx.x;
  const int tl = min(max(table_log[b], 0), HUF_MAX_TL);
  for (int i = threadIdx.x; i < (1 << tl); i += blockDim.x) s_tab[i] = dtable[(long long)b * HUF_TSIZE + i];
  __syncthreads();

  const long long width = (long long)NC * stride;
  for (int t = threadIdx.x; t < 4 * NC; t += blockDim.x) {
    const int row = 4 * b + t / NC;
    const int c = t % NC;
    const int n = min(stride, nsym[row] - c * stride);
    if (n <= 0) continue;
    // A chunk without a record starts at 0, as the plain version's padding.
    long long bp = c == 0 ? tbits[row] : (c <= K ? ck[(long long)row * K + c - 1] : 0);
    BackBits br;
    br.init(streams + (long long)row * SW, SW);
    uint8_t* o = out + row * width + (long long)c * stride;
    for (int i = 0; i < n; ++i) {
      const int e = s_tab[br.read(bp, tl)];
      o[i] = (uint8_t)(e >> 4);
      bp -= e & 15;
    }
  }
}

extern "C" int tz_decode_huffman(const void* streams, const void* tbits, const void* dtable,
                                 const void* table_log, const void* nsym, const void* ck,
                                 void* out, int B, int SW, int K, int stride, int NC,
                                 int threads, cudaStream_t stream) {
  if (B <= 0 || SW <= 0 || K <= 0 || stride <= 0 || NC <= 0 || threads <= 0 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  decode_huffman_kernel<<<B, threads, 0, stream>>>(
      (const uint8_t*)streams, (const int32_t*)tbits, (const int32_t*)dtable,
      (const int32_t*)table_log, (const int32_t*)nsym, (const int32_t*)ck, (uint8_t*)out, SW, K,
      stride, NC);
  return (int)cudaGetLastError();
}
