// K11: LSB-first deposit of (value, length, bit offset) fields into words.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_deposit.py
// `deposit_bits_pallas` (`_deposit_kernel`). Per row, field f puts the low
// length[f] bits of value[f] at bit offset[f] of the row's word stream: the
// part `lo = v << sh` into word offset >> 5 and the spill
// `hi = (v >> 1) >> (31 - sh)` into the next word (sh = offset & 31).
//
// The TPU kernel sums each chunk of 128 fields into a 512-word window that
// starts at the 128-word row row0 = min(offset[first field] >> 12,
// nw / 128 - 4), in float32 halves: bit ranges are disjoint, so the sums are
// exact and equal an OR. This kernel runs one thread a field and ORs both
// parts into the zeroed output with 64-bit atomics (the words are u32 held
// in int64, the port's layout). It keeps the TPU kernel's window rule: a
// part whose word lies outside its chunk's window [row0 * 128,
// row0 * 128 + 512) is dropped, as the TPU kernel drops it, which matters
// only near the end of the row (where row0 is clamped) or where a chunk's
// offsets span more than the window.
//
// Bound: bytes (each field read once, each word written once); the atomics
// contend only between neighbouring fields that share a word.
#include <cuda_runtime.h>
#include <stdint.h>

#define DEP_T 256
#define DEP_CHUNK 128
#define DEP_WIN 512

__global__ void __launch_bounds__(DEP_T)
deposit_bits_kernel(const int64_t* __restrict__ vals, const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ offs, unsigned long long* __restrict__ out,
                    int64_t B, int M, int nw) {
  const int64_t t = (int64_t)blockIdx.x * DEP_T + threadIdx.x;
  if (t >= B * M) return;
  const int ln = lens[t];
  if (ln <= 0) return;
  const int64_t b = t / M;
  const int f = (int)(t - b * M);
  const int off = offs[t];
  const int first = offs[b * M + (f & ~(DEP_CHUNK - 1))];
  const int row0 = min(first >> 12, nw / 128 - DEP_WIN / 128);
  const int word = off >> 5;
  const int wrel = word - row0 * 128;
  const uint32_t mask = ln >= 32 ? 0xFFFFFFFFu : ((1u << ln) - 1u);
  const uint32_t v = (uint32_t)vals[t] & mask;
  const int sh = off & 31;
  const uint32_t lo = v << sh;
  const uint32_t hi = (v >> 1) >> (31 - sh);
  unsigned long long* row = out + b * nw;
  if (lo != 0 && wrel >= 0 && wrel < DEP_WIN) atomicOr(row + word, (unsigned long long)lo);
  if (hi != 0 && wrel + 1 >= 0 && wrel + 1 < DEP_WIN)
    atomicOr(row + word + 1, (unsigned long long)hi);
}

// vals int64 (low 32 bits used), lens and offs int32, each (B, M); out int64
// (B, nw), zeroed by the caller; nw a multiple of 128, at least 512.
extern "C" int tz_deposit_bits(const void* vals, const void* lens, const void* offs, void* out,
                               int64_t B, int M, int nw, cudaStream_t stream) {
  const int64_t blocks = (B * (int64_t)M + DEP_T - 1) / DEP_T;
  deposit_bits_kernel<<<(unsigned)blocks, DEP_T, 0, stream>>>(
      (const int64_t*)vals, (const int32_t*)lens, (const int32_t*)offs,
      (unsigned long long*)out, B, M, nw);
  return (int)cudaGetLastError();
}
