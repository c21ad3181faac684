// Backward bitstream reader for the sequence decode kernel (K7): a 64-bit
// container over the stream's bytes in device memory (RFC 8878 §4.1: fields
// are read from the stream's end toward its start). Bits outside
// [0, 8 * nbytes) read as zeros, so a peek near the start is the
// zero-padded read libzstd does.
#pragma once
#include <stdint.h>

struct BackBits {
  const uint8_t* s;
  int nbytes;
  long long cb;        // stream bit position of the container's bit 0
  unsigned long long cont;

  __device__ void init(const uint8_t* stream, int n) {
    s = stream;
    nbytes = n;
    cb = 1LL << 40;    // forces a refill on the first read
    cont = 0;
  }
  // Load the 8 bytes ending with the byte that holds bit bp - 1: afterwards
  // 57..64 bits below bp are in the container.
  __device__ void refill(long long bp) {
    const long long first = ((bp - 1) >> 3) - 7;  // arithmetic shift: floor
    unsigned long long v = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long long p = first + k;
      if (p >= 0 && p < nbytes) v |= (unsigned long long)__ldg(s + p) << (8 * k);
    }
    cont = v;
    cb = first * 8;
  }
  // Bits [bp - n, bp) for n <= 31 (0 for n == 0).
  __device__ unsigned int read(long long bp, int n) {
    if (n <= 0) return 0;
    if (bp - n < cb || bp > cb + 64) refill(bp);
    return (unsigned int)((cont >> (bp - n - cb)) & ((1ULL << n) - 1));
  }
};
