// K7: chunk-parallel FSE sequence decode (RFC 8878 §3.1.1.3.2, §3.1.1.5).
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_decode.py
// `decode_sequences_lanes` (semantics of tpu_zstd/ops/decode_jax.py
// `_decode_seqs_core`). A block's sequences are one backward bitstream
// read by three interleaved FSE states (LL, OF, ML). Decode-acceleration
// frames publish, every `stride` sequences, the unread-bit cursor, the
// three states (ll | of<<10 | ml<<20) and the repeat-offset triple
// (format/accel.py), so each chunk of `stride` sequences decodes
// independently. Per sequence: look the three states up, read the OF, ML,
// LL extra bits, resolve the offset against the rep triple, then (except
// after the block's last sequence) read the LL, ML, OF state bits.
//
// Design: one CTA per block, the block's three <= 512-entry dense tables in
// shared memory (packed symbol | nb_bits << 8 | new_state << 16), the
// LL/ML baseline and extra-bit tables in constant memory; one thread per
// chunk (a CTA of min(chunks, 256) threads loops over the chunks). Chunk 0
// reads its states from the stream head and starts from the caller's rep
// triple (1, 4, 8 for a frame's first block); chunk c >= 1 starts from
// record c-1. Each thread reads its stream's bytes in device memory through
// a 64-bit container (offset, match and literal fields together can pass 32
// bits). One chunk per block (a CTA of one thread) is the serial decode of
// frames without checkpoints.
//
// Bound: bytes on paper (stream read once, ll/ml/off written once); in
// practice the serial chain of `stride` dependent steps per thread, with
// few threads per CTA (<= 172 at 128 KB blocks, one in serial mode).
// Neighbouring threads write `stride` * 4 bytes apart: not coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "bitreader.cuh"

#define SEQ_TSIZE 512

__constant__ int c_ll_base[36] = {0,  1,  2,  3,  4,  5,   6,   7,   8,   9,    10,   11,
                                  12, 13, 14, 15, 16, 18,  20,  22,  24,  28,   32,   40,
                                  48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
__constant__ int c_ll_bits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                                  1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
__constant__ int c_ml_base[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  12,  13,  14,  15,   16,   17,   18,   19,   20,
    21, 22, 23, 24, 25, 26, 27, 28, 29,  30,  31,  32,  33,   34,   35,   37,   39,   41,
    43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
__constant__ int c_ml_bits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,
                                  0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,  1,  1,
                                  2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

__global__ void decode_sequences_kernel(
    const uint8_t* __restrict__ streams, const int32_t* __restrict__ tbits,
    const int32_t* __restrict__ tables, const int32_t* __restrict__ table_log,
    const int32_t* __restrict__ nseq_a, const int32_t* __restrict__ rep0,
    const int32_t* __restrict__ ck_bits, const int32_t* __restrict__ ck_states,
    const int32_t* __restrict__ ck_rep, int32_t* __restrict__ o_ll, int32_t* __restrict__ o_ml,
    int32_t* __restrict__ o_off, int S, int K, int stride, int NC, int max_seqs) {
  __shared__ int s_tab[3 * SEQ_TSIZE];
  const int b = blockIdx.x;
  for (int i = threadIdx.x; i < 3 * SEQ_TSIZE; i += blockDim.x)
    s_tab[i] = tables[(long long)b * 3 * SEQ_TSIZE + i];
  __syncthreads();
  const int* t_ll = s_tab;
  const int* t_of = s_tab + SEQ_TSIZE;
  const int* t_ml = s_tab + 2 * SEQ_TSIZE;
  const int nseq = nseq_a[b];
  const long long out0 = (long long)b * max_seqs;

  for (int c = threadIdx.x; c < NC; c += blockDim.x) {
    const long long j0 = (long long)c * stride;
    const int nloc = (int)min((long long)stride, (long long)nseq - j0);
    if (nloc <= 0) continue;
    BackBits br;
    br.init(streams + (long long)b * S, S);
    long long bp = tbits[b];
    int s_ll = br.read(bp, table_log[3 * b + 0]);
    bp -= table_log[3 * b + 0];
    int s_of = br.read(bp, table_log[3 * b + 1]);
    bp -= table_log[3 * b + 1];
    int s_ml = br.read(bp, table_log[3 * b + 2]);
    bp -= table_log[3 * b + 2];
    int r0 = rep0[3 * b], r1 = rep0[3 * b + 1], r2 = rep0[3 * b + 2];
    if (c > 0) {  // a chunk without a record starts from zeros, as the plain version's padding
      const bool has = c <= K;
      const long long k = (long long)b * K + c - 1;
      const int st = has ? ck_states[k] : 0;
      bp = has ? ck_bits[k] : 0;
      s_ll = st & 0x3FF;
      s_of = (st >> 10) & 0x3FF;
      s_ml = (st >> 20) & 0x3FF;
      r0 = has ? ck_rep[3 * k] : 1;
      r1 = has ? ck_rep[3 * k + 1] : 1;
      r2 = has ? ck_rep[3 * k + 2] : 1;
    }
    for (int t = 0; t < nloc; ++t) {
      const long long j = j0 + t;
      const int p_ll = t_ll[s_ll & (SEQ_TSIZE - 1)];
      const int p_of = t_of[s_of & (SEQ_TSIZE - 1)];
      const int p_ml = t_ml[s_ml & (SEQ_TSIZE - 1)];
      const int ofc = p_of & 0xFF;
      const int llc = min(p_ll & 0xFF, 35);
      const int mlc = min(p_ml & 0xFF, 52);
      const unsigned int ofx = br.read(bp, ofc);
      bp -= ofc;
      const long long ofv = ofc > 0 ? (1LL << min(ofc, 30)) + ofx : 1;
      const int mlx = br.read(bp, c_ml_bits[mlc]);
      bp -= c_ml_bits[mlc];
      const int ml = c_ml_base[mlc] + mlx;
      const int llx = br.read(bp, c_ll_bits[llc]);
      bp -= c_ll_bits[llc];
      const int ll = c_ll_base[llc] + llx;
      // Repcode resolution (RFC 8878 §3.1.1.5).
      const long long idx = ofv - 1 + (ll == 0);
      int off, n1, n2;
      if (ofv > 3) {
        off = (int)(ofv - 3);
        n1 = r0;
        n2 = r1;
      } else {
        off = idx == 0 ? r0 : idx == 1 ? r1 : idx == 2 ? r2 : max(r0 - 1, 1);
        n1 = idx == 0 ? r1 : r0;
        n2 = idx <= 1 ? r2 : r1;
      }
      r0 = off;
      r1 = n1;
      r2 = n2;
      if (j < nseq - 1) {  // state updates: LL, ML, OF
        const int nb_ll = (p_ll >> 8) & 0xFF, nb_ml = (p_ml >> 8) & 0xFF, nb_of = (p_of >> 8) & 0xFF;
        s_ll = (p_ll >> 16) + (int)br.read(bp, nb_ll);
        bp -= nb_ll;
        s_ml = (p_ml >> 16) + (int)br.read(bp, nb_ml);
        bp -= nb_ml;
        s_of = (p_of >> 16) + (int)br.read(bp, nb_of);
        bp -= nb_of;
      }
      if (j < max_seqs) {
        o_ll[out0 + j] = ll;
        o_ml[out0 + j] = ml;
        o_off[out0 + j] = off;
      }
    }
  }
}

extern "C" int tz_decode_sequences(const void* streams, const void* tbits, const void* tables,
                                   const void* table_log, const void* nseq, const void* rep0,
                                   const void* ck_bits, const void* ck_states,
                                   const void* ck_rep, void* ll, void* ml, void* off, int B,
                                   int S, int K, int stride, int NC, int max_seqs, int threads,
                                   cudaStream_t stream) {
  if (B <= 0 || S <= 0 || K <= 0 || stride <= 0 || NC <= 0 || max_seqs <= 0 || threads <= 0 ||
      threads > 1024)
    return (int)cudaErrorInvalidValue;
  decode_sequences_kernel<<<B, threads, 0, stream>>>(
      (const uint8_t*)streams, (const int32_t*)tbits, (const int32_t*)tables,
      (const int32_t*)table_log, (const int32_t*)nseq, (const int32_t*)rep0,
      (const int32_t*)ck_bits, (const int32_t*)ck_states, (const int32_t*)ck_rep, (int32_t*)ll,
      (int32_t*)ml, (int32_t*)off, S, K, stride, NC, max_seqs);
  return (int)cudaGetLastError();
}
