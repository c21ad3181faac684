// K7: chunk-parallel FSE sequence decode (RFC 8878 §3.1.1.3.2, §3.1.1.5).
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_decode.py
// `decode_sequences_lanes` (semantics of tpu_zstd/ops/decode_jax.py
// `_decode_seqs_core`). A block's sequences are one backward bitstream
// read by three interleaved FSE states (LL, OF, ML). Decode-acceleration
// frames publish, every `stride` sequences, the unread-bit cursor, the
// three states (ll | of<<10 | ml<<20) and the repeat-offset triple
// (format/accel.py), so each chunk of `stride` sequences decodes
// independently. Per sequence: look the three states up, read the OF extra
// bits, then the ML and LL extra bits, resolve the offset against the rep
// triple, then (except after the block's last sequence) read the LL, ML and
// OF state bits. Chunk 0 reads its states from the stream head and starts
// from the caller's rep triple; chunk c >= 1 starts from record c-1, or
// from zeros (rep 1, 1, 1) where the block has no such record.
//
// Bound: bytes on paper (stream read once, ll/ml/off written once), but a
// chunk is a chain of `stride` dependent steps, each a table lookup behind
// the bits the previous step read: the chain, not the bytes, sets the time.
// One thread a chunk that refilled from device memory spent ~1,900 cycles a
// step and put one CTA on each block (64 of 132 SMs busy).
//
// Design:
//   - The grid runs over (block, group of `cpc` consecutive chunks), one
//     thread a chunk, so a 64-block launch spreads over every SM. A CTA
//     converts the block's three <= 512-state tables into shared memory as
//     8-byte entries: (LL/ML baseline | extra bits << 24, or the OF code)
//     and (nb_bits | new_state << 8), so a step takes no constant-memory
//     lookup at a per-lane index.
//   - It stages the stream words its chunks read in shared memory with
//     16-byte loads: from the group's first chunk's start down to the start
//     of the chunk after its last (0 for a block's last chunk), a margin
//     beside, at most `stage_words` words (the top ones). No record is
//     trusted as a bound: a read outside the staged words reads device
//     memory, and bits outside the row read as zeros, so every read is
//     exact whatever the records hold.
//   - A read of n <= 32 bits below the cursor joins the two aligned words
//     that hold them with `__funnelshift_r`: no refill branch of its own.
//     Three reads a step: the OF extra bits (<= 31), the ML and LL extra
//     bits together (<= 32), and the three state updates together (<= 27),
//     as the TPU kernel's combined refill (pallas_decode.py:342-351).
//   - Offsets and the rep triple wrap as int32, as the JAX package computes
//     them; the cursor is int32 (a start below -2^30 reads as -2^30: every
//     bit below 0 reads as zero anyway).
//   - Each thread keeps 4 consecutive sequences' ll, ml and off in
//     registers and writes each array with one 16-byte store (where
//     max_seqs and stride are multiples of 4); the CTA writes the zeros of
//     its share of [live end, max_seqs) with the same stores, so the
//     wrapper allocates its outputs with torch.empty.
//   - Optional: rep_fin (B, 3) receives the rep triple after the block's
//     last sequence (the chunk that holds it writes it; the caller's triple
//     when nseq is 0); stats (B * num_chunks, 2) per chunk the reads the
//     staged words did not serve and the steps walked.
// One chunk per block (cpc 1) is the serial decode of frames without
// checkpoints: one thread decodes, the CTA stages.
#include <cuda_runtime.h>
#include <stdint.h>

#define SEQ_TSIZE 512
#define SEQ_THREADS 128  // a CTA: the first cpc threads decode, all stage and zero-fill
#define SEQ_MARGIN 4     // staged words beyond each end of a group's span
#define SEQ_STATS 2
#define SEQ_CUR_MIN (-(1 << 30))

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

// Backward reader over a row's words: staged words in shared memory, the
// rest from device memory, zeros outside the row.
struct StagedBits {
  const uint32_t* sw;  // sw[i] is word wlo + i
  int wlo, nst;
  const uint32_t* g;   // the row's words in device memory
  int nw;
  int miss;            // reads of a word the staged span did not hold

  __device__ __forceinline__ uint32_t word(int w) {
    const unsigned r = (unsigned)(w - wlo);
    if (r < (unsigned)nst) return sw[r];
    ++miss;
    return (unsigned)w < (unsigned)nw ? __ldg(g + w) : 0u;
  }
  // Bits [bp - n, bp) for 0 <= n <= 32; the cursor moves down by n.
  __device__ __forceinline__ uint32_t read(int& bp, int n) {
    const int p = bp - n;
    bp = p;
    const int w = p >> 5;  // floor: negative below the row
    const uint32_t v = __funnelshift_r(word(w), word(w + 1), (unsigned)p & 31u);
    return n >= 32 ? v : v & ((1u << n) - 1u);
  }
};

__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }

__device__ __forceinline__ int tl_bits(int tl) { return tl < 0 ? 0 : (tl > 32 ? 32 : tl); }

// Zeros to three int32 rows over [lo, hi), all threads of the CTA; 16-byte
// stores over the 4-aligned middle when VEC (rows 16-byte aligned).
template <bool VEC>
__device__ void zero_rows(int32_t* a, int32_t* b, int32_t* c, long long lo, long long hi) {
  if (lo >= hi) return;
  long long mid = lo, end = hi;
  if (VEC) {
    mid = (lo + 3) & ~3LL;
    end = mid < hi ? mid + ((hi - mid) & ~3LL) : mid;
    const int4 z = make_int4(0, 0, 0, 0);
    for (long long i = mid + 4LL * threadIdx.x; i < end; i += 4LL * blockDim.x) {
      *reinterpret_cast<int4*>(a + i) = z;
      *reinterpret_cast<int4*>(b + i) = z;
      *reinterpret_cast<int4*>(c + i) = z;
    }
    for (long long i = end + threadIdx.x; i < hi; i += blockDim.x) a[i] = b[i] = c[i] = 0;
    end = min(mid, hi);
  }
  for (long long i = lo + threadIdx.x; i < end; i += blockDim.x) a[i] = b[i] = c[i] = 0;
}

template <bool VEC>
__global__ void __launch_bounds__(SEQ_THREADS)
decode_sequences_kernel(const uint8_t* __restrict__ streams, const int32_t* __restrict__ tbits,
                        const int32_t* __restrict__ tables, const int32_t* __restrict__ table_log,
                        const int32_t* __restrict__ nseq_a, const int32_t* __restrict__ rep0,
                        const int32_t* __restrict__ ck_bits, const int32_t* __restrict__ ck_states,
                        const int32_t* __restrict__ ck_rep, int32_t* __restrict__ o_ll,
                        int32_t* __restrict__ o_ml, int32_t* __restrict__ o_off,
                        int32_t* __restrict__ rep_fin, int32_t* __restrict__ stats, int S, int K,
                        int stride, int NC, int max_seqs, int cpc, int G, int stage_words) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint2* s_tab = reinterpret_cast<uint2*>(smem);  // LL, OF, ML: SEQ_TSIZE entries each
  uint32_t* s_words = smem + 2 * 3 * SEQ_TSIZE;
  const int b = blockIdx.x / G;
  const int g = blockIdx.x - b * G;
  const int c0 = g * cpc;
  const int c1 = min(c0 + cpc, NC);
  const int nseq = nseq_a[b];
  const int nw = S >> 2;
  const uint32_t* gw = reinterpret_cast<const uint32_t*>(streams + (long long)b * S);

  // Where the group's chunks read: from the first one's start down to the
  // start of the chunk after the last (0 after a block's last chunk).
  const long long kb = (long long)b * K;
  const int hi_bit = c0 == 0 ? tbits[b] : (c0 <= K ? ck_bits[kb + c0 - 1] : 0);
  const bool next_live = c1 < NC && (long long)c1 * stride < nseq && c1 <= K;
  const int lo_bit = next_live ? ck_bits[kb + c1 - 1] : 0;
  int whi = min(nw, max(0, (hi_bit >> 5) + 1 + SEQ_MARGIN));
  whi = (whi + 3) & ~3;  // nw is a multiple of 4
  int wlo = min(whi, max(0, (lo_bit >> 5) - SEQ_MARGIN)) & ~3;
  wlo = max(wlo, whi - stage_words);
  const int nst = whi - wlo;
  {
    const uint4* src = reinterpret_cast<const uint4*>(gw + wlo);
    uint4* dst = reinterpret_cast<uint4*>(s_words);
    for (int i = threadIdx.x; i < (nst >> 2); i += blockDim.x) dst[i] = __ldg(src + i);
  }
  for (int i = threadIdx.x; i < 3 * SEQ_TSIZE; i += blockDim.x) {
    const int e = tables[(long long)b * 3 * SEQ_TSIZE + i];
    const int sym = e & 0xFF;
    const int t = i / SEQ_TSIZE;  // 0 LL, 1 OF, 2 ML
    uint32_t x;
    if (t == 0) {
      const int code = min(sym, 35);
      x = (uint32_t)c_ll_base[code] | ((uint32_t)c_ll_bits[code] << 24);
    } else if (t == 1) {
      x = (uint32_t)min(sym, 31);
    } else {
      const int code = min(sym, 52);
      x = (uint32_t)c_ml_base[code] | ((uint32_t)c_ml_bits[code] << 24);
    }
    s_tab[i] = make_uint2(x, ((uint32_t)(e >> 8) & 0xFFu) | (((uint32_t)e >> 16) << 8));
  }
  // This CTA's share of the zeros in [min(nseq, NC * stride), max_seqs).
  const long long row = (long long)b * max_seqs;
  const long long live_end = max(0LL, min((long long)nseq, (long long)NC * stride));
  const long long zlo = max(live_end, (long long)c0 * stride);
  const long long zhi = g == G - 1 ? (long long)max_seqs
                                   : min((long long)c1 * stride, (long long)max_seqs);
  zero_rows<VEC>(o_ll + row, o_ml + row, o_off + row, zlo, zhi);
  __syncthreads();

  if (threadIdx.x >= c1 - c0) return;
  const int c = c0 + threadIdx.x;
  const long long j0 = (long long)c * stride;
  const int nloc = (int)max(0LL, min((long long)stride, (long long)nseq - j0));
  StagedBits br{s_words, wlo, nst, gw, nw, 0};
  int bp, s_ll, s_of, s_ml, r0, r1, r2;
  if (c == 0) {
    bp = max(tbits[b], SEQ_CUR_MIN);
    s_ll = (int)br.read(bp, tl_bits(table_log[3 * b + 0]));
    s_of = (int)br.read(bp, tl_bits(table_log[3 * b + 1]));
    s_ml = (int)br.read(bp, tl_bits(table_log[3 * b + 2]));
    r0 = rep0[3 * b];
    r1 = rep0[3 * b + 1];
    r2 = rep0[3 * b + 2];
  } else {
    const bool has = c <= K;
    const long long k = kb + c - 1;
    const int st = has ? ck_states[k] : 0;
    bp = has ? max(ck_bits[k], SEQ_CUR_MIN) : 0;
    s_ll = st & 0x3FF;
    s_of = (st >> 10) & 0x3FF;
    s_ml = (st >> 20) & 0x3FF;
    r0 = has ? ck_rep[3 * k] : 1;
    r1 = has ? ck_rep[3 * k + 1] : 1;
    r2 = has ? ck_rep[3 * k + 2] : 1;
  }
  int32_t* ol = o_ll + row;
  int32_t* om = o_ml + row;
  int32_t* oo = o_off + row;
  const long long last = (long long)nseq - 1;
  for (int t = 0; t < nloc; t += 4) {
    int v_ll[4], v_ml[4], v_off[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      v_ll[u] = v_ml[u] = v_off[u] = 0;
      if (t + u < nloc) {
        const uint2 e_ll = s_tab[s_ll & (SEQ_TSIZE - 1)];
        const uint2 e_of = s_tab[SEQ_TSIZE + (s_of & (SEQ_TSIZE - 1))];
        const uint2 e_ml = s_tab[2 * SEQ_TSIZE + (s_ml & (SEQ_TSIZE - 1))];
        const int ofc = (int)e_of.x;
        const uint32_t ofx = br.read(bp, ofc);
        const int ofv = ofc > 0 ? (int)((1u << min(ofc, 30)) + ofx) : 1;
        const int nb_l = (int)(e_ll.x >> 24);
        const uint32_t x = br.read(bp, (int)(e_ml.x >> 24) + nb_l);  // ML bits above LL bits
        const int ml = (int)(e_ml.x & 0xFFFFFFu) + (int)(x >> nb_l);
        const int ll = (int)(e_ll.x & 0xFFFFFFu) + (int)(x & ((1u << nb_l) - 1u));
        // Repcode resolution (RFC 8878 §3.1.1.5), int32 as the JAX package.
        const int idx = wrap_add(ofv, (ll == 0) - 1);
        int off, n1, n2;
        if (ofv > 3) {
          off = wrap_add(ofv, -3);
          n1 = r0;
          n2 = r1;
        } else {
          off = idx == 0 ? r0 : idx == 1 ? r1 : idx == 2 ? r2 : max(wrap_add(r0, -1), 1);
          n1 = idx == 0 ? r1 : r0;
          n2 = idx <= 1 ? r2 : r1;
        }
        r0 = off;
        r1 = n1;
        r2 = n2;
        // State bits LL, ML, OF in one read; none after the block's last sequence.
        const uint32_t nbl = e_ll.y & 0xFFu, nbm = e_ml.y & 0xFFu, nbo = e_of.y & 0xFFu;
        const bool upd = j0 + t + u < last;
        const uint32_t v = br.read(bp, upd ? (int)(nbl + nbm + nbo) : 0);
        s_ll = (int)(e_ll.y >> 8) + (int)(v >> (nbm + nbo));
        s_ml = (int)(e_ml.y >> 8) + (int)((v >> nbo) & ((1u << nbm) - 1u));
        s_of = (int)(e_of.y >> 8) + (int)(v & ((1u << nbo) - 1u));
        v_ll[u] = ll;
        v_ml[u] = ml;
        v_off[u] = off;
      }
    }
    const long long j = j0 + t;
    if (j >= max_seqs) continue;  // decoded for the rep triple only
    if (VEC && t + 4 <= nloc) {
      *reinterpret_cast<int4*>(ol + j) = make_int4(v_ll[0], v_ll[1], v_ll[2], v_ll[3]);
      *reinterpret_cast<int4*>(om + j) = make_int4(v_ml[0], v_ml[1], v_ml[2], v_ml[3]);
      *reinterpret_cast<int4*>(oo + j) = make_int4(v_off[0], v_off[1], v_off[2], v_off[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (t + u < nloc && j + u < max_seqs) {
          ol[j + u] = v_ll[u];
          om[j + u] = v_ml[u];
          oo[j + u] = v_off[u];
        }
      }
    }
  }
  const long long cl = min((long long)NC - 1, max(0LL, last) / stride);
  if (rep_fin != nullptr && c == cl) {
    rep_fin[3 * b] = r0;
    rep_fin[3 * b + 1] = r1;
    rep_fin[3 * b + 2] = r2;
  }
  if (stats != nullptr) {
    stats[((long long)b * NC + c) * SEQ_STATS] = br.miss;
    stats[((long long)b * NC + c) * SEQ_STATS + 1] = nloc;
  }
}

template <bool VEC>
static int launch_seq(const void* streams, const void* tbits, const void* tables,
                      const void* table_log, const void* nseq, const void* rep0,
                      const void* ck_bits, const void* ck_states, const void* ck_rep, void* ll,
                      void* ml, void* off, void* rep_fin, void* stats, int B, int S, int K,
                      int stride, int NC, int max_seqs, int cpc, int G, int stage_words,
                      cudaStream_t stream) {
  const int smem = (2 * 3 * SEQ_TSIZE + stage_words) * (int)sizeof(uint32_t);
  const cudaError_t err = cudaFuncSetAttribute(
      decode_sequences_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  decode_sequences_kernel<VEC><<<(unsigned)((long long)B * G), SEQ_THREADS, smem, stream>>>(
      (const uint8_t*)streams, (const int32_t*)tbits, (const int32_t*)tables,
      (const int32_t*)table_log, (const int32_t*)nseq, (const int32_t*)rep0,
      (const int32_t*)ck_bits, (const int32_t*)ck_states, (const int32_t*)ck_rep, (int32_t*)ll,
      (int32_t*)ml, (int32_t*)off, (int32_t*)rep_fin, (int32_t*)stats, S, K, stride, NC,
      max_seqs, cpc, G, stage_words);
  return (int)cudaGetLastError();
}

// streams (B, S) uint8 with S a multiple of 16; tables (B, 3, 512) int32
// symbol | nb_bits << 8 | new_state << 16; table_log (B, 3); nseq (B,);
// rep0 (B, 3); ck_bits, ck_states (B, K), ck_rep (B, K, 3) (K may be 0:
// the pointers are then not read); ll, ml, off (B, max_seqs); rep_fin
// (B, 3) and stats (B * NC, 2) or null. cpc chunks a CTA; stage_words a
// multiple of 4.
extern "C" int tz_decode_sequences(const void* streams, const void* tbits, const void* tables,
                                   const void* table_log, const void* nseq, const void* rep0,
                                   const void* ck_bits, const void* ck_states,
                                   const void* ck_rep, void* ll, void* ml, void* off,
                                   void* rep_fin, void* stats, int B, int S, int K, int stride,
                                   int NC, int max_seqs, int cpc, int stage_words,
                                   cudaStream_t stream) {
  if (B <= 0 || S <= 0 || (S & 15) || K < 0 || stride <= 0 || NC <= 0 || max_seqs <= 0 ||
      cpc <= 0 || cpc > SEQ_THREADS || stage_words < 0 || (stage_words & 3) ||
      (2 * 3 * SEQ_TSIZE + stage_words) * 4 > 232448)
    return (int)cudaErrorInvalidValue;
  const int G = (NC + cpc - 1) / cpc;
  if ((long long)B * G > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (max_seqs % 4 == 0 && stride % 4 == 0)
    return launch_seq<true>(streams, tbits, tables, table_log, nseq, rep0, ck_bits, ck_states,
                            ck_rep, ll, ml, off, rep_fin, stats, B, S, K, stride, NC, max_seqs,
                            cpc, G, stage_words, stream);
  return launch_seq<false>(streams, tbits, tables, table_log, nseq, rep0, ck_bits, ck_states,
                           ck_rep, ll, ml, off, rep_fin, stats, B, S, K, stride, NC, max_seqs,
                           cpc, G, stage_words, stream);
}
