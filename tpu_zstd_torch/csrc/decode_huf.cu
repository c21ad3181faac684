// K6: chunk-parallel 4-stream Huffman literal decode (RFC 8878 §4.2.2).
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_decode.py
// `decode_huffman_lanes` (semantics of tpu_zstd/ops/decode_jax.py
// `decode_huffman_device`). A block's literals are 4 backward Huffman
// streams; the encoder publishes, per stream, the unread-bit cursor before
// every `stride`-th forward symbol (format/accel.py), so each chunk of
// `stride` symbols decodes independently: peek table_log bits (zero-padded
// past the stream start), look up the packed (symbol << 4 | nb_bits) entry,
// consume nb_bits. Chunk c starts at the stream's data end for c = 0, at
// record c-1 for c <= K, else at 0, and decodes min(stride, nsym - c stride)
// symbols.
//
// Bound: bytes on paper (streams read once, symbols written once). A chunk
// walked by one thread is bound instead by its chain of `stride` dependent
// table lookups, each behind a bit refill; from device memory that is
// ~330 ns a symbol on an H100, and one thread a chunk leaves most SMs idle.
//
// Design: one warp per (stream, chunk), 8 chunks of one block per CTA
// sharing the block's table (16-bit entries) in shared memory.
//   - The warp stages its chunk's stream words in shared memory with
//     coalesced 16-byte loads: from the chunk's start down to its end
//     estimate (record c for a chunk before the stream's last, else byte 0),
//     bytes outside the stream as zeros. The bit reader refills a 64-bit
//     container from two staged words; a refill outside the staged words
//     (a corrupt record, or the tail below) reads device memory instead, so
//     every read is exact. The end estimate only places the lanes' starts
//     and sizes the staging; it never stops the decode.
//   - Self-synchronising sub-spans with an exact fix-up (Weissenberger and
//     Schmidt, ICPP 2018): lane k starts at bit S - k L / 32 of the chunk's
//     span L, lane 0 at the true start S, and walks while its cursor is
//     above the next lane's start, marking every cursor it decodes from in a
//     bitmap of the span. Fix-up rounds: a lane whose entry cursor (the
//     previous lane's exit) changed re-walks from it until it lands on a
//     marked cursor of its own sub-span; from there its speculative walk is
//     right, so its exit stands and its symbol count is the re-walked steps
//     plus the speculative walk's steps from that cursor (a popcount). A lane
//     that never meets passes on its re-walk's exit. Rounds end when no
//     entry changed; lane k is exact after k rounds, so this is exact on
//     every input. Huffman codes usually resynchronise within a few symbols,
//     so one or two rounds of a few steps suffice; a table of equal code
//     lengths whose lane starts fall off the code grid never meets, and then
//     the rounds walk the chunk in series.
//   - A warp prefix sum of the true counts places each lane's symbols; every
//     lane re-decodes its sub-span from its true entry into the chunk's
//     output staged in shared memory (the bitmap's space), capped at the
//     chunk's n symbols. If the lanes end short of n (a record that is not
//     the true end), lane 0 decodes the rest from the last lane's exit.
//     The warp then writes the whole chunk, zeros past n, as 16-byte stores.
// Every step consumes at least one bit, so a lane's walks stay within its
// sub-span; an entry with nb_bits 0 stops a walk with a count that stands
// for "at least n", so corrupt tables terminate too.
// Optional stats (6 int32 per chunk): lanes whose true walk met their
// speculative walk, the symbols they re-walked before meeting, lanes that
// never met, fix-up rounds, symbols re-walked in all rounds, symbols the
// tail decoded in series.
#include <cuda_runtime.h>
#include <stdint.h>

#define HUF_TSIZE 2048
#define HUF_MAX_TL 11
#define HUF_WARPS 8           // chunks (warps) per CTA
#define HUF_STAGE_WORDS 384   // staged stream words a warp: 1024 symbols of 11 bits + margins
#define HUF_MAP_WORDS 360     // visited-cursor bitmap a warp; reused as the output staging
#define HUF_MAP_BITS (HUF_MAP_WORDS * 32)
#define HUF_OUT_BYTES (HUF_MAP_WORDS * 4)
#define HUF_BIG (1 << 24)     // a count that stands for "at least n"
#define HUF_CUR_MAX (1 << 30)
#define HUF_MAX_ROUNDS 64     // lane k is exact after k rounds; a guard only
#define HUF_STATS 6
#define FULL_MASK 0xffffffffu

// Backward bit reader over a chunk's staged words, with device memory
// (bytes outside [0, nbytes) read as zeros) outside them.
struct ChunkBits {
  const uint32_t* sw;  // sw[i] is stream word wlo + i
  int wlo, whi;
  const uint8_t* g;
  int nbytes;
  unsigned long long cont;
  int cb;  // stream bit of the container's bit 0

  __device__ uint32_t word(int w) const {
    if (w >= wlo && w < whi) return sw[w - wlo];
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long p = 4LL * w + k;
      if (p >= 0 && p < nbytes) v |= (uint32_t)__ldg(g + p) << (8 * k);
    }
    return v;
  }
  // Afterwards bits [bp - 33, bp) at least are in the container.
  __device__ void refill(int bp) {
    const int wi = ((bp - 1) >> 5) - 1;
    cont = (unsigned long long)word(wi) | ((unsigned long long)word(wi + 1) << 32);
    cb = wi * 32;
  }
  // Bits [bp - n, bp), n <= 11.
  __device__ __forceinline__ unsigned peek(int bp, int n) {
    if (bp - n < cb || bp > cb + 64) refill(bp);
    return (unsigned)(cont >> (bp - n - cb)) & ((1u << n) - 1);
  }
};

__device__ __forceinline__ int clamp_cursor(long long v) {
  return (int)(v < -16 ? -16 : (v > HUF_CUR_MAX ? HUF_CUR_MAX : v));
}

// Set bits of map with index in [a, b).
__device__ int popc_range(const uint32_t* map, int a, int b) {
  int n = 0;
  for (int w = a >> 5; w <= (b - 1) >> 5 && a < b; ++w) {
    uint32_t m = map[w];
    if (w == a >> 5) m &= ~0u << (a & 31);
    if (w == (b - 1) >> 5 && (b & 31)) m &= (1u << (b & 31)) - 1;
    n += __popc(m);
  }
  return n;
}

// The warp copies len bytes of src (shared, 16-byte aligned) to dst.
__device__ void warp_store(uint8_t* dst, const uint8_t* src, int len, int lane) {
  int done = 0;
  if (((uintptr_t)dst & 15) == 0) {
    done = len & ~15;
    for (int i = lane; i < len >> 4; i += 32) ((uint4*)dst)[i] = ((const uint4*)src)[i];
  }
  for (int i = done + lane; i < len; i += 32) dst[i] = src[i];
}

__global__ void __launch_bounds__(HUF_WARPS * 32)
decode_huffman_kernel(const uint8_t* __restrict__ streams, const int32_t* __restrict__ tbits,
                      const int32_t* __restrict__ dtable, const int32_t* __restrict__ table_log,
                      const int32_t* __restrict__ nsym, const int32_t* __restrict__ ck,
                      uint8_t* __restrict__ out, int32_t* __restrict__ stats, int SW, int K,
                      int stride, int NC) {
  __shared__ uint16_t s_tab[HUF_TSIZE];
  __shared__ __align__(16) uint32_t s_stage[HUF_WARPS][HUF_STAGE_WORDS];
  __shared__ __align__(16) uint32_t s_map[HUF_WARPS][HUF_MAP_WORDS];
  const int b = blockIdx.x;
  const int tl = min(max(table_log[b], 0), HUF_MAX_TL);
  for (int i = threadIdx.x; i < (1 << tl); i += blockDim.x)
    s_tab[i] = (uint16_t)(dtable[(long long)b * HUF_TSIZE + i] & 0xFFF);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t = blockIdx.y * (blockDim.x >> 5) + warp;
  if (t >= 4 * NC) return;
  const long long row = 4LL * b + t / NC;
  const int c = t % NC;
  uint8_t* gout = out + row * NC * (long long)stride + (long long)c * stride;
  const long long rem = (long long)nsym[row] - (long long)c * stride;
  const int n = rem <= 0 ? 0 : (rem < stride ? (int)rem : stride);
  int32_t* st = stats ? stats + (row * NC + c) * HUF_STATS : nullptr;
  uint32_t* map = s_map[warp];
  uint8_t* ob = (uint8_t*)map;
  const int nstage = min(stride, HUF_OUT_BYTES);
  if (n == 0) {
    for (int i = lane; i < (nstage + 15) >> 4; i += 32) ((uint4*)ob)[i] = make_uint4(0, 0, 0, 0);
    __syncwarp();
    warp_store(gout, ob, nstage, lane);
    for (int i = nstage + lane; i < stride; i += 32) gout[i] = 0;
    if (st && lane < HUF_STATS) st[lane] = 0;
    return;
  }
  const int32_t* ckr = ck + row * K;
  const int S = clamp_cursor(c == 0 ? tbits[row] : (c <= K ? ckr[c - 1] : 0));
  const bool last = rem <= stride;
  const int E = clamp_cursor(last ? 0 : (c < K ? ckr[c] : 0));
  const uint8_t* srow = streams + row * SW;

  // Stage words [wlo, whi): every refill of a walk above E reads inside.
  int whi = (((S - 1) >> 5) + 2 + 3) & ~3;
  int wlo = ((min(E, S) >> 5) - 2) & ~3;
  if (whi - wlo > HUF_STAGE_WORDS) wlo = whi - HUF_STAGE_WORDS;
  uint32_t* sw = s_stage[warp];
  for (int i = lane; i < (whi - wlo) >> 2; i += 32) {
    const long long bo = 4LL * (wlo + 4 * i);
    uint4 v;
    if (bo >= 0 && bo + 16 <= SW && (((uintptr_t)(srow + bo)) & 15) == 0) {
      v = __ldg((const uint4*)(srow + bo));
    } else {
      uint32_t w4[4] = {0, 0, 0, 0};
      for (int k = 0; k < 16; ++k)
        if (bo + k >= 0 && bo + k < SW) w4[k >> 2] |= (uint32_t)srow[bo + k] << (8 * (k & 3));
      v = make_uint4(w4[0], w4[1], w4[2], w4[3]);
    }
    ((uint4*)sw)[i] = v;
  }
  // The lanes split the span [E, S); a span the bitmap cannot hold (only a
  // corrupt record or a stride far above 1024) is decoded by the tail alone.
  int L = max(S - E, 0);
  if (L > HUF_MAP_BITS - 64) L = 0;
  const int map_words = min(HUF_MAP_WORDS, (L >> 5) + 2);
  for (int i = lane; i < map_words; i += 32) map[i] = 0;
  __syncwarp();

  ChunkBits rd;
  rd.sw = sw;
  rd.wlo = wlo;
  rd.whi = whi;
  rd.g = srow;
  rd.nbytes = SW;
  rd.cont = 0;
  rd.cb = HUF_CUR_MAX + 64;  // the first peek refills
  const int hi = S - (int)(((long long)L * lane) >> 5);
  const int lo = S - (int)(((long long)L * (lane + 1)) >> 5);

  // Speculative walk of the lane's sub-span (hi, lo], marking its cursors.
  int y = hi, cnt = 0;
  while (y > lo) {
    const int idx = S - y;
    atomicOr(&map[idx >> 5], 1u << (idx & 31));
    const int nb = s_tab[rd.peek(y, tl)] & 15;
    if (nb == 0) {
      cnt = HUF_BIG;
      break;
    }
    y -= nb;
    ++cnt;
  }
  const int cnt_spec = cnt, ex_spec = y;
  __syncwarp();

  // Fix-up rounds.
  int entry = hi, ex = ex_spec, count = cnt_spec;
  bool met = true;
  int met_steps = 0, fix_steps = 0, rounds = 0;
  for (; rounds < HUF_MAX_ROUNDS; ++rounds) {
    int ne = __shfl_up_sync(FULL_MASK, ex, 1);
    if (lane == 0) ne = S;
    const bool ch = ne != entry;
    if (!__any_sync(FULL_MASK, ch)) break;
    if (!ch) continue;
    entry = ne;
    int yy = ne, p = 0, state = 0, midx = 0;  // state: 0 left the sub-span, 1 met, 2 stuck
    while (yy > lo) {
      if (yy <= hi) {
        const int idx = S - yy;
        if ((map[idx >> 5] >> (idx & 31)) & 1) {
          state = 1;
          midx = idx;
          break;
        }
      }
      const int nb = s_tab[rd.peek(yy, tl)] & 15;
      if (nb == 0) {
        state = 2;
        break;
      }
      yy -= nb;
      ++p;
    }
    fix_steps += p;
    met = state == 1;
    if (met) {
      met_steps = p;
      count = p + cnt_spec - popc_range(map, S - hi, midx);
      ex = ex_spec;
    } else {
      count = state == 2 ? HUF_BIG : p;
      ex = yy;
    }
  }

  // Each lane's first output position; the symbols the lanes cover.
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(FULL_MASK, incl, o);
    if (lane >= o) incl += u;
  }
  const int T = __shfl_sync(FULL_MASK, incl, 31);
  const int ex_last = __shfl_sync(FULL_MASK, ex, 31);
  if (st) {
    const bool span = lane > 0 && hi > lo;
    const int m = __reduce_add_sync(FULL_MASK, span && met);
    const int ms = __reduce_add_sync(FULL_MASK, span && met ? met_steps : 0);
    const int um = __reduce_add_sync(FULL_MASK, span && !met);
    const int fs = __reduce_add_sync(FULL_MASK, fix_steps);
    if (lane == 0) {
      st[0] = m;
      st[1] = ms;
      st[2] = um;
      st[3] = rounds;
      st[4] = fs;
      st[5] = T < n ? n - T : 0;
    }
  }
  __syncwarp();
  for (int i = lane; i < (nstage + 15) >> 4; i += 32) ((uint4*)ob)[i] = make_uint4(0, 0, 0, 0);
  __syncwarp();

  // Decode each sub-span from its true entry into the staged output.
  {
    int yy = entry, pos = incl - count;
    while (pos < n && yy > lo) {
      const unsigned e = s_tab[rd.peek(yy, tl)];
      if (pos < HUF_OUT_BYTES) ob[pos] = (uint8_t)(e >> 4);
      else gout[pos] = (uint8_t)(e >> 4);
      yy -= e & 15;
      ++pos;
    }
  }
  if (lane == 0 && T < n) {  // the lanes ended short of n: the rest in series
    int yy = ex_last;
    for (int pos = T; pos < n; ++pos) {
      const unsigned e = s_tab[rd.peek(yy, tl)];
      if (pos < HUF_OUT_BYTES) ob[pos] = (uint8_t)(e >> 4);
      else gout[pos] = (uint8_t)(e >> 4);
      yy -= e & 15;
    }
  }
  __syncwarp();
  warp_store(gout, ob, nstage, lane);
  for (int i = nstage + lane; i < stride; i += 32)
    if (i >= n) gout[i] = 0;
}

extern "C" int tz_decode_huffman(const void* streams, const void* tbits, const void* dtable,
                                 const void* table_log, const void* nsym, const void* ck,
                                 void* out, void* stats, int B, int SW, int K, int stride, int NC,
                                 cudaStream_t stream) {
  if (B <= 0 || SW <= 0 || SW >= (1 << 26) || K <= 0 || stride <= 0 || NC <= 0 ||
      4LL * NC > 65535LL * HUF_WARPS)
    return (int)cudaErrorInvalidValue;
  const int warps = 4 * NC < HUF_WARPS ? 4 * NC : HUF_WARPS;
  const dim3 grid(B, (4 * NC + warps - 1) / warps);
  decode_huffman_kernel<<<grid, 32 * warps, 0, stream>>>(
      (const uint8_t*)streams, (const int32_t*)tbits, (const int32_t*)dtable,
      (const int32_t*)table_log, (const int32_t*)nsym, (const int32_t*)ck, (uint8_t*)out,
      (int32_t*)stats, SW, K, stride, NC);
  return (int)cudaGetLastError();
}
