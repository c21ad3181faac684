// K5: FSE encoder state chains with per-row (custom) tables.
//
// Replaces the Pallas TPU kernel tpu_zstd/ops/pallas_chain.py
// `state_chain3_pallas` (semantics of tpu_zstd/ops/fse_jax.py
// `_state_chain3_cf`). One row is one FSE stream of one block: the LL, OF or
// ML sequence stream, or one of the two interleaved Huffman-weight streams.
// Per row: a 64-entry state table st, per-symbol dnb / dfs / init (S <= 64
// symbols), the table log, an RLE flag, nseq, and the symbols rsym (msb of
// them, encoder order). The chain starts at init[rsym[0]]; step s consumes
// rsym[s + 1] and is live while s + 1 < nseq:
//
//   value = ts + state;  nb = (value + dnb[sym]) >> 16;
//   state' = st[clamp((value >> clamp(nb, 0, 31)) + dfs[sym], 0, 63)] - ts
//
// in 64-bit integers, as the plain version computes it. Outputs, rolled by
// one so that index t is the transition consuming rsym[t]: pre (state before
// it), nb (its bit count), both defined for 1 <= t < nseq (0 elsewhere here),
// and fin, the state after the last live step (0 on RLE rows).
//
// Design (one CTA per row, or per G <= 4 short rows):
// - The operands are read as the caller holds them (int32 or int64; rle also
//   bool), so a call needs no copies. The row's tables go to shared memory,
//   and from them a transition table T[sym][state] = state' | nb << 6
//   (int16) for the 64 states, so a step is one dependent shared lookup.
//   An entry whose state' leaves [0, 64) or whose
//   nb leaves [0, 511] is -1: a walk that reads one marks its row, and the
//   row is redone at the end by one thread the long way, in 64-bit integers
//   (only tables outside the encoder's contract, st outside [ts, ts + 64) or
//   an init state outside [0, 64), get there).
// - The symbols are staged once, coalesced (16-byte loads of int32 or int64
//   symbols, only up to the live end), as bytes in a step-major layout
//   sym[i * NCP + chunk] with NCP odd, so the threads of a warp reading step
//   i of 32 chunks read 32 neighbouring bytes and the staging stores hit 32
//   distinct banks.
// - One thread walks one 64-step chunk. Pass 1 walks every chunk from the
//   row's init state and records its trajectory (a byte a step, same
//   layout). Each fix-up round re-walks the chunks whose entry (the previous
//   chunk's final) changed, from the new entry, until the walk meets the
//   recorded trajectory at the same step (from there the two are one walk,
//   so the final stands), recording as it goes. After round k the first k + 1
//   chunks are exact; ANS transitions contract, so two or three rounds are
//   usual. A row whose transitions barely contract (a symbol holding nearly
//   all 64 states) would need one round a chunk; after CHAIN_MAP_AFTER rounds
//   the CTA switches to transfer maps instead: every chunk past the exact
//   ones walks all 64 entry states (four chains at once per thread), one
//   thread per row then runs the true entry through the maps chunk by chunk,
//   and the chunks walk once more from their true entries.
// - The output is read from the trajectories: pre[t] = traj[t - 1] and
//   nb[t] = T[sym][pre] >> 6, written as coalesced 16-byte stores.
//
// Bound: bytes (the live symbols read once, pre and nb written once: 67 MB
// of outputs for the 384 x 21760 sequence launch of the bench batch). The
// serial part per row is 64 dependent lookups for pass 1 and a few per
// fix-up round (two or three rounds on the bench rows, at most 7).
//
// stats (optional, (R, 4) int32): per row the passes (pass 1 plus the fix-up
// rounds in which a chunk of the row re-walked), the steps walked in them,
// 1 if the row took the transfer maps, 1 if it took the 64-bit walk.
#include <cuda_runtime.h>
#include <stdint.h>

#define CHAIN_L 64            // steps per chunk (one walker thread each)
#define CHAIN_TS 64           // state-table entries per row
#define CHAIN_SMAX 64         // symbols per row
#define CHAIN_MAX_CHUNKS 512  // msb <= 32768
#define CHAIN_MAX_ROWS 4      // rows per CTA
#define CHAIN_MAP_AFTER 16    // fix-up rounds before the transfer maps
#define CHAIN_THREADS 512
#define CHAIN_STATS 4

struct ChainDims {
  int G, nck, nw, ncp, threads;
  int off_tab, off_t, off_sym, off_traj;  // byte offsets into shared memory
  int smem;
};

__host__ __device__ inline ChainDims chain_dims(int S, int msb) {
  ChainDims d;
  d.nck = msb / CHAIN_L;
  d.G = d.nck >= 64 ? 1 : (64 / d.nck < CHAIN_MAX_ROWS ? 64 / d.nck : CHAIN_MAX_ROWS);
  d.nw = d.G * d.nck;
  d.ncp = d.nw | 1;
  const int t = (d.nw + 31) / 32 * 32;
  d.threads = t < 128 ? 128 : t;
  // int32 region: s_start, s_fin (nw each), 8 per-row scalars x G, the
  // tables (64 + 3S) x G; then T (int16); then the two byte arrays.
  const int n32 = 2 * d.nw + 8 * d.G + (CHAIN_TS + 3 * S) * d.G;
  d.off_tab = (2 * d.nw + 8 * d.G) * 4;
  d.off_t = (n32 * 4 + 15) / 16 * 16;
  d.off_sym = d.off_t + (d.G * S * CHAIN_TS * 2 + 15) / 16 * 16;
  d.off_traj = d.off_sym + (CHAIN_L * d.ncp + 15) / 16 * 16;
  d.smem = d.off_traj + CHAIN_L * d.ncp;
  return d;
}

__device__ __forceinline__ long long add64(long long a, long long b) {
  return (long long)((unsigned long long)a + (unsigned long long)b);
}
__device__ __forceinline__ long long sub64(long long a, long long b) {
  return (long long)((unsigned long long)a - (unsigned long long)b);
}
// 1 << tl as PyTorch computes it on int64: 0 for shifts outside [0, 64).
__device__ __forceinline__ long long ts_of(int tl) {
  return (tl < 0 || tl >= 64) ? 0LL : (long long)(1ULL << tl);
}
// One transition the long way; returns state', sets *nb.
__device__ __forceinline__ long long step64(long long state, long long ts, long long dnb,
                                            long long dfs, const int* st, long long* nb) {
  const long long value = add64(ts, state);
  const long long n = add64(value, dnb) >> 16;
  const int sh = (int)(n < 0 ? 0 : (n > 31 ? 31 : n));
  long long idx = add64(value >> sh, dfs);
  idx = idx < 0 ? 0 : (idx > CHAIN_TS - 1 ? CHAIN_TS - 1 : idx);
  *nb = n;
  return sub64((long long)st[idx], ts);
}

// Operand i of (st, dnb, dfs, init, tl, rle, nseq) has 1, 4 or 8 bytes an
// element (bool, int32, int64), bits 4i..4i+3 of esz; read as int32 as
// PyTorch's .to(torch.int32) converts.
struct ChainOps {
  const void* p[7];
  int esz;
};

__device__ __forceinline__ int chain_ld(const ChainOps& o, int k, int64_t i) {
  const int e = (o.esz >> (4 * k)) & 15;
  if (e == 8) return (int)((const long long*)o.p[k])[i];
  if (e == 4) return ((const int*)o.p[k])[i];
  return ((const unsigned char*)o.p[k])[i];
}

// Walks steps [0, n) of chunk column gc from `state`, recording the state
// before each step in traj; with meet, stops at the first step i > 0 whose
// recorded state equals the walk's (returns i), else returns n. The symbols
// (and recorded states) of 4 steps are read before their stores, so the
// loads stay off the dependent chain of T lookups.
template <bool MEET>
__device__ __forceinline__ int chain_walk(const unsigned char* sym, unsigned char* traj,
                                          const short* T, int ncp, int gc, int n, int& state,
                                          int& bad) {
  for (int i0 = 0; i0 < n; i0 += 4) {
    int sy[4], old[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool in = i0 + e < n;
      sy[e] = in ? sym[(i0 + e) * ncp + gc] << 6 : 0;
      old[e] = MEET && in ? traj[(i0 + e) * ncp + gc] : -1;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + e;
      if (i >= n) return n;
      if (MEET && i > 0 && old[e] == state) return i;  // met the recorded walk
      traj[i * ncp + gc] = (unsigned char)state;
      const int t = T[sy[e] | state];
      bad |= t;
      state = t & (CHAIN_TS - 1);
    }
  }
  return n;
}

template <typename SymT>
__global__ void __launch_bounds__(CHAIN_THREADS, 3)
state_chain3_kernel(const ChainOps ops, const SymT* __restrict__ rsym,
                    int32_t* __restrict__ pre, int32_t* __restrict__ nb_out,
                    int32_t* __restrict__ fin, int32_t* __restrict__ stats, int R, int S,
                    int msb) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ChainDims d = chain_dims(S, msb);
  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * d.G;
  const int G = min(d.G, R - r0);
  const int nck = d.nck, ncp = d.ncp;
  const int TW = CHAIN_TS + 3 * S;  // table words a row: st, dnb, dfs, init

  int* s_start = (int*)smem;
  int* s_fin = s_start + d.nw;
  int* s_live = s_fin + d.nw;    // live steps of each row
  int* s_init = s_live + d.G;    // init[rsym[0]] as given
  int* s_tl = s_init + d.G;
  int* s_rle = s_tl + d.G;
  int* s_bad = s_rle + d.G;
  int* s_pass = s_bad + d.G;
  int* s_steps = s_pass + d.G;
  int* s_map = s_steps + d.G;
  int* s_tab = (int*)(smem + d.off_tab);
  short* s_T = (short*)(smem + d.off_t);
  unsigned char* s_sym = smem + d.off_sym;
  unsigned char* s_traj = smem + d.off_traj;

  // --- tables and per-row scalars ---------------------------------------------------
  for (int j = tid; j < G * TW; j += blockDim.x) {
    const int64_t r = r0 + j / TW;
    const int col = j % TW;
    s_tab[j] = col < CHAIN_TS ? chain_ld(ops, 0, r * CHAIN_TS + col)
                              : chain_ld(ops, 1 + (col - CHAIN_TS) / S,
                                         r * S + (col - CHAIN_TS) % S);
  }
  if (tid < G) {
    const int r = r0 + tid;
    const int rle = chain_ld(ops, 5, r) != 0;
    const long long n = (long long)chain_ld(ops, 6, r) - 1;
    s_live[tid] = rle ? 0 : (int)(n < 0 ? 0 : (n > msb ? msb : n));
    s_tl[tid] = chain_ld(ops, 4, r);
    s_rle[tid] = rle;
    s_bad[tid] = 0;
    s_pass[tid] = 1;
    s_steps[tid] = 0;
    s_map[tid] = 0;
  }
  __syncthreads();
  if (tid < G) {
    const int r = r0 + tid;
    const int sym0 = min(max((int)rsym[(int64_t)r * msb], 0), S - 1);
    const int init = s_tab[tid * TW + CHAIN_TS + 2 * S + sym0];
    s_init[tid] = init;
    if (s_live[tid] > 0 && (init < 0 || init >= CHAIN_TS)) s_bad[tid] = 1;
  }

  // --- the symbols, step-major bytes; only the live ones are read ----------------------
  // Position p holds the symbol that step (p - 1) mod msb consumes.
  const int quads = msb / 4;
  for (int q = tid; q < G * quads; q += blockDim.x) {
    const int g = q / quads;
    const int p0 = (q - g * quads) * 4;
    const int live = s_live[g];
    if (p0 > live) continue;  // every position of the quad is past the live end
    const SymT* src = rsym + (int64_t)(r0 + g) * msb + p0;
    int v[4];
    if (sizeof(SymT) == 4) {
      const int4 x = *(const int4*)src;
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    } else {
      const longlong2 a = *(const longlong2*)src;
      const longlong2 b = *(const longlong2*)(src + 2);
      v[0] = (int)a.x; v[1] = (int)a.y; v[2] = (int)b.x; v[3] = (int)b.y;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = p0 + e == 0 ? msb - 1 : p0 + e - 1;
      const int gc = g * nck + s / CHAIN_L;
      s_sym[(s % CHAIN_L) * ncp + gc] = (unsigned char)min(max(v[e], 0), S - 1);
    }
  }

  // --- T[sym][state] = state' | nb << 6, or -1 ------------------------------------------
  for (int j = tid; j < G * S * CHAIN_TS; j += blockDim.x) {
    const int g = j / (S * CHAIN_TS);
    const int sym = (j / CHAIN_TS) % S;
    const int state = j % CHAIN_TS;
    const int* tb = s_tab + g * TW;
    const long long ts = ts_of(s_tl[g]);
    long long n;
    const long long nxt = step64(state, ts, tb[CHAIN_TS + sym], tb[CHAIN_TS + S + sym], tb, &n);
    s_T[j] = (nxt >= 0 && nxt < CHAIN_TS && n >= 0 && n <= 511) ? (short)(nxt | (n << 6))
                                                                 : (short)-1;
  }
  __syncthreads();

  // --- pass 1: every chunk from the row's init state ------------------------------------
  const bool walker = tid < G * nck;
  const int g = walker ? tid / nck : 0;
  const int c = tid - g * nck;
  const int gc = tid;
  const int live_c = walker ? min(max(s_live[g] - c * CHAIN_L, 0), CHAIN_L) : 0;
  const short* T = s_T + g * S * CHAIN_TS;
  int bad = 0;
  if (live_c > 0) {
    int state = s_init[g] & (CHAIN_TS - 1);
    s_start[gc] = state;
    chain_walk<false>(s_sym, s_traj, T, ncp, gc, live_c, state, bad);
    s_fin[gc] = state;
    atomicAdd(&s_steps[g], live_c);
  }

  // --- fix-up rounds ---------------------------------------------------------------------
  int round = 1;
  bool mapped = false;
  for (;; ++round) {
    __syncthreads();  // the finals of the previous round are visible
    int entry = 0;
    bool changed = false;
    if (live_c > 0 && c > 0) {
      entry = s_fin[gc - 1];
      changed = entry != s_start[gc];
    }
    __syncthreads();  // every entry is read before a final is rewritten
    if (changed) {
      int state = entry;
      const int i = chain_walk<true>(s_sym, s_traj, T, ncp, gc, live_c, state, bad);
      if (i == live_c) s_fin[gc] = state;
      s_start[gc] = entry;
      atomicMax(&s_pass[g], round + 1);
      atomicAdd(&s_steps[g], i);
    }
    if (!__syncthreads_or(changed)) break;
    if (round == CHAIN_MAP_AFTER) {
      mapped = true;
      break;
    }
  }

  if (mapped) {
    // Chunks 0..round are exact. Every later live chunk maps all 64 entry
    // states through its steps, into its own trajectory slots (x * ncp + gc).
    if (live_c > 0 && c > round) {
      for (int x = 0; x < CHAIN_TS; x += 4) {
        int a = x, b = x + 1, e2 = x + 2, f = x + 3;
#pragma unroll 4
        for (int i = 0; i < live_c; ++i) {
          const int sb = s_sym[i * ncp + gc] << 6;
          a = T[sb | a] & (CHAIN_TS - 1);
          b = T[sb | b] & (CHAIN_TS - 1);
          e2 = T[sb | e2] & (CHAIN_TS - 1);
          f = T[sb | f] & (CHAIN_TS - 1);
        }
        s_traj[x * ncp + gc] = (unsigned char)a;
        s_traj[(x + 1) * ncp + gc] = (unsigned char)b;
        s_traj[(x + 2) * ncp + gc] = (unsigned char)e2;
        s_traj[(x + 3) * ncp + gc] = (unsigned char)f;
      }
      s_map[g] = 1;
    }
    __syncthreads();
    // One thread a row runs the exact entry through the maps.
    if (walker && c == 0) {
      const int last = (s_live[g] + CHAIN_L - 1) / CHAIN_L;  // live chunks
      if (last > round + 1) {
        int e = s_fin[g * nck + round];
        for (int k = round + 1; k < last; ++k) {
          s_start[g * nck + k] = e;
          e = s_traj[e * ncp + g * nck + k];
        }
      }
    }
    __syncthreads();
    if (live_c > 0 && c > round) {
      int state = s_start[gc];
      chain_walk<false>(s_sym, s_traj, T, ncp, gc, live_c, state, bad);
      s_fin[gc] = state;
      atomicAdd(&s_steps[g], live_c);
    }
  }
  if (bad < 0) s_bad[g] = 1;
  __syncthreads();

  // --- outputs: pre[t] = traj[t - 1], nb[t] = T[sym][pre] >> 6 --------------------------
  for (int q = tid; q < G * quads; q += blockDim.x) {
    const int gg = q / quads;
    if (s_bad[gg]) continue;
    const int t0 = (q - gg * quads) * 4;
    const int live = s_live[gg];
    const short* Tg = s_T + gg * S * CHAIN_TS;
    int pv[4], nv[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int s = t0 + e == 0 ? msb - 1 : t0 + e - 1;
      pv[e] = nv[e] = 0;
      if (s < live) {
        const int at = (s % CHAIN_L) * ncp + gg * nck + s / CHAIN_L;
        pv[e] = s_traj[at];
        nv[e] = Tg[(s_sym[at] << 6) | pv[e]] >> 6;
      }
    }
    const int64_t o = (int64_t)(r0 + gg) * msb + t0;
    *(int4*)(pre + o) = make_int4(pv[0], pv[1], pv[2], pv[3]);
    *(int4*)(nb_out + o) = make_int4(nv[0], nv[1], nv[2], nv[3]);
  }
  if (tid < G) {
    const int r = r0 + tid;
    const int live = s_live[tid];
    if (!s_bad[tid])
      fin[r] = s_rle[tid] ? 0 : (live == 0 ? s_init[tid]
                                           : s_fin[tid * nck + (live - 1) / CHAIN_L]);
    if (stats) {
      stats[r * CHAIN_STATS + 0] = s_pass[tid];
      stats[r * CHAIN_STATS + 1] = s_steps[tid];
      stats[r * CHAIN_STATS + 2] = s_map[tid];
      stats[r * CHAIN_STATS + 3] = s_bad[tid];
    }
    // --- a marked row: one thread walks it the long way, in 64-bit integers -------------
    if (s_bad[tid]) {
      const int* tb = s_tab + tid * TW;
      const long long ts = ts_of(s_tl[tid]);
      long long state = s_init[tid];
      const int64_t base = (int64_t)r * msb;
      for (int s = 0; s < msb; ++s) {
        const int t = s + 1 == msb ? 0 : s + 1;
        pre[base + t] = (int32_t)state;
        long long n = 0;
        if (s < live) {
          const int sym = s_sym[(s % CHAIN_L) * ncp + tid * nck + s / CHAIN_L];
          state = step64(state, ts, tb[CHAIN_TS + sym], tb[CHAIN_TS + S + sym], tb, &n);
        }
        nb_out[base + t] = (int32_t)n;
      }
      fin[r] = (int32_t)state;
    }
  }
}

extern "C" int tz_state_chain3(const void* st, const void* dnb, const void* dfs,
                               const void* init, const void* tl, const void* rle,
                               const void* nseq, int esz, const void* rsym, int sym64,
                               void* pre, void* nb, void* fin, void* stats, int R, int S,
                               int msb, cudaStream_t stream) {
  if (msb % 128 || msb / CHAIN_L > CHAIN_MAX_CHUNKS || msb < 128 || S < 1 ||
      S > CHAIN_SMAX || R < 1)
    return (int)cudaErrorInvalidValue;
  const ChainDims d = chain_dims(S, msb);
  static bool attr_set = false;
  if (!attr_set) {
    const ChainDims big = chain_dims(CHAIN_SMAX, CHAIN_L * CHAIN_MAX_CHUNKS);
    cudaError_t e1 = cudaFuncSetAttribute(state_chain3_kernel<int32_t>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, big.smem);
    cudaError_t e2 = cudaFuncSetAttribute(state_chain3_kernel<long long>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize, big.smem);
    if (e1 != cudaSuccess) return (int)e1;
    if (e2 != cudaSuccess) return (int)e2;
    attr_set = true;
  }
  const ChainOps ops = {{st, dnb, dfs, init, tl, rle, nseq}, esz};
  const unsigned grid = (unsigned)((R + d.G - 1) / d.G);
  if (sym64)
    state_chain3_kernel<long long><<<grid, d.threads, d.smem, stream>>>(
        ops, (const long long*)rsym, (int32_t*)pre, (int32_t*)nb, (int32_t*)fin,
        (int32_t*)stats, R, S, msb);
  else
    state_chain3_kernel<int32_t><<<grid, d.threads, d.smem, stream>>>(
        ops, (const int32_t*)rsym, (int32_t*)pre, (int32_t*)nb, (int32_t*)fin,
        (int32_t*)stats, R, S, msb);
  return (int)cudaGetLastError();
}
