// Native host engine for tpu-zstd: a self-contained RFC 8878 codec + C API.
//
// Counterpart of the reference's C API / host engine surface (reference
// include/cuda_zstd_manager.h:433-479 — 11 extern "C" functions over opaque
// manager handles — impl src/cuda_zstd_c_api.cpp; the engine plays the role
// the reference's CPU route plays, src/cuda_zstd_hybrid.cu:402).
// All algorithms are direct C++ ports of this repo's own format layer
// (tpu_zstd/format/{fse,sequences,huffman,frame}.py — the Python correctness
// oracle), NOT of the reference's CUDA sources:
//
//   compress:   greedy hash-chain LZ77 with repcodes -> Raw literals +
//               predefined-FSE sequences (the reference compressor's emitted
//               subset, reference src/cuda_zstd_manager.cu:4433-4435, 4493),
//               RLE/Raw block fallbacks, optional XXH64 content checksum.
//   decompress: full block decode — Raw/RLE/Compressed blocks; literal modes
//               Raw/RLE/Huffman (direct + FSE-compressed weights, 1- and
//               4-stream) with treeless table reuse; sequence modes
//               Predefined/RLE/FSE/Repeat with cross-block table persistence
//               and repcode history; skippable frames; checksum verify.
//
// Exposed to Python via ctypes (tpu_zstd/utils/native.py) as the Manager's
// fast CPU route, and to C callers directly (tz_engine_*).
//
// Build: part of libtpu_zstd_native.so (see utils/native.py).

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

extern "C" uint64_t tz_xxh64(const uint8_t* data, uint64_t len, uint64_t seed);
extern "C" int32_t tz_huf_decode_stream(const uint8_t* data, int64_t len,
                                        const int32_t* dtable, int32_t table_log,
                                        uint8_t* out, int64_t out_len);

namespace tz {

// ------------------------------------------------------------ constants ----

constexpr uint32_t kMagic = 0xFD2FB528;
constexpr uint32_t kSkipMin = 0x184D2A50, kSkipMax = 0x184D2A5F;
constexpr int kBlockMax = 128 * 1024;

constexpr int kLLLog = 6, kOFLog = 5, kMLLog = 6;
const int16_t kLLNorm[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                             2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                             -1, -1, -1, -1};
const int16_t kOFNorm[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const int16_t kMLNorm[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                             1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1,
                             -1, -1, -1, -1, -1, -1};

const uint32_t kLLBase[36] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                              15, 16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384, 32768,
                              65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                             13, 14, 15, 16};
const uint32_t kMLBase[53] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28,
                              29, 30, 31, 32, 33, 34, 35, 37, 39, 41, 43, 47,
                              51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051,
                              4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                             13, 14, 15, 16};

const uint8_t kLLCode[64] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 20, 20, 21, 21, 21, 21,
    22, 22, 22, 22, 22, 22, 22, 22, 23, 23, 23, 23, 23, 23, 23, 23,
    24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24, 24};
const uint8_t kMLCode[128] = {
    0,  1,  2,  3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31,
    32, 32, 33, 33, 34, 34, 35, 35, 36, 36, 36, 36, 37, 37, 37, 37,
    38, 38, 38, 38, 38, 38, 38, 38, 39, 39, 39, 39, 39, 39, 39, 39,
    40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40, 40,
    41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41, 41,
    42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42,
    42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42, 42};

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }
inline int llcode(uint32_t ll) { return ll < 64 ? kLLCode[ll] : 19 + highbit(ll); }
inline int mlcode(uint32_t ml) {
    uint32_t v = ml - 3;
    return v < 128 ? kMLCode[v] : 36 + highbit(v);
}

// --------------------------------------------------- backward bitstreams ----

struct BitWriter {
    std::vector<uint8_t> out;
    uint64_t container = 0;
    int nbits = 0;
    void add(uint32_t value, int bits) {
        container |= (uint64_t)(value & (bits >= 32 ? 0xFFFFFFFFu : ((1u << bits) - 1)))
                     << nbits;
        nbits += bits;
        while (nbits >= 8) {
            out.push_back((uint8_t)container);
            container >>= 8;
            nbits -= 8;
        }
    }
    void close() {
        add(1, 1);
        if (nbits > 0) {
            out.push_back((uint8_t)container);
            container = 0;
            nbits = 0;
        }
    }
};

struct BitReader {
    const uint8_t* data;
    int64_t len;
    int64_t bits_left = 0;
    bool bad = false, overflowed = false, permissive = false;
    BitReader(const uint8_t* d, int64_t n, bool perm = false)
        : data(d), len(n), permissive(perm) {
        if (n <= 0 || d[n - 1] == 0) { bad = true; return; }
        bits_left = (n - 1) * 8 + highbit(d[n - 1]);
    }
    uint32_t read(int nbits) {
        if (nbits == 0) return 0;
        if (nbits > bits_left) {
            if (!permissive) { bad = true; bits_left -= nbits; return 0; }
            int64_t have = bits_left > 0 ? bits_left : 0;
            uint64_t v = 0;
            for (int64_t k = 0; k * 8 < have && k < 8; ++k)
                v |= (uint64_t)data[k] << (8 * k);
            if (have < 64) v &= (1ULL << have) - 1;
            bits_left -= nbits;
            overflowed = true;
            return (uint32_t)(have > 0 ? (v << (nbits - have)) : 0)
                   & (nbits >= 32 ? 0xFFFFFFFFu : ((1u << nbits) - 1));
        }
        bits_left -= nbits;
        int64_t byte = bits_left >> 3;
        int sh = (int)(bits_left & 7);
        uint64_t v = 0;
        int need = (sh + nbits + 7) >> 3;
        for (int k = 0; k < need && byte + k < len; ++k)
            v |= (uint64_t)data[byte + k] << (8 * k);
        return (uint32_t)((v >> sh) &
                          (nbits >= 32 ? 0xFFFFFFFFu : ((1u << nbits) - 1)));
    }
};

// ------------------------------------------------------------- FSE core ----

// Symbol spread over the state table (format/fse.py spread_symbols).
static bool spread_symbols(const int16_t* norm, int nsym, int tlog, uint8_t* table) {
    int size = 1 << tlog;
    int high_threshold = size - 1;
    for (int s = 0; s < nsym; ++s)
        if (norm[s] == -1) table[high_threshold--] = (uint8_t)s;
    int step = (size >> 1) + (size >> 3) + 3;
    int mask = size - 1;
    int position = 0;
    for (int s = 0; s < nsym; ++s) {
        for (int k = 0; k < (norm[s] > 0 ? norm[s] : 0); ++k) {
            table[position] = (uint8_t)s;
            position = (position + step) & mask;
            while (position > high_threshold) position = (position + step) & mask;
        }
    }
    return position == 0;
}

struct CTable {  // format/fse.py build_ctable
    int table_log = 0;
    std::vector<uint16_t> state_table;
    uint32_t delta_nb[64];
    int32_t delta_fs[64];
    bool build(const int16_t* norm, int nsym, int tlog) {
        table_log = tlog;
        int size = 1 << tlog;
        uint8_t spread[1 << 12];
        if (!spread_symbols(norm, nsym, tlog, spread)) return false;
        int64_t cumul[65] = {0};
        for (int s = 0; s < nsym; ++s)
            cumul[s + 1] = cumul[s] + (norm[s] == -1 ? 1 : (norm[s] > 0 ? norm[s] : 0));
        state_table.assign(size, 0);
        int64_t fill[64];
        std::memcpy(fill, cumul, sizeof(int64_t) * nsym);
        for (int u = 0; u < size; ++u) {
            int s = spread[u];
            state_table[fill[s]++] = (uint16_t)(size + u);
        }
        int total = 0;
        for (int s = 0; s < nsym; ++s) {
            int n = norm[s];
            if (n == 0) {
                delta_nb[s] = (uint32_t)(((tlog + 1) << 16) - size);
                delta_fs[s] = 0;
            } else if (n == -1 || n == 1) {
                delta_nb[s] = (uint32_t)((tlog << 16) - size);
                delta_fs[s] = total - 1;
                total += 1;
            } else {
                int max_bits = tlog - highbit((uint32_t)(n - 1));
                int min_state_plus = n << max_bits;
                delta_nb[s] = (uint32_t)((max_bits << 16) - min_state_plus);
                delta_fs[s] = total - n;
                total += n;
            }
        }
        return true;
    }
};

struct EncState {  // format/fse.py EncState
    const CTable* ct = nullptr;
    int value = 0;
    void init(const CTable& t, int sym) {
        ct = &t;
        int nb = (int)((t.delta_nb[sym] + (1u << 15)) >> 16);
        int v = (nb << 16) - (int)t.delta_nb[sym];
        value = t.state_table[(v >> nb) + t.delta_fs[sym]];
    }
    void encode(int sym, BitWriter& w) {
        int nb = (int)(((uint32_t)value + ct->delta_nb[sym]) >> 16);
        w.add((uint32_t)value, nb);
        value = ct->state_table[(value >> nb) + ct->delta_fs[sym]];
    }
    void flush(BitWriter& w) { w.add((uint32_t)value, ct->table_log); }
};

struct DTable {  // format/fse.py build_dtable
    int table_log = 0;
    std::vector<uint8_t> symbol;
    std::vector<uint8_t> nb_bits;
    std::vector<uint16_t> new_state;
    bool ready = false;
    bool build(const int16_t* norm, int nsym, int tlog) {
        table_log = tlog;
        int size = 1 << tlog;
        uint8_t spread[1 << 12];
        if (!spread_symbols(norm, nsym, tlog, spread)) return false;
        int64_t symbol_next[64];
        for (int s = 0; s < nsym; ++s)
            symbol_next[s] = norm[s] == -1 ? 1 : (norm[s] > 0 ? norm[s] : 0);
        symbol.assign(size, 0);
        nb_bits.assign(size, 0);
        new_state.assign(size, 0);
        for (int u = 0; u < size; ++u) {
            int s = spread[u];
            int64_t next = symbol_next[s]++;
            int bits = tlog - highbit((uint32_t)next);
            symbol[u] = (uint8_t)s;
            nb_bits[u] = (uint8_t)bits;
            new_state[u] = (uint16_t)((next << bits) - size);
        }
        ready = true;
        return true;
    }
    void build_rle(int sym) {  // accuracy log 0 single state
        table_log = 0;
        symbol.assign(1, (uint8_t)sym);
        nb_bits.assign(1, 0);
        new_state.assign(1, 0);
        ready = true;
    }
};

struct DecState {
    const DTable* dt;
    int state;
    DecState(const DTable& t, BitReader& r) : dt(&t) { state = (int)r.read(t.table_log); }
    int peek() const { return dt->symbol[state]; }
    int update(BitReader& r) {
        int s = dt->symbol[state];
        int bits = dt->nb_bits[state];
        state = dt->new_state[state] + (int)r.read(bits);
        return s;
    }
};

// NCount header reader (format/fse.py read_ncount). Forward LSB-first.
struct FwdReader {
    const uint8_t* d;
    int64_t len;
    int64_t bitpos = 0;
    uint32_t peek(int n) const {
        int64_t byte = bitpos >> 3;
        uint64_t v = 0;
        for (int k = 0; k < 8 && byte + k < len; ++k)
            v |= (uint64_t)d[byte + k] << (8 * k);
        v >>= (bitpos & 7);
        return (uint32_t)(v & (n >= 32 ? 0xFFFFFFFFu : ((1u << n) - 1)));
    }
    uint32_t read(int n) {
        uint32_t v = peek(n);
        bitpos += n;
        return v;
    }
    void skip(int n) { bitpos += n; }
    int64_t bytes() const { return (bitpos + 7) >> 3; }
};

// Returns bytes consumed, or -1 on error; fills norm[0..nsym) and tlog.
static int read_ncount(const uint8_t* data, int64_t len, int max_symbol,
                       int16_t* norm, int* nsym_out, int* tlog_out) {
    FwdReader br{data, len};
    int tlog = (int)br.read(4) + 5;
    if (tlog > 12) return -1;
    int64_t table_size = 1 << tlog;
    int64_t remaining = table_size + 1;
    int64_t threshold = table_size;
    int nb_bits = tlog + 1;
    int nsym = 0;
    bool previous0 = false;
    std::memset(norm, 0, sizeof(int16_t) * (max_symbol + 1));
    while (remaining > 1 && nsym <= max_symbol) {
        if (previous0) {
            while (br.peek(16) == 0xFFFF) {
                br.skip(16);
                nsym += 24;
                if (nsym > max_symbol) return -1;
            }
            while (br.peek(2) == 3) {
                br.skip(2);
                nsym += 3;
                if (nsym > max_symbol) return -1;
            }
            nsym += (int)br.read(2);
            previous0 = false;
            if (nsym > max_symbol) break;
        }
        int64_t max_v = (2 * threshold - 1) - remaining;
        int64_t count;
        int64_t low = br.peek(nb_bits - 1) & (threshold - 1);
        if (low < max_v) {
            count = low;
            br.skip(nb_bits - 1);
        } else {
            count = br.peek(nb_bits) & (2 * threshold - 1);
            if (count >= threshold) count -= max_v;
            br.skip(nb_bits);
        }
        count -= 1;
        remaining -= count < 0 ? -count : count;
        if (nsym > max_symbol) return -1;
        norm[nsym++] = (int16_t)count;
        previous0 = count == 0;
        while (remaining < threshold && remaining > 1) {
            nb_bits -= 1;
            threshold >>= 1;
        }
    }
    if (remaining != 1) return -1;
    *nsym_out = nsym;
    *tlog_out = tlog;
    return (int)br.bytes();
}

// ------------------------------------------------------- Huffman decode ----

struct HufDTable {
    int table_log = 0;
    std::vector<int32_t> packed;  // (symbol << 8) | nb_bits per entry
    bool ready = false;
};

// weights (incl. implied last) -> decode table (format/huffman.py build_dtable)
static bool weights_to_dtable(const int* weights, int nw, HufDTable* out) {
    int64_t total = 0;
    for (int s = 0; s < nw; ++s)
        if (weights[s] > 0) total += (int64_t)1 << (weights[s] - 1);
    if (total == 0 || (total & (total - 1)) != 0) return false;
    int tlog = highbit((uint32_t)total);
    if (tlog > 12) return false;
    int size = 1 << tlog;
    std::vector<int64_t> rank_count(tlog + 2, 0);
    for (int s = 0; s < nw; ++s) rank_count[weights[s]]++;
    std::vector<int64_t> rank_start(tlog + 2, 0);
    int64_t next = 0;
    for (int w = 1; w <= tlog; ++w) {
        rank_start[w] = next;
        next += rank_count[w] << (w - 1);
    }
    if (next != size) return false;
    out->packed.assign(size, 0);
    std::vector<int64_t> fill = rank_start;
    for (int s = 0; s < nw; ++s) {
        int w = weights[s];
        if (w == 0) continue;
        int64_t span = (int64_t)1 << (w - 1);
        int nb = tlog + 1 - w;
        for (int64_t k = 0; k < span; ++k)
            out->packed[fill[w] + k] = (s << 8) | nb;
        fill[w] += span;
    }
    out->table_log = tlog;
    out->ready = true;
    return true;
}

// FSE-compressed weights (format/fse.py fse_decompress_weights).
static int fse_decode_weights(const uint8_t* d, int64_t len, int* weights,
                              int max_weights) {
    int16_t norm[16];
    int nsym = 0, tlog = 0;
    int consumed = read_ncount(d, len, 12, norm, &nsym, &tlog);
    if (consumed < 0 || tlog > 6) return -1;
    DTable dt;
    if (!dt.build(norm, nsym, tlog)) return -1;
    BitReader r(d + consumed, len - consumed, /*perm=*/true);
    if (r.bad) return -1;
    DecState s1(dt, r), s2(dt, r);
    int n = 0;
    while (n <= max_weights) {
        weights[n++] = s1.update(r);
        if (r.overflowed) {
            if (n > max_weights) return -1;
            weights[n++] = s2.peek();
            break;
        }
        if (n > max_weights) return -1;
        weights[n++] = s2.update(r);
        if (r.overflowed) {
            if (n > max_weights) return -1;
            weights[n++] = s1.peek();
            break;
        }
    }
    if (n > max_weights) return -1;
    return n;
}

// Parse weight header (format/huffman.py parse_weights + implied last).
// Returns bytes consumed, or -1; fills dtable.
static int parse_huf_weights(const uint8_t* d, int64_t len, HufDTable* dt) {
    if (len < 1) return -1;
    int hdr = d[0];
    int weights[300];
    int num;
    int consumed;
    if (hdr < 128) {
        if (1 + hdr > len) return -1;
        num = fse_decode_weights(d + 1, hdr, weights, 255);
        if (num < 0) return -1;
        consumed = 1 + hdr;
    } else {
        num = hdr - 127;
        int nbytes = (num + 1) / 2;
        if (1 + nbytes > len) return -1;
        for (int i = 0; i < num; ++i) {
            int b = d[1 + i / 2];
            weights[i] = (i % 2 == 0) ? (b >> 4) : (b & 0xF);
        }
        consumed = 1 + nbytes;
    }
    // implied last weight
    int64_t total = 0;
    for (int i = 0; i < num; ++i)
        if (weights[i] > 0) total += (int64_t)1 << (weights[i] - 1);
    if (total == 0) return -1;
    int64_t next_pow2 = (int64_t)1 << (highbit((uint32_t)total) + 1);
    int64_t rest = next_pow2 - total;
    if (rest <= 0 || (rest & (rest - 1)) != 0) return -1;
    weights[num++] = highbit((uint32_t)rest) + 1;
    if (!weights_to_dtable(weights, num, dt)) return -1;
    return consumed;
}

// -------------------------------------------------------- frame decoding ----

struct DecCtx {
    HufDTable huf;              // persists for treeless literals
    DTable dt_ll, dt_of, dt_ml;  // persist for Repeat mode
    bool have_seq_tables = false;
    int64_t rep[3] = {1, 4, 8};
};

// Literal section decode into `lits`. Returns bytes consumed, or -1.
static int64_t decode_literals(const uint8_t* d, int64_t len, DecCtx* ctx,
                               std::vector<uint8_t>* lits) {
    if (len < 1) return -1;
    int b0 = d[0];
    int lit_type = b0 & 3;
    int size_format = (b0 >> 2) & 3;
    if (lit_type == 0 || lit_type == 1) {  // Raw / RLE
        int64_t regen, pos;
        if (size_format == 0 || size_format == 2) {
            regen = b0 >> 3;
            pos = 1;
        } else if (size_format == 1) {
            if (len < 2) return -1;
            regen = (d[0] | ((int64_t)d[1] << 8)) >> 4;
            pos = 2;
        } else {
            if (len < 3) return -1;
            regen = (d[0] | ((int64_t)d[1] << 8) | ((int64_t)d[2] << 16)) >> 4;
            pos = 3;
        }
        if (lit_type == 0) {
            if (pos + regen > len) return -1;
            lits->assign(d + pos, d + pos + regen);
            return pos + regen;
        }
        if (pos + 1 > len) return -1;
        lits->assign((size_t)regen, d[pos]);
        return pos + 1;
    }
    // Compressed / Treeless
    int64_t regen, comp, pos;
    int streams;
    if (size_format == 0) {
        if (len < 3) return -1;
        int64_t v = d[0] | ((int64_t)d[1] << 8) | ((int64_t)d[2] << 16);
        regen = (v >> 4) & 0x3FF;
        comp = (v >> 14) & 0x3FF;
        pos = 3;
        streams = 1;
    } else if (size_format == 1) {
        if (len < 3) return -1;
        int64_t v = d[0] | ((int64_t)d[1] << 8) | ((int64_t)d[2] << 16);
        regen = (v >> 4) & 0x3FF;
        comp = (v >> 14) & 0x3FF;
        pos = 3;
        streams = 4;
    } else if (size_format == 2) {
        if (len < 4) return -1;
        int64_t v = d[0] | ((int64_t)d[1] << 8) | ((int64_t)d[2] << 16) |
                    ((int64_t)d[3] << 24);
        regen = (v >> 4) & 0x3FFF;
        comp = (v >> 18) & 0x3FFF;
        pos = 4;
        streams = 4;
    } else {
        if (len < 5) return -1;
        int64_t v = d[0] | ((int64_t)d[1] << 8) | ((int64_t)d[2] << 16) |
                    ((int64_t)d[3] << 24) | ((int64_t)d[4] << 32);
        regen = (v >> 4) & 0x3FFFF;
        comp = (v >> 22) & 0x3FFFF;
        pos = 5;
        streams = 4;
    }
    if (pos + comp > len) return -1;
    const uint8_t* payload = d + pos;
    int64_t plen = comp;
    if (lit_type == 2) {
        int c = parse_huf_weights(payload, plen, &ctx->huf);
        if (c < 0) return -1;
        payload += c;
        plen -= c;
    } else if (!ctx->huf.ready) {
        return -1;  // treeless without a previous table
    }
    lits->assign((size_t)regen, 0);
    if (streams == 1) {
        if (tz_huf_decode_stream(payload, plen, ctx->huf.packed.data(),
                                 ctx->huf.table_log, lits->data(), regen) != 0)
            return -1;
    } else {
        if (plen < 6) return -1;
        int64_t s1 = payload[0] | (payload[1] << 8);
        int64_t s2 = payload[2] | (payload[3] << 8);
        int64_t s3 = payload[4] | (payload[5] << 8);
        const uint8_t* body = payload + 6;
        int64_t blen = plen - 6;
        if (s1 + s2 + s3 > blen) return -1;
        int64_t seg = (regen + 3) / 4;
        int64_t sizes_in[4] = {s1, s2, s3, blen - s1 - s2 - s3};
        int64_t sizes_out[4] = {seg, seg, seg, regen - 3 * seg};
        if (sizes_out[3] <= 0) return -1;
        int64_t off_in = 0, off_out = 0;
        for (int s = 0; s < 4; ++s) {
            if (tz_huf_decode_stream(body + off_in, sizes_in[s],
                                     ctx->huf.packed.data(), ctx->huf.table_log,
                                     lits->data() + off_out, sizes_out[s]) != 0)
                return -1;
            off_in += sizes_in[s];
            off_out += sizes_out[s];
        }
    }
    return pos + comp;
}

// One symbol table per mode (format/sequences.py read_sequence_table).
static int read_seq_table(const uint8_t* d, int64_t len, int mode, DTable* dt,
                          const int16_t* default_norm, int default_nsym,
                          int default_log, int max_symbol, bool have_prev) {
    if (mode == 0) return dt->build(default_norm, default_nsym, default_log) ? 0 : -1;
    if (mode == 1) {
        if (len < 1) return -1;
        if (d[0] > max_symbol) return -1;
        dt->build_rle(d[0]);
        return 1;
    }
    if (mode == 2) {
        int16_t norm[64];
        int nsym = 0, tlog = 0;
        int c = read_ncount(d, len, max_symbol, norm, &nsym, &tlog);
        if (c < 0 || tlog > 9) return -1;
        return dt->build(norm, nsym, tlog) ? c : -1;
    }
    // Repeat
    return (have_prev && dt->ready) ? 0 : -1;
}

// Decode + execute one Compressed block body. Appends to out. Returns 0/-1.
static int decode_block(const uint8_t* d, int64_t len, DecCtx* ctx,
                        std::vector<uint8_t>* out, size_t frame_start) {
    std::vector<uint8_t> lits;
    int64_t c = decode_literals(d, len, ctx, &lits);
    if (c < 0) return -1;
    const uint8_t* p = d + c;
    int64_t plen = len - c;
    if (plen < 1) return -1;
    // nbSeq varint
    int64_t nbseq, pos;
    if (p[0] < 128) {
        nbseq = p[0];
        pos = 1;
    } else if (p[0] < 255) {
        if (plen < 2) return -1;
        nbseq = ((p[0] - 0x80) << 8) + p[1];
        pos = 2;
    } else {
        if (plen < 3) return -1;
        nbseq = p[1] + (p[2] << 8) + 0x7F00;
        pos = 3;
    }
    if (nbseq == 0) {
        out->insert(out->end(), lits.begin(), lits.end());
        return 0;
    }
    if (plen < pos + 1) return -1;
    int modes = p[pos++];
    int ll_mode = (modes >> 6) & 3, of_mode = (modes >> 4) & 3, ml_mode = (modes >> 2) & 3;
    int r;
    r = read_seq_table(p + pos, plen - pos, ll_mode, &ctx->dt_ll, kLLNorm, 36,
                       kLLLog, 35, ctx->have_seq_tables);
    if (r < 0) return -1;
    pos += r;
    r = read_seq_table(p + pos, plen - pos, of_mode, &ctx->dt_of, kOFNorm, 29,
                       kOFLog, 31, ctx->have_seq_tables);
    if (r < 0) return -1;
    pos += r;
    r = read_seq_table(p + pos, plen - pos, ml_mode, &ctx->dt_ml, kMLNorm, 53,
                       kMLLog, 52, ctx->have_seq_tables);
    if (r < 0) return -1;
    pos += r;
    ctx->have_seq_tables = true;

    BitReader br(p + pos, plen - pos);
    if (br.bad) return -1;
    DecState st_ll(ctx->dt_ll, br), st_of(ctx->dt_of, br), st_ml(ctx->dt_ml, br);
    size_t lit_pos = 0;
    for (int64_t i = 0; i < nbseq; ++i) {
        int ofc = st_of.peek();
        int mlc = st_ml.peek();
        int llc = st_ll.peek();
        if (ofc > 31 || mlc > 52 || llc > 35) return -1;
        int64_t off_value = ofc > 0 ? (((int64_t)1 << ofc) + br.read(ofc)) : 1;
        int64_t ml = (int64_t)kMLBase[mlc] + br.read(kMLBits[mlc]);
        int64_t ll = (int64_t)kLLBase[llc] + br.read(kLLBits[llc]);
        if (i != nbseq - 1) {
            st_ll.update(br);
            st_ml.update(br);
            st_of.update(br);
        }
        if (br.bad) return -1;
        // repcode resolution (format/sequences.py resolve_offset)
        int64_t off;
        int64_t* rep = ctx->rep;
        if (off_value > 3) {
            off = off_value - 3;
            rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
        } else {
            int idx = (int)off_value - 1 + (ll == 0 ? 1 : 0);
            if (idx == 0) {
                off = rep[0];
            } else if (idx == 1) {
                off = rep[1];
                rep[1] = rep[0]; rep[0] = off;
            } else if (idx == 2) {
                off = rep[2];
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
            } else {
                off = rep[0] - 1;
                if (off <= 0) return -1;
                rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
            }
        }
        if (lit_pos + ll > lits.size()) return -1;
        out->insert(out->end(), lits.begin() + lit_pos, lits.begin() + lit_pos + ll);
        lit_pos += ll;
        if (off > (int64_t)(out->size() - frame_start)) return -1;
        size_t start = out->size() - off;
        for (int64_t k = 0; k < ml; ++k) out->push_back((*out)[start + k]);
    }
    if (br.bits_left != 0) return -1;
    out->insert(out->end(), lits.begin() + lit_pos, lits.end());
    return 0;
}

// Full frame(s) decode. Returns output size or -1.
static int64_t decompress_impl(const uint8_t* d, int64_t len,
                               std::vector<uint8_t>* out, bool verify) {
    int64_t pos = 0;
    while (pos < len) {
        if (pos + 4 > len) return -1;
        uint32_t magic;
        std::memcpy(&magic, d + pos, 4);
        if (magic >= kSkipMin && magic <= kSkipMax) {
            if (pos + 8 > len) return -1;
            uint32_t size;
            std::memcpy(&size, d + pos + 4, 4);
            pos += 8 + size;
            continue;
        }
        if (magic != kMagic) return -1;
        if (pos + 5 > len) return -1;
        int fhd = d[pos + 4];
        int fcs_flag = fhd >> 6;
        bool single_segment = (fhd >> 5) & 1;
        if ((fhd >> 3) & 1) return -1;
        bool has_checksum = (fhd >> 2) & 1;
        int did_flag = fhd & 3;
        int64_t hpos = pos + 5;
        if (!single_segment) hpos += 1;  // window descriptor
        static const int did_len[4] = {0, 1, 2, 4};
        hpos += did_len[did_flag];
        int64_t content_size = -1;
        if (fcs_flag == 0) {
            if (single_segment) {
                if (hpos + 1 > len) return -1;
                content_size = d[hpos];
                hpos += 1;
            }
        } else if (fcs_flag == 1) {
            if (hpos + 2 > len) return -1;
            content_size = 256 + (d[hpos] | (d[hpos + 1] << 8));
            hpos += 2;
        } else if (fcs_flag == 2) {
            if (hpos + 4 > len) return -1;
            uint32_t v;
            std::memcpy(&v, d + hpos, 4);
            content_size = v;
            hpos += 4;
        } else {
            if (hpos + 8 > len) return -1;
            uint64_t v;
            std::memcpy(&v, d + hpos, 8);
            content_size = (int64_t)v;
            hpos += 8;
        }
        DecCtx ctx;
        size_t frame_start = out->size();
        pos = hpos;
        while (true) {
            if (pos + 3 > len) return -1;
            uint32_t bh = d[pos] | (d[pos + 1] << 8) | ((uint32_t)d[pos + 2] << 16);
            pos += 3;
            int last = bh & 1;
            int btype = (bh >> 1) & 3;
            int64_t bsize = bh >> 3;
            if (btype == 0) {
                if (pos + bsize > len) return -1;
                out->insert(out->end(), d + pos, d + pos + bsize);
                pos += bsize;
            } else if (btype == 1) {
                if (pos + 1 > len) return -1;
                out->insert(out->end(), (size_t)bsize, d[pos]);
                pos += 1;
            } else if (btype == 2) {
                if (pos + bsize > len) return -1;
                if (decode_block(d + pos, bsize, &ctx, out, frame_start) != 0)
                    return -1;
                pos += bsize;
            } else {
                return -1;
            }
            if (last) break;
        }
        if (has_checksum) {
            if (pos + 4 > len) return -1;
            if (verify) {
                uint32_t stored;
                std::memcpy(&stored, d + pos, 4);
                uint32_t computed = (uint32_t)tz_xxh64(
                    out->data() + frame_start, out->size() - frame_start, 0);
                if (stored != computed) return -1;
            }
            pos += 4;
        }
        if (content_size >= 0 &&
            (int64_t)(out->size() - frame_start) != content_size)
            return -1;
    }
    return (int64_t)out->size();
}

// -------------------------------------------------------- frame encoding ----

struct EncCfg {
    int level = 3;
    int hash_log = 16;
    int depth = 8;
    bool checksum = false;
    int block_size = kBlockMax;  // <= kBlockMax
};

// Greedy hash-chain LZ77 over one block (positions are block-local; matches
// may reach into `window_len` bytes preceding the block in `base`).
struct Seq {
    uint32_t ll, ml, ob;
};

static void parse_block_greedy(const uint8_t* base, int64_t window_len,
                               int64_t n, const EncCfg& cfg, int64_t rep[3],
                               std::vector<Seq>* seqs,
                               std::vector<uint8_t>* lits) {
    const uint8_t* block = base + window_len;
    const int hlog = cfg.hash_log;
    const uint32_t hmask = (1u << hlog) - 1;
    std::vector<int32_t> head((size_t)1 << hlog, -1);
    std::vector<int32_t> chain((size_t)(window_len + n), -1);
    auto hash4 = [&](int64_t p) {
        uint32_t v;
        std::memcpy(&v, base + p, 4);
        return (v * 2654435761u) >> (32 - hlog);
    };
    // seed the window (dictionary / prior stream content)
    for (int64_t p = 0; p + 4 <= window_len; ++p) {
        uint32_t h = hash4(p);
        chain[p] = head[h];
        head[h] = (int32_t)p;
    }
    int64_t total = window_len + n;
    int64_t anchor = window_len;  // literal run start
    int64_t p = window_len;
    while (p + 4 <= total) {
        uint32_t h = hash4(p);
        int32_t cand = head[h];
        int best_len = 0;
        int64_t best_off = 0;
        // rep0 probe first (cheap + repcode-friendly)
        if (rep[0] > 0 && p - rep[0] >= 0) {
            int64_t q = p - rep[0];
            int l = 0;
            while (p + l < total && base[q + l] == base[p + l] && l < 131072) ++l;
            if (l >= 4) {
                best_len = l;
                best_off = rep[0];
            }
        }
        for (int dcount = 0; cand >= 0 && dcount < cfg.depth; ++dcount) {
            int64_t q = cand;
            cand = chain[q];
            int probe = best_len > 0 ? best_len - 1 : 0;
            if (base[q + probe] != base[p + probe]) continue;
            int l = 0;
            while (p + l < total && base[q + l] == base[p + l] && l < 131072) ++l;
            if (l > best_len) {
                best_len = l;
                best_off = p - q;
            }
        }
        if (best_len >= 4) {
            uint32_t ll = (uint32_t)(p - anchor);
            lits->insert(lits->end(), base + anchor, base + p);
            // offset -> off-base with repcodes (format/sequences.py encode_offset)
            uint32_t ob;
            int64_t off = best_off;
            if (ll != 0) {
                if (off == rep[0]) {
                    ob = 1;
                } else if (off == rep[1]) {
                    ob = 2;
                    rep[1] = rep[0]; rep[0] = off;
                } else if (off == rep[2]) {
                    ob = 3;
                    rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
                } else {
                    ob = (uint32_t)(off + 3);
                    rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
                }
            } else {
                if (off == rep[1]) {
                    ob = 1;
                    rep[1] = rep[0]; rep[0] = off;
                } else if (off == rep[2]) {
                    ob = 2;
                    rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
                } else if (off == rep[0] - 1 && off != 0) {
                    ob = 3;
                    rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
                } else {
                    ob = (uint32_t)(off + 3);
                    rep[2] = rep[1]; rep[1] = rep[0]; rep[0] = off;
                }
            }
            seqs->push_back({ll, (uint32_t)best_len, ob});
            // insert match positions into the chain (every position)
            int64_t end = p + best_len;
            for (int64_t q = p; q < end && q + 4 <= total; ++q) {
                uint32_t hh = hash4(q);
                chain[q] = head[hh];
                head[hh] = (int32_t)q;
            }
            p = end;
            anchor = p;
        } else {
            chain[p] = head[h];
            head[h] = (int32_t)p;
            ++p;
        }
    }
    lits->insert(lits->end(), base + anchor, base + total);
}

static const CTable& predef_ll() {
    static CTable t;
    static bool done = t.build(kLLNorm, 36, kLLLog);
    (void)done;
    return t;
}
static const CTable& predef_of() {
    static CTable t;
    static bool done = t.build(kOFNorm, 29, kOFLog);
    (void)done;
    return t;
}
static const CTable& predef_ml() {
    static CTable t;
    static bool done = t.build(kMLNorm, 53, kMLLog);
    (void)done;
    return t;
}

// Sequences_Section with predefined tables (format/sequences.py
// encode_sequences_section). Returns the section bytes.
static std::vector<uint8_t> encode_sequences(const std::vector<Seq>& seqs) {
    std::vector<uint8_t> out;
    size_t n = seqs.size();
    if (n == 0) {
        out.push_back(0);
        return out;
    }
    if (n < 128) {
        out.push_back((uint8_t)n);
    } else if (n < 0x7F00) {
        out.push_back((uint8_t)((n >> 8) + 0x80));
        out.push_back((uint8_t)(n & 0xFF));
    } else {
        out.push_back(0xFF);
        out.push_back((uint8_t)((n - 0x7F00) & 0xFF));
        out.push_back((uint8_t)(((n - 0x7F00) >> 8) & 0xFF));
    }
    out.push_back(0);  // all predefined
    BitWriter w;
    EncState st_ml, st_of, st_ll;
    const Seq& lastq = seqs[n - 1];
    int lc = llcode(lastq.ll), mc = mlcode(lastq.ml), oc = highbit(lastq.ob);
    st_ml.init(predef_ml(), mc);
    st_of.init(predef_of(), oc);
    st_ll.init(predef_ll(), lc);
    w.add(lastq.ll, kLLBits[lc]);
    w.add(lastq.ml - 3, kMLBits[mc]);
    w.add(lastq.ob, oc);
    for (int64_t i = (int64_t)n - 2; i >= 0; --i) {
        const Seq& s = seqs[i];
        lc = llcode(s.ll);
        mc = mlcode(s.ml);
        oc = highbit(s.ob);
        st_of.encode(oc, w);
        st_ml.encode(mc, w);
        st_ll.encode(lc, w);
        w.add(s.ll, kLLBits[lc]);
        w.add(s.ml - 3, kMLBits[mc]);
        w.add(s.ob, oc);
    }
    st_ml.flush(w);
    st_of.flush(w);
    st_ll.flush(w);
    w.close();
    out.insert(out.end(), w.out.begin(), w.out.end());
    return out;
}

static int64_t compress_impl(const uint8_t* d, int64_t n, const EncCfg& cfg,
                             std::vector<uint8_t>* out) {
    // frame header: fcs4 + window descriptor (simple, always-valid shape)
    uint32_t magic = kMagic;
    out->insert(out->end(), (uint8_t*)&magic, (uint8_t*)&magic + 4);
    uint8_t fhd = (uint8_t)((2 << 6) | (cfg.checksum ? 4 : 0));
    out->push_back(fhd);
    int64_t wref = n > 0 ? n : 1024;
    int wlog = 10;
    while (((int64_t)1 << wlog) < wref && wlog < 31) ++wlog;
    out->push_back((uint8_t)((wlog - 10) << 3));
    uint32_t cs32 = (uint32_t)n;
    out->insert(out->end(), (uint8_t*)&cs32, (uint8_t*)&cs32 + 4);

    int64_t rep[3] = {1, 4, 8};
    const int64_t bs = cfg.block_size > 0 && cfg.block_size <= kBlockMax
                           ? cfg.block_size : kBlockMax;
    int64_t nb = n > 0 ? (n + bs - 1) / bs : 1;
    for (int64_t b = 0; b < nb; ++b) {
        int64_t start = b * bs;
        int64_t blen = n - start < bs ? n - start : bs;
        int last = b == nb - 1 ? 1 : 0;
        const uint8_t* block = d + start;
        // RLE block?
        bool rle = blen >= 2;
        for (int64_t k = 1; k < blen && rle; ++k) rle = block[k] == block[0];
        if (rle) {
            // RLE blocks emit no sequences: rep history persists unchanged.
            uint32_t bh = ((uint32_t)blen << 3) | (1 << 1) | last;
            out->push_back(bh & 0xFF);
            out->push_back((bh >> 8) & 0xFF);
            out->push_back((bh >> 16) & 0xFF);
            out->push_back(block[0]);
            continue;
        }
        std::vector<Seq> seqs;
        std::vector<uint8_t> lits;
        int64_t rep_in[3] = {rep[0], rep[1], rep[2]};
        int64_t window_len = start < 131072 ? start : 131072;
        parse_block_greedy(block - window_len, window_len, blen, cfg, rep, &seqs,
                           &lits);
        // literal section (Raw)
        std::vector<uint8_t> body;
        size_t nlit = lits.size();
        if (nlit < 32) {
            body.push_back((uint8_t)(nlit << 3));
        } else if (nlit < 4096) {
            uint32_t v = ((uint32_t)nlit << 4) | (1 << 2);
            body.push_back(v & 0xFF);
            body.push_back((v >> 8) & 0xFF);
        } else {
            uint32_t v = ((uint32_t)nlit << 4) | (3 << 2);
            body.push_back(v & 0xFF);
            body.push_back((v >> 8) & 0xFF);
            body.push_back((v >> 16) & 0xFF);
        }
        body.insert(body.end(), lits.begin(), lits.end());
        std::vector<uint8_t> seq_sec = encode_sequences(seqs);
        body.insert(body.end(), seq_sec.begin(), seq_sec.end());
        if ((int64_t)body.size() < blen && !seqs.empty()) {
            uint32_t bh = ((uint32_t)body.size() << 3) | (2 << 1) | last;
            out->push_back(bh & 0xFF);
            out->push_back((bh >> 8) & 0xFF);
            out->push_back((bh >> 16) & 0xFF);
            out->insert(out->end(), body.begin(), body.end());
        } else {
            // Raw block (guarantee: output <= input + 3 per block)
            uint32_t bh = ((uint32_t)blen << 3) | (0 << 1) | last;
            out->push_back(bh & 0xFF);
            out->push_back((bh >> 8) & 0xFF);
            out->push_back((bh >> 16) & 0xFF);
            out->insert(out->end(), block, block + blen);
            rep[0] = rep_in[0]; rep[1] = rep_in[1]; rep[2] = rep_in[2];
        }
    }
    if (cfg.checksum) {
        uint32_t cksum = (uint32_t)tz_xxh64(d, (uint64_t)n, 0);
        out->insert(out->end(), (uint8_t*)&cksum, (uint8_t*)&cksum + 4);
    }
    return (int64_t)out->size();
}

}  // namespace tz

// --------------------------------------------------------------- C API ----
//
// Mirrors the reference's 11-function extern "C" surface
// (reference include/cuda_zstd_manager.h:433-479): opaque engine handles,
// compress/decompress, bounds/size queries, stats, validation, error strings.

extern "C" {

struct tz_engine {
    tz::EncCfg cfg;
    int64_t in_bytes = 0, out_bytes = 0;
    int64_t calls = 0;
    int last_error = 0;
};

// 1. create
tz_engine* tz_engine_create(int level) {
    tz_engine* e = new (std::nothrow) tz_engine();
    if (!e) return nullptr;
    e->cfg.level = level < 1 ? 1 : (level > 22 ? 22 : level);
    e->cfg.depth = e->cfg.level <= 2 ? 2 : (e->cfg.level <= 6 ? 8 : 32);
    e->cfg.hash_log = e->cfg.level <= 2 ? 15 : 17;
    return e;
}

// 2. destroy
void tz_engine_destroy(tz_engine* e) { delete e; }

// 3. configure checksum policy / block size
void tz_engine_set_checksum(tz_engine* e, int enable) {
    if (e) e->cfg.checksum = enable != 0;
}

void tz_engine_set_block_size(tz_engine* e, int block_size) {
    if (e && block_size >= 1024 && block_size <= tz::kBlockMax)
        e->cfg.block_size = block_size;
}

// 4. compress bound (mirrors estimate_compressed_size)
int64_t tz_engine_compress_bound(int64_t src_size) {
    int64_t nblocks = src_size > 0 ? (src_size + tz::kBlockMax - 1) / tz::kBlockMax : 1;
    return src_size + nblocks * 3 + 18 + 4;
}

// 5. compress
int64_t tz_engine_compress(tz_engine* e, const uint8_t* src, int64_t src_size,
                           uint8_t* dst, int64_t dst_cap) {
    if (!e || (!src && src_size > 0) || !dst) return -2;
    std::vector<uint8_t> out;
    out.reserve((size_t)tz_engine_compress_bound(src_size));
    int64_t r = tz::compress_impl(src, src_size, e->cfg, &out);
    if (r < 0 || r > dst_cap) {
        e->last_error = r < 0 ? 1 : 3;
        return r < 0 ? -1 : -3;
    }
    std::memcpy(dst, out.data(), (size_t)r);
    e->in_bytes += src_size;
    e->out_bytes += r;
    e->calls += 1;
    return r;
}

// 6. decompress
int64_t tz_engine_decompress(tz_engine* e, const uint8_t* src, int64_t src_size,
                             uint8_t* dst, int64_t dst_cap) {
    if ((!src && src_size > 0) || (!dst && dst_cap > 0)) return -2;
    std::vector<uint8_t> out;
    int64_t r = tz::decompress_impl(src, src_size, &out, /*verify=*/true);
    if (r < 0) {
        if (e) e->last_error = 4;
        return -1;
    }
    if (r > dst_cap) {
        if (e) e->last_error = 3;
        return -3;
    }
    std::memcpy(dst, out.data(), (size_t)r);
    return r;
}

// 7. decompressed-size probe (frame header FCS; -1 when unknown/invalid)
int64_t tz_engine_decompressed_size(const uint8_t* src, int64_t src_size) {
    int64_t pos = 0;
    int64_t total = 0;
    while (pos + 4 <= src_size) {
        uint32_t magic;
        std::memcpy(&magic, src + pos, 4);
        if (magic >= tz::kSkipMin && magic <= tz::kSkipMax) {
            if (pos + 8 > src_size) return -1;
            uint32_t size;
            std::memcpy(&size, src + pos + 4, 4);
            pos += 8 + size;
            continue;
        }
        if (magic != tz::kMagic || pos + 5 > src_size) return -1;
        int fhd = src[pos + 4];
        int fcs_flag = fhd >> 6;
        bool ss = (fhd >> 5) & 1;
        int64_t hpos = pos + 5 + (ss ? 0 : 1);
        static const int did_len[4] = {0, 1, 2, 4};
        hpos += did_len[fhd & 3];
        if (fcs_flag == 0 && !ss) return -1;  // size not recorded
        int64_t cs;
        if (fcs_flag == 0) {
            cs = src[hpos];
        } else if (fcs_flag == 1) {
            cs = 256 + (src[hpos] | (src[hpos + 1] << 8));
        } else if (fcs_flag == 2) {
            uint32_t v;
            std::memcpy(&v, src + hpos, 4);
            cs = v;
        } else {
            uint64_t v;
            std::memcpy(&v, src + hpos, 8);
            cs = (int64_t)v;
        }
        total += cs;
        // Walk the frame's block headers to find the next frame (multi-frame
        // inputs must report the SUM, like the reference's
        // get_decompressed_size, types.cpp:1058).
        int64_t fcs_len[4] = {ss ? 1 : 0, 2, 4, 8};
        if (fcs_flag == 0 && !ss) fcs_len[0] = 0;
        int64_t bpos = hpos + fcs_len[fcs_flag];
        for (;;) {
            if (bpos + 3 > src_size) return -1;
            uint32_t bh = src[bpos] | (src[bpos + 1] << 8) | (src[bpos + 2] << 16);
            int last = bh & 1;
            int btype = (bh >> 1) & 3;
            int64_t bsize = bh >> 3;
            if (btype == 3) return -1;
            bpos += 3 + (btype == 1 ? 1 : bsize);
            if (bpos > src_size) return -1;
            if (last) break;
        }
        if ((fhd >> 2) & 1) bpos += 4;  // content checksum
        pos = bpos;
    }
    return total > 0 || pos > 0 ? total : -1;
}

// 8. validate (full decode, checksum verified)
int32_t tz_engine_validate(const uint8_t* src, int64_t src_size) {
    std::vector<uint8_t> out;
    return tz::decompress_impl(src, src_size, &out, true) >= 0 ? 1 : 0;
}

// 9. stats (fills 4 int64 slots: in_bytes, out_bytes, calls, last_error)
void tz_engine_get_stats(const tz_engine* e, int64_t* stats4) {
    if (!e || !stats4) return;
    stats4[0] = e->in_bytes;
    stats4[1] = e->out_bytes;
    stats4[2] = e->calls;
    stats4[3] = e->last_error;
}

// 10. reset stats/state
void tz_engine_reset(tz_engine* e) {
    if (!e) return;
    e->in_bytes = e->out_bytes = e->calls = 0;
    e->last_error = 0;
}

// 11. error string
const char* tz_engine_error_string(int32_t code) {
    switch (code) {
        case 0: return "success";
        case -1: case 1: return "generic failure / corrupt data";
        case -2: case 2: return "invalid parameter";
        case -3: case 3: return "destination buffer too small";
        case 4: return "corrupt data or checksum mismatch";
        default: return "unknown error";
    }
}

}  // extern "C"
