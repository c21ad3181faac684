// Native host-side runtime for tpu-zstd: XXHash64/32 + frame assembly.
//
// Counterpart of the reference's host/native layer (reference
// src/cuda_zstd_xxhash.cu + include/cuda_zstd_xxhash.h implement XXH64/32 as
// device+host inlines; frame assembly is BlockBufferWriter staging,
// src/cuda_zstd_manager.cu:467-588). On TPU the checksum and the final
// variable-length frame join are host-side operations on the result path, so
// they live in C++ — the Python layer calls these via ctypes
// (tpu_zstd/utils/native.py) with a numpy fallback.
//
// XXH64/XXH32 are implemented from the public xxHash specification
// (https://github.com/Cyan4973/xxHash/blob/dev/doc/xxhash_spec.md).
//
// Build: g++ -O3 -shared -fPIC tpu_zstd_native.cpp -o libtpu_zstd_native.so

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- XXH64 ----

static const uint64_t P1 = 11400714785074694791ULL;
static const uint64_t P2 = 14029467366897019727ULL;
static const uint64_t P3 = 1609587929392839161ULL;
static const uint64_t P4 = 9650029242287828579ULL;
static const uint64_t P5 = 2870177450012600261ULL;

static inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
static inline uint64_t read64(const uint8_t* p) { uint64_t v; std::memcpy(&v, p, 8); return v; }
static inline uint32_t read32(const uint8_t* p) { uint32_t v; std::memcpy(&v, p, 4); return v; }

static inline uint64_t xxh64_round(uint64_t acc, uint64_t input) {
    acc += input * P2;
    acc = rotl64(acc, 31);
    return acc * P1;
}

static inline uint64_t xxh64_merge(uint64_t acc, uint64_t val) {
    acc ^= xxh64_round(0, val);
    return acc * P1 + P4;
}

uint64_t tz_xxh64(const uint8_t* data, uint64_t len, uint64_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        const uint8_t* limit = end - 32;
        do {
            v1 = xxh64_round(v1, read64(p)); p += 8;
            v2 = xxh64_round(v2, read64(p)); p += 8;
            v3 = xxh64_round(v3, read64(p)); p += 8;
            v4 = xxh64_round(v4, read64(p)); p += 8;
        } while (p <= limit);
        h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
        h = xxh64_merge(h, v1);
        h = xxh64_merge(h, v2);
        h = xxh64_merge(h, v3);
        h = xxh64_merge(h, v4);
    } else {
        h = seed + P5;
    }
    h += len;
    while (p + 8 <= end) {
        h ^= xxh64_round(0, read64(p));
        h = rotl64(h, 27) * P1 + P4;
        p += 8;
    }
    if (p + 4 <= end) {
        h ^= (uint64_t)read32(p) * P1;
        h = rotl64(h, 23) * P2 + P3;
        p += 4;
    }
    while (p < end) {
        h ^= (*p) * P5;
        h = rotl64(h, 11) * P1;
        p++;
    }
    h ^= h >> 33; h *= P2; h ^= h >> 29; h *= P3; h ^= h >> 32;
    return h;
}

// ---------------------------------------------------------------- XXH32 ----

static const uint32_t Q1 = 2654435761U;
static const uint32_t Q2 = 2246822519U;
static const uint32_t Q3 = 3266489917U;
static const uint32_t Q4 = 668265263U;
static const uint32_t Q5 = 374761393U;

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

static inline uint32_t xxh32_round(uint32_t acc, uint32_t input) {
    acc += input * Q2;
    acc = rotl32(acc, 13);
    return acc * Q1;
}

uint32_t tz_xxh32(const uint8_t* data, uint64_t len, uint32_t seed) {
    const uint8_t* p = data;
    const uint8_t* end = data + len;
    uint32_t h;
    if (len >= 16) {
        uint32_t v1 = seed + Q1 + Q2, v2 = seed + Q2, v3 = seed, v4 = seed - Q1;
        const uint8_t* limit = end - 16;
        do {
            v1 = xxh32_round(v1, read32(p)); p += 4;
            v2 = xxh32_round(v2, read32(p)); p += 4;
            v3 = xxh32_round(v3, read32(p)); p += 4;
            v4 = xxh32_round(v4, read32(p)); p += 4;
        } while (p <= limit);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + Q5;
    }
    h += (uint32_t)len;
    while (p + 4 <= end) {
        h += read32(p) * Q3;
        h = rotl32(h, 17) * Q4;
        p += 4;
    }
    while (p < end) {
        h += (*p) * Q5;
        h = rotl32(h, 11) * Q1;
        p++;
    }
    h ^= h >> 15; h *= Q2; h ^= h >> 13; h *= Q3; h ^= h >> 16;
    return h;
}

// -------------------------------------------------------- frame assembly ----

// Join per-block device outputs into frames at memcpy speed.
//
// contents: (num_blocks, stride) row-major block bodies
// lens/types: per-block content length and block type (0=Raw,1=RLE,2=Comp)
// raw_lens: per-block REGENERATED length (RLE headers carry this)
// firsts/counts: per-item first block index + block count
// headers: concatenated per-item frame headers; header_lens their lengths
// checks: optional 4-byte checksums per item (NULL = none)
// out: output buffer; returns total bytes written (or -1 if out_cap too small)
int64_t tz_assemble_frames(
    const uint8_t* contents, int64_t stride,
    const int32_t* lens, const int32_t* types, const int32_t* raw_lens,
    const int32_t* firsts, const int32_t* counts, int64_t num_items,
    const uint8_t* headers, const int32_t* header_lens,
    const uint8_t* checks, int64_t out_cap, uint8_t* out)
{
    int64_t w = 0;
    const uint8_t* hp = headers;
    for (int64_t it = 0; it < num_items; ++it) {
        int32_t hl = header_lens[it];
        if (w + hl > out_cap) return -1;
        std::memcpy(out + w, hp, hl);
        hp += hl;
        w += hl;
        int32_t first = firsts[it], cnt = counts[it];
        for (int32_t k = 0; k < cnt; ++k) {
            int64_t b = first + k;
            int32_t last = (k == cnt - 1) ? 1 : 0;
            int32_t type = types[b];
            int32_t clen = (type == 1) ? 1 : lens[b];
            uint32_t size_field = (type == 1) ? (uint32_t)raw_lens[b] : (uint32_t)lens[b];
            uint32_t hdr = (size_field << 3) | ((uint32_t)type << 1) | (uint32_t)last;
            if (w + 3 + clen > out_cap) return -1;
            out[w] = hdr & 0xFF;
            out[w + 1] = (hdr >> 8) & 0xFF;
            out[w + 2] = (hdr >> 16) & 0xFF;
            w += 3;
            std::memcpy(out + w, contents + b * stride, clen);
            w += clen;
        }
        if (checks) {
            if (w + 4 > out_cap) return -1;
            std::memcpy(out + w, checks + it * 4, 4);
            w += 4;
        }
    }
    return w;
}

// ------------------------------------------------------ Huffman decode ----

// Decode one zstd Huffman literal stream (backward bitstream, RFC 8878 §4.2.2).
// dtable: size (1<<table_log) entries packed as (symbol << 8) | nb_bits.
// Returns 0 on success, -1 on malformed stream.
int32_t tz_huf_decode_stream(
    const uint8_t* data, int64_t len,
    const int32_t* dtable, int32_t table_log,
    uint8_t* out, int64_t out_len)
{
    if (len <= 0) return -1;
    uint8_t last = data[len - 1];
    if (last == 0) return -1;
    int sentinel = 31 - __builtin_clz((uint32_t)last);
    int64_t bits_left = (len - 1) * 8 + sentinel;
    const uint32_t tmask = (1u << table_log) - 1;
    for (int64_t i = 0; i < out_len; ++i) {
        // peek table_log bits at [bits_left - table_log, bits_left), zero-filled
        int64_t lo = bits_left - table_log;
        uint32_t peek;
        if (lo >= 0) {
            int64_t byte = lo >> 3;
            int sh = (int)(lo & 7);
            uint32_t v = data[byte];
            if (byte + 1 < len) v |= (uint32_t)data[byte + 1] << 8;
            if (byte + 2 < len) v |= (uint32_t)data[byte + 2] << 16;
            if (byte + 3 < len) v |= (uint32_t)data[byte + 3] << 24;
            peek = (v >> sh) & tmask;
        } else {
            // near stream start: shift available bits to the top (libzstd
            // permissive lookup)
            int64_t have = bits_left > 0 ? bits_left : 0;
            uint32_t v = 0;
            int64_t nbytes = (have + 7) >> 3;
            for (int64_t b = 0; b < nbytes && b < 4; ++b) v |= (uint32_t)data[b] << (8 * b);
            v &= (have >= 32) ? 0xFFFFFFFFu : ((1u << have) - 1);
            peek = (uint32_t)((uint64_t)v << (table_log - have)) & tmask;
        }
        int32_t e = dtable[peek];
        out[i] = (uint8_t)(e >> 8);
        bits_left -= (e & 0xFF);
        if (bits_left < -8) return -1;
    }
    if (bits_left != 0) return -1;
    return 0;
}

}  // extern "C"
