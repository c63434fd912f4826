// Native data plane for the socket transport (comm/socket_transport.py).
//
// The reference moves experience between hosts through gRPC's C++ core
// (SURVEY.md §2.2 "Comm: gRPC"); the TPU-native equivalent keeps the
// wire hot path out of Python the same way: message assembly (gather
// many numpy buffers into one length-prefixed frame) and integrity
// checksums run in this compiled module, invoked via ctypes with
// zero-copy pointers. Python only decides WHAT to send; bytes move here.
//
// Build: g++ -O3 -shared -fPIC framing.cpp -o libapex_framing.so
// (done lazily by ape_x_dqn_tpu/comm/native.py and cached).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// CRC-32 (IEEE 802.3, reflected 0xEDB88320), slice-by-8, one pass.
// Matches zlib.crc32 so the Python fallback is wire-compatible. The
// byte-at-a-time table loop this replaces ran at ~190 MB/s — slower
// than the memcpy it was guarding, and the single largest cost on the
// shm slot path, which crcs the full RAW payload per post (the TCP
// path only crcs the post-deflate bytes). Slice-by-8 processes two
// 32-bit words per step through eight derived tables (~1.5 GB/s),
// putting the checksum back under the copy it protects.
static uint32_t CRC_TABLE[8][256];
static bool crc_init_done = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = i;
        for (int k = 0; k < 8; ++k)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        CRC_TABLE[0][i] = c;
    }
    // table[t][b] = crc of byte b followed by t zero bytes: lets one
    // step fold 8 input bytes with 8 independent lookups
    for (uint32_t i = 0; i < 256; ++i) {
        uint32_t c = CRC_TABLE[0][i];
        for (int t = 1; t < 8; ++t) {
            c = CRC_TABLE[0][c & 0xFFu] ^ (c >> 8);
            CRC_TABLE[t][i] = c;
        }
    }
    crc_init_done = true;
}

uint32_t apex_crc32(const uint8_t* buf, uint64_t len, uint32_t seed) {
    if (!crc_init_done) crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__
    // the word folding below assumes little-endian lane order; the
    // byte loop after it is the (correct) big-endian fallback
    while (len >= 8) {
        uint32_t lo, hi;  // memcpy: unaligned-safe, aliasing-clean
        std::memcpy(&lo, buf, 4);
        std::memcpy(&hi, buf + 4, 4);
        lo ^= c;
        c = CRC_TABLE[7][lo & 0xFFu] ^ CRC_TABLE[6][(lo >> 8) & 0xFFu]
          ^ CRC_TABLE[5][(lo >> 16) & 0xFFu] ^ CRC_TABLE[4][lo >> 24]
          ^ CRC_TABLE[3][hi & 0xFFu] ^ CRC_TABLE[2][(hi >> 8) & 0xFFu]
          ^ CRC_TABLE[1][(hi >> 16) & 0xFFu] ^ CRC_TABLE[0][hi >> 24];
        buf += 8;
        len -= 8;
    }
#endif
    while (len--)
        c = CRC_TABLE[0][(c ^ *buf++) & 0xFFu] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// Gather n source buffers into dst as consecutive [u64 length][bytes]
// records, returning the total bytes written. dst must hold
// sum(lens) + 8*n bytes. Returns 0 on null input.
uint64_t apex_pack(uint8_t* dst, const uint8_t** srcs,
                   const uint64_t* lens, uint64_t n) {
    if (!dst || !srcs || !lens) return 0;
    uint64_t off = 0;
    for (uint64_t i = 0; i < n; ++i) {
        std::memcpy(dst + off, &lens[i], 8);
        off += 8;
        std::memcpy(dst + off, srcs[i], lens[i]);
        off += lens[i];
    }
    return off;
}

// Split a packed frame back into record offsets/lengths (the inverse of
// apex_pack's framing). offsets/lengths must hold max_records entries.
// Returns the number of records parsed, or (uint64_t)-1 on a malformed
// frame (record overruns the buffer).
uint64_t apex_unpack_offsets(const uint8_t* buf, uint64_t len,
                             uint64_t* offsets, uint64_t* lengths,
                             uint64_t max_records) {
    uint64_t off = 0, i = 0;
    while (off < len && i < max_records) {
        if (off + 8 > len) return (uint64_t)-1;
        uint64_t rec_len;
        std::memcpy(&rec_len, buf + off, 8);
        off += 8;
        if (off + rec_len > len) return (uint64_t)-1;
        offsets[i] = off;
        lengths[i] = rec_len;
        off += rec_len;
        ++i;
    }
    return (off == len) ? i : (uint64_t)-1;
}

// XOR one row against another, word-wise with a byte tail. The wire
// codec's delta transform (comm/socket_transport.py "delta-deflate"):
// temporally adjacent frame rows XOR to mostly-zero bytes, which
// deflate then collapses.
static inline void xor_row(uint8_t* dst, const uint8_t* a,
                           const uint8_t* b, uint64_t n) {
    uint64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t wa, wb;
        std::memcpy(&wa, a + i, 8);
        std::memcpy(&wb, b + i, 8);
        wa ^= wb;
        std::memcpy(dst + i, &wa, 8);
    }
    for (; i < n; ++i) dst[i] = a[i] ^ b[i];
}

// Encode: dst row 0 = src row 0 (raw anchor); dst row i = src[i] ^
// src[i-1]. dst and src must not alias.
void apex_delta_encode(uint8_t* dst, const uint8_t* src, uint64_t rows,
                       uint64_t row_bytes) {
    if (!dst || !src || rows == 0) return;
    std::memcpy(dst, src, row_bytes);
    for (uint64_t r = 1; r < rows; ++r)
        xor_row(dst + r * row_bytes, src + r * row_bytes,
                src + (r - 1) * row_bytes, row_bytes);
}

// Decode IN PLACE: buf[i] ^= buf[i-1] for i = 1..rows-1 — the prefix
// undo that turns landed delta rows back into absolute rows directly in
// the preallocated staging block (row 0 must already be absolute; the
// caller XORs the continuation row in when a batch splits across
// staging buffers).
void apex_delta_undo(uint8_t* buf, uint64_t rows, uint64_t row_bytes) {
    if (!buf) return;
    for (uint64_t r = 1; r < rows; ++r)
        xor_row(buf + r * row_bytes, buf + r * row_bytes,
                buf + (r - 1) * row_bytes, row_bytes);
}

// int8 affine quantization of a float32 param delta (the parameter-
// plane codec, comm/param_codec.py "delta-q8"): q = clip(rint((x-lo)/
// scale) - 127, -128, 127). Bit-parity with the numpy fallback is a
// wire contract — both sides of a delta chain must reconstruct the
// SAME float32 base or the drift outlives the quantization bound — so
// every operation stays strict single-precision in the same order as
// the numpy expression, and rounding is nearbyintf under the default
// round-to-nearest-even mode (== np.rint).
void apex_q8_encode(int8_t* dst, const float* src, uint64_t n,
                    float lo, float scale) {
    if (!dst || !src || scale == 0.0f) return;
    for (uint64_t i = 0; i < n; ++i) {
        float r = nearbyintf((src[i] - lo) / scale) - 127.0f;
        if (r < -128.0f) r = -128.0f;
        if (r > 127.0f) r = 127.0f;
        dst[i] = (int8_t)r;
    }
}

// Dequantize-and-accumulate: base[i] += (q[i] + 127) * scale + lo —
// the decode side of apex_q8_encode AND the encoder's own chain
// advance (the encoder reconstructs exactly what decoders will hold,
// so quantization error never compounds across versions). Same strict
// f32 op order as the numpy fallback.
void apex_q8_dequant_add(float* base, const int8_t* q, uint64_t n,
                         float lo, float scale) {
    if (!base || !q) return;
    for (uint64_t i = 0; i < n; ++i) {
        float d = ((float)q[i] + 127.0f) * scale;
        base[i] += d + lo;
    }
}

}  // extern "C"
