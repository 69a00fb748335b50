// CRC-32C (Castagnoli) for the data path: TFRecord framing and the
// TensorBoard event writer checksum every payload (reference: the C++
// crc32c library TensorFlow links; SURVEY §2.1 — data loaders are
// native where they are hot).  Python's stdlib only ships CRC-32
// (0x04C11DB7); the pure-Python Castagnoli loop runs ~10 MB/s, which
// makes the checksum — not the disk — the bottleneck when writing
// datasets.  Here: SSE4.2 hardware CRC when the CPU has it (~GB/s),
// slice-by-8 tables otherwise.  Plain-C ABI, consumed via ctypes.

#include <cstddef>
#include <cstdint>

static uint32_t T[8][256];

static struct TableInit {
    TableInit() {
        for (int i = 0; i < 256; i++) {
            uint32_t c = (uint32_t)i;
            for (int k = 0; k < 8; k++)
                c = (c & 1u) ? (c >> 1) ^ 0x82F63B78u : c >> 1;
            T[0][i] = c;
        }
        for (int i = 0; i < 256; i++) {
            uint32_t c = T[0][i];
            for (int j = 1; j < 8; j++) {
                c = T[0][c & 0xFFu] ^ (c >> 8);
                T[j][i] = c;
            }
        }
    }
} table_init;

static uint32_t crc_sw(const uint8_t *p, size_t n, uint32_t crc) {
    while (n >= 8) {
        uint32_t lo = (uint32_t)p[0] | ((uint32_t)p[1] << 8)
                      | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
        uint32_t hi = (uint32_t)p[4] | ((uint32_t)p[5] << 8)
                      | ((uint32_t)p[6] << 16) | ((uint32_t)p[7] << 24);
        lo ^= crc;
        crc = T[7][lo & 0xFFu] ^ T[6][(lo >> 8) & 0xFFu]
              ^ T[5][(lo >> 16) & 0xFFu] ^ T[4][lo >> 24]
              ^ T[3][hi & 0xFFu] ^ T[2][(hi >> 8) & 0xFFu]
              ^ T[1][(hi >> 16) & 0xFFu] ^ T[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n--)
        crc = T[0][(crc ^ *p++) & 0xFFu] ^ (crc >> 8);
    return crc;
}

// x86-64 only: the crc32q builtin does not exist in 32-bit mode and
// would fail the whole compile, losing the software path too
#if defined(__x86_64__)
__attribute__((target("sse4.2")))
static uint32_t crc_hw(const uint8_t *p, size_t n, uint32_t crc) {
    uint64_t c64 = crc;
    while (n >= 8) {
        uint64_t v;
        __builtin_memcpy(&v, p, 8);
        c64 = __builtin_ia32_crc32di(c64, v);
        p += 8;
        n -= 8;
    }
    uint32_t c = (uint32_t)c64;
    while (n--)
        c = __builtin_ia32_crc32qi(c, *p++);
    return c;
}
static const bool has_sse42 = __builtin_cpu_supports("sse4.2");
#else
static const bool has_sse42 = false;
static uint32_t crc_hw(const uint8_t *p, size_t n, uint32_t crc) {
    return crc_sw(p, n, crc);
}
#endif

extern "C" uint32_t rt_crc32c(const uint8_t *data, size_t len,
                              uint32_t seed) {
    uint32_t crc = ~seed;
    crc = has_sse42 ? crc_hw(data, len, crc) : crc_sw(data, len, crc);
    return ~crc;
}
