// Native submission plane: packed spec-batch frame pack/scan.
//
// A warm push batch wire-encodes into ONE flat frame instead of N pickled
// tuples (see core/spec_cache.py for the layout contract):
//
//   "SP01" | u32 count
//   per record:
//     thash(16) | task_id(16) | retry u32 | seq u64 | args_len u32
//     | trace_len u32 | args bytes | trace bytes
//
// All integers little-endian, headers packed (no padding) — the layout
// MUST stay byte-identical to the pure-Python struct packer/scanner
// (spec_cache._py_pack / unpack_specs), which is the fallback when this
// .so is absent.  Plain C ABI, consumed via ctypes (no pybind11 in the
// image — same toolchain as shm_pool.cpp / crc32c.cpp).

#include <cstdint>
#include <cstring>

namespace {
constexpr uint64_t kRecFixed = 52;  // 16 + 16 + 4 + 8 + 4 + 4
}

extern "C" {

// Pack n records into `out` (caller sized it exactly); returns bytes
// written, or -1 when the buffer cannot hold the frame.
int64_t sp_pack(uint8_t* out, uint64_t cap, uint32_t n,
                const uint8_t* thash, const uint8_t* task_ids,
                const uint32_t* retries, const uint64_t* seqs,
                const uint8_t* const* args_ptrs, const uint32_t* args_lens,
                const uint8_t* const* trace_ptrs,
                const uint32_t* trace_lens) {
    if (cap < 8) return -1;
    out[0] = 'S'; out[1] = 'P'; out[2] = '0'; out[3] = '1';
    std::memcpy(out + 4, &n, 4);
    uint64_t off = 8;
    for (uint32_t i = 0; i < n; i++) {
        const uint32_t alen = args_lens[i], tlen = trace_lens[i];
        if (off + kRecFixed + (uint64_t)alen + tlen > cap) return -1;
        std::memcpy(out + off, thash + (uint64_t)i * 16, 16);
        std::memcpy(out + off + 16, task_ids + (uint64_t)i * 16, 16);
        std::memcpy(out + off + 32, &retries[i], 4);
        std::memcpy(out + off + 36, &seqs[i], 8);
        std::memcpy(out + off + 44, &alen, 4);
        std::memcpy(out + off + 48, &tlen, 4);
        off += kRecFixed;
        if (alen) { std::memcpy(out + off, args_ptrs[i], alen); off += alen; }
        if (tlen) { std::memcpy(out + off, trace_ptrs[i], tlen); off += tlen; }
    }
    return (int64_t)off;
}

// Scan a frame: fill per-record offsets + header fields so Python only
// slices payload views.  Returns the record count, or -1 on a malformed/
// truncated frame (the receiver raises before dispatching anything).
int32_t sp_scan(const uint8_t* blob, uint64_t len, uint32_t max_n,
                uint64_t* rec_offs, uint32_t* retries, uint64_t* seqs,
                uint32_t* args_lens, uint32_t* trace_lens) {
    if (len < 8 || blob[0] != 'S' || blob[1] != 'P' || blob[2] != '0' ||
        blob[3] != '1')
        return -1;
    uint32_t n;
    std::memcpy(&n, blob + 4, 4);
    if (n > max_n) return -1;
    uint64_t off = 8;
    for (uint32_t i = 0; i < n; i++) {
        if (off + kRecFixed > len) return -1;
        rec_offs[i] = off;
        uint32_t alen, tlen;
        std::memcpy(&retries[i], blob + off + 32, 4);
        std::memcpy(&seqs[i], blob + off + 36, 8);
        std::memcpy(&alen, blob + off + 44, 4);
        std::memcpy(&tlen, blob + off + 48, 4);
        args_lens[i] = alen;
        trace_lens[i] = tlen;
        off += kRecFixed + (uint64_t)alen + tlen;
        if (off > len) return -1;
    }
    return (int32_t)n;
}

}  // extern "C"
