// Shared-memory arena allocator for the object store.
//
// Reference analogue: the plasma store's single-mmap + dlmalloc design
// (src/ray/object_manager/plasma/{store.h,dlmalloc}) — one large mapping per
// node, objects are offsets into it.  The round-1 Python store paid a file
// create + ftruncate + mmap + page-zero per object; this arena pays them
// once per node.
//
// The allocator is a first-fit free list with boundary-tag coalescing.
// Allocator METADATA lives in process-local heap (only the node agent
// allocates/frees); the shm file carries pure object bytes, so attaching
// processes just mmap + offset.  All sizes are 64-byte aligned (cache line).
//
// C ABI (consumed via ctypes from ray_tpu_torch/native/__init__.py):
//   rt_pool_create(path, capacity) -> handle | NULL
//   rt_pool_alloc(handle, size)    -> offset | -1
//   rt_pool_free(handle, offset)
//   rt_pool_used(handle)           -> bytes allocated
//   rt_pool_capacity(handle)       -> bytes total
//   rt_pool_destroy(handle, unlink_file)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t ALIGN = 64;

struct Block {
    uint64_t size;   // bytes of the block (aligned)
    bool free;
};

struct Pool {
    std::string path;
    int fd = -1;
    uint64_t capacity = 0;
    uint64_t used = 0;
    // offset -> block; adjacency by offset drives coalescing
    std::map<uint64_t, Block> blocks;
};

uint64_t align_up(uint64_t n) { return (n + ALIGN - 1) & ~(ALIGN - 1); }

}  // namespace

extern "C" {

void* rt_pool_create(const char* path, uint64_t capacity) {
    int fd = ::open(path, O_RDWR | O_CREAT, 0600);
    if (fd < 0) return nullptr;
    if (::ftruncate(fd, static_cast<off_t>(capacity)) != 0) {
        ::close(fd);
        return nullptr;
    }
    auto* p = new Pool();
    p->path = path;
    p->fd = fd;
    p->capacity = capacity;
    p->blocks[0] = Block{capacity, true};
    return p;
}

int64_t rt_pool_alloc(void* handle, uint64_t size) {
    auto* p = static_cast<Pool*>(handle);
    if (p == nullptr || size == 0) return -1;
    uint64_t need = align_up(size);
    for (auto it = p->blocks.begin(); it != p->blocks.end(); ++it) {
        if (!it->second.free || it->second.size < need) continue;
        uint64_t off = it->first;
        uint64_t remainder = it->second.size - need;
        it->second.free = false;
        it->second.size = need;
        if (remainder >= ALIGN) {
            p->blocks[off + need] = Block{remainder, true};
        } else {
            it->second.size += remainder;  // absorb the sliver
        }
        p->used += it->second.size;
        return static_cast<int64_t>(off);
    }
    return -1;  // caller evicts and retries
}

void rt_pool_free(void* handle, uint64_t offset) {
    auto* p = static_cast<Pool*>(handle);
    if (p == nullptr) return;
    auto it = p->blocks.find(offset);
    if (it == p->blocks.end() || it->second.free) return;
    it->second.free = true;
    p->used -= it->second.size;
    // coalesce with the next block
    auto next = std::next(it);
    if (next != p->blocks.end() && next->second.free &&
        it->first + it->second.size == next->first) {
        it->second.size += next->second.size;
        p->blocks.erase(next);
    }
    // coalesce with the previous block
    if (it != p->blocks.begin()) {
        auto prev = std::prev(it);
        if (prev->second.free &&
            prev->first + prev->second.size == it->first) {
            prev->second.size += it->second.size;
            p->blocks.erase(it);
        }
    }
}

uint64_t rt_pool_used(void* handle) {
    auto* p = static_cast<Pool*>(handle);
    return p ? p->used : 0;
}

uint64_t rt_pool_capacity(void* handle) {
    auto* p = static_cast<Pool*>(handle);
    return p ? p->capacity : 0;
}

uint64_t rt_pool_num_blocks(void* handle) {
    auto* p = static_cast<Pool*>(handle);
    return p ? p->blocks.size() : 0;
}

// Size of the allocated block at `offset`, or 0 when offset is not the
// start of a live allocation.  Lets the Python layer sanity-check a
// deferred (pin-held) free target before completing it.
uint64_t rt_pool_block_size(void* handle, uint64_t offset) {
    auto* p = static_cast<Pool*>(handle);
    if (p == nullptr) return 0;
    auto it = p->blocks.find(offset);
    if (it == p->blocks.end() || it->second.free) return 0;
    return it->second.size;
}

// Largest free block — the fragmentation signal surfaced by store stats
// and the `raytpu memory` report (a full-looking arena whose largest free
// block is tiny is fragmented, not out of capacity).
uint64_t rt_pool_largest_free(void* handle) {
    auto* p = static_cast<Pool*>(handle);
    if (p == nullptr) return 0;
    uint64_t best = 0;
    for (const auto& kv : p->blocks) {
        if (kv.second.free && kv.second.size > best) best = kv.second.size;
    }
    return best;
}

// Free-block sizes, written into the caller's buffer (up to max_n).
// Returns the TOTAL number of free blocks, which may exceed max_n — the
// caller then knows its histogram is a sample.  Feeds the arena
// fragmentation report (`raytpu memory`, raytpu_mem_arena_frag_fraction).
uint64_t rt_pool_free_blocks(void* handle, uint64_t* out, uint64_t max_n) {
    auto* p = static_cast<Pool*>(handle);
    if (p == nullptr) return 0;
    uint64_t n = 0;
    for (const auto& kv : p->blocks) {
        if (!kv.second.free) continue;
        if (out != nullptr && n < max_n) out[n] = kv.second.size;
        ++n;
    }
    return n;
}

void rt_pool_destroy(void* handle, int unlink_file) {
    auto* p = static_cast<Pool*>(handle);
    if (p == nullptr) return;
    if (p->fd >= 0) ::close(p->fd);
    if (unlink_file) ::unlink(p->path.c_str());
    delete p;
}

}  // extern "C"
