// Device helpers shared by the flash-attention kernels (flash_attention_fwd.cu
// and flash_attention_bwd.cu): cp.async tile loads into padded shared tiles,
// ldmatrix fragment loads and the bf16 mma.sync m16n8k16 product.
//
// Fragment layout of mma.sync m16n8k16 (lane = 4 * g + tig):
// * A (16 x 16, row-major): a[0] rows g, cols 2tig..+1; a[1] rows g + 8,
//   cols 2tig..+1; a[2] rows g, cols 8 + 2tig..+1; a[3] rows g + 8, same.
// * B (16 x 8): b0 holds k rows 2tig..+1 of column g, b1 k rows 8 + 2tig..+1.
// * C (16 x 8, f32): c[0..1] row g, cols 2tig..+1; c[2..3] row g + 8.
// So the C fragments of two adjacent n8 tiles are, once packed to bf16, the A
// fragment of a k16 step: a product's output feeds the next product from
// registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kTileRows = 64;  // rows of every Q / K / V / dO tile
constexpr int kWarps = 4;      // one m16 row slice of the tile per warp
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // JAX's mask value (not -inf)

static_assert(kTileRows == kWarps * 16, "one m16 row tile per warp");

// A [64][D + 8] bf16 tile: the pad staggers rows over the banks for ldmatrix.
template <int D>
struct Tile {
  static constexpr int kLd = D + 8;
  static constexpr int kElems = kTileRows * kLd;
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * kElems;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row-major) * b (16x8, column-major), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k16 step kk from the C fragments of n8 tiles 2kk, 2kk + 1.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// A fragment of rows [r0, r0 + 16), columns [c0, c0 + 16) of a padded tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int r0,
                                       int c0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(a, tile + (r0 + lane % 8 + (lane / 8 % 2) * 8) * Tile<D>::kLd +
                     c0 + (lane / 16) * 8);
}

// B fragments of two adjacent n8 tiles for a product X . T^T, where T is a
// row-major tile: b[0..1] for rows [r0, r0 + 8), b[2..3] for rows
// [r0 + 8, r0 + 16), both over columns [c0, c0 + 16) (the k16 step).
template <int D>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile, int r0,
                                            int c0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4(b, tile + (r0 + lane % 8 + (lane / 16) * 8) * Tile<D>::kLd +
                     c0 + (lane / 8 % 2) * 8);
}

// B fragments of two adjacent n8 tiles for a product X . T, where T is a
// row-major tile read transposed (ldmatrix.trans): k rows [r0, r0 + 16),
// b[0..1] for columns [c0, c0 + 8), b[2..3] for columns [c0 + 8, c0 + 16).
template <int D>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[4],
                                            const __nv_bfloat16* tile, int r0,
                                            int c0) {
  const int lane = threadIdx.x % 32;
  ldmatrix_x4_trans(b, tile + (r0 + lane % 8 + (lane / 8 % 2) * 8) *
                                  Tile<D>::kLd +
                           c0 + (lane / 16) * 8);
}

// Start copying rows [row0, row0 + 64) of one head into a padded shared
// tile, 16 bytes per thread per step; rows at or past `seq` (the ragged
// edge) become zeros.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long row_stride, int row0,
                                          int seq) {
  constexpr int kVecs = D / 8;
  for (int i = threadIdx.x; i < kTileRows * kVecs; i += kThreads) {
    const int r = i / kVecs;
    const int c = (i % kVecs) * 8;
    const bool valid = row0 + r < seq;
    const __nv_bfloat16* from = valid ? src + (row0 + r) * row_stride + c : src;
    cp_async_16(dst + r * Tile<D>::kLd + c, from, valid ? 16 : 0);
  }
}

}  // namespace flash
