// Hopper (sm_90a) building blocks for the port's hand-written kernels:
// mbarriers, TMA tensor-map loads and stores, wgmma shared-memory
// descriptors and products, register reallocation (setmaxnreg), named
// barriers, the persistent grid's tile walk, the host-side tensor-map
// encoder, and the mask value and bf16 packing the attention kernels
// share.
//
// Shared-memory tiles are what TMA writes under CU_TENSOR_MAP_SWIZZLE_128B:
// a tile of R rows x 64 bf16 columns (one 128-byte row each) whose 16-byte
// column groups are XORed with (row % 8) inside every 1024-byte block of 8
// rows.  A tile of R x D is D / 64 such tiles one after another ("chunks").
// Every chunk starts on a 1024-byte boundary, so the swizzle phase of a row
// is its row index modulo 8.
//
// wgmma reads such tiles through 64-bit descriptors (start address >> 4,
// leading and stride byte offsets >> 4, layout 1 = 128-byte swizzle):
// * K-major (Q and K for S = Q.K^T: the reduced dimension D is contiguous):
//   SBO = 1024 (the next 8 rows); LBO is unused.  One k16 step is 32 bytes
//   inside a chunk: step kk starts at chunk kk / 4, byte (kk % 4) * 32.
// * MN-major (V for O += P.V: the reduced dimension is the row, the output
//   dimension D contiguous; the instruction's transpose bit for B is set):
//   LBO = one chunk's bytes (the next 64 output columns), SBO = 1024 (the
//   next 8 rows of the reduced dimension); k16 step kk starts 16 rows, 2048
//   bytes, further.
//
// Fragment layouts (PTX ISA, "wgmma register fragments"): warp w of the
// warpgroup owns rows 16w..16w+15 of the 64-row tile, and lane = 4g + t.
// * Accumulator of m64nNk16 (f32): d[4j + 2i + e] is row 16w + g + 8i,
//   column 8j + 2t + e (j < N / 8).
// * A from registers (bf16, m64k16): a[0] rows 16w + g, columns 2t..2t+1;
//   a[1] row + 8, same columns; a[2] and a[3] the same rows, columns + 8.
// So the accumulators of columns 16kk..16kk+15 (j = 2kk, 2kk + 1), packed to
// bf16 pairs, are the A operand of k16 step kk of the next product.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; no driver call is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr float kNegInf = -1e30f;  // JAX's mask value (not -inf)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two f32 values as one register of two bf16, lo in the low half: the
// element order of a wgmma A fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive and add `bytes` to the transactions this phase waits for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- TMA

// Copy the box at coordinates (c0, c1, c2, c3) of a 4-D map into shared
// memory; the bytes complete a transaction on `bar`.  Rows outside the
// tensor arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// Copy a box from shared memory to the tensor; rows outside it are dropped.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Wait until the issued stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Orders this thread's shared-memory writes before later async-proxy
// (TMA, wgmma) reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ------------------------------------------------- barriers and registers

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Every warp of the warpgroup executes these together; the kernel must
// split into roles with one if/else that never reconverges, or ptxas drops
// them (warning C7508).
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------- wgmma

// Descriptor of a 128-byte-swizzled operand starting at shared address
// `addr` (the layout note at the head of this file).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties accumulator registers to this point of the program, so the compiler
// moves no read or write of them across a wgmma fence or wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HOPPER_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),              \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// The products used by the port's kernels (bf16 in, f32 accumulators).

// d (+)= A . B for one k16 step, A (64 x 16) and B (16 x 64) both K-major in
// shared memory; scale_d = 0 overwrites d instead of adding to it.
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d (+)= A . B for one k16 step, A (64 x 16) and B (16 x 128) both K-major in
// shared memory; scale_d = 0 overwrites d instead of adding to it.
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40),
        HOPPER_D8(48), HOPPER_D8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d += A . B for one k16 step, A (64 x 16 bf16) from registers in the
// accumulator layout, B (16 x 64) MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A . B for one k16 step, A (64 x 16 bf16) from registers in the
// accumulator layout, B (16 x 128) MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40),
        HOPPER_D8(48), HOPPER_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d += A . B for one k16 step, A (64 x 16 bf16) from registers in the
// accumulator layout, B (16 x 256) MN-major in shared memory (transpose bit).
__device__ __forceinline__ void wgmma_rs_m64n256(float (&d)[128],
                                                const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : HOPPER_D8(0), HOPPER_D8(8), HOPPER_D8(16), HOPPER_D8(24), HOPPER_D8(32), HOPPER_D8(40),
        HOPPER_D8(48), HOPPER_D8(56), HOPPER_D8(64), HOPPER_D8(72), HOPPER_D8(80), HOPPER_D8(88),
        HOPPER_D8(96), HOPPER_D8(104), HOPPER_D8(112), HOPPER_D8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef HOPPER_D8

template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  static_assert(N == 64 || N == 128, "no such instantiation");
  if constexpr (N == 64) wgmma_ss_m64n64(d, a, b, scale_d);
  else wgmma_ss_m64n128(d, a, b, scale_d);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 64 || N == 128 || N == 256, "no such instantiation");
  if constexpr (N == 64) wgmma_rs_m64n64(d, a, b);
  else if constexpr (N == 128) wgmma_rs_m64n128(d, a, b);
  else wgmma_rs_m64n256(d, a, b);
}

// --------------------------------------------------------- persistent grid

// The n-th work tile of this block in a persistent grid: rounds of gridDim.x
// tiles of the walk 0, 1, 2, ..., taken in block order in even rounds and in
// reverse in odd ones ("snake"), so that when the walk runs from the longest
// tiles to the shortest, a block given one of the longest of a round gets
// one of the shortest of the next.  Past the end of the walk every later n
// is past it too.
__device__ __forceinline__ int snake_tile(int n) {
  const int g = gridDim.x;
  return n * g + (n % 2 ? g - 1 - static_cast<int>(blockIdx.x)
                        : static_cast<int>(blockIdx.x));
}

// ------------------------------------------------------------ host side

// cuTensorMapEncodeTiled, fetched from the driver through the runtime, so
// the library needs no link against libcuda.  Null when the driver lacks it.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p)
               : nullptr;
  }();
  return fn;
}

// A 4-D map over a bf16 [B, S, heads, D] tensor with element strides
// (sb, ss, sh) and a contiguous last dimension; dimensions innermost first:
// (D, heads, S, B).  A box is 64 columns x 1 head x `rows` rows x 1 batch,
// 128-byte swizzled; rows past S load as zeros and are not stored.  A
// dimension of size 1 gets a packed stride, which no coordinate reads.
inline cudaError_t make_bshd_map(CUtensorMap* map, const void* base,
                                 int batch, int seq, int heads, int d,
                                 long long sb, long long ss, long long sh,
                                 int rows) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const long long elems[3] = {sh, ss, sb};
  cuuint64_t strides[3];
  long long packed = d;
  for (int i = 0; i < 3; ++i) {
    strides[i] = 2ull * static_cast<cuuint64_t>(dims[i + 1] == 1 ? packed
                                                                 : elems[i]);
    packed *= static_cast<long long>(dims[i + 1]);
  }
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
