// Building blocks of the f32 attention kernels (the `*_f32` entry points of
// flash_attention_fwd.cu, flash_attention_bwd.cu and
// flash_attention_bwd_dkv.cu): plain CUDA, FFMA on the CUDA cores.
//
// The tensor cores take no f32 operands: their nearest type, TF32, keeps 10
// bits of mantissa, about three decimal digits, and the reference's f32
// kernels compute in full f32.  So these kernels run on the CUDA cores
// (67 TFLOP/s on an H100 SXM against the tensor cores' 989 in bf16), which
// bound them: at the serving and training shapes the work is thousands of
// operations per byte.  Their design is the plain one for that bound:
// * a block of 256 threads (16 x 16: ty picks rows, tx columns) works on
//   square tiles of kT rows (64; 32 at D = 256, so that four tiles of
//   256 f32 columns fit in shared memory), staged in shared memory by
//   16-byte loads from the tensors' own strides, rows past S as zeros;
// * a product of two [kT, D] tiles over D (S = Q.K^T, dP = dO.V^T) gives
//   each thread a register micro-tile of rows ty + 16i and columns
//   tx + 16j, read from shared memory 4 columns at a time (rows padded by
//   4 floats, so the 16 rows a warp reads at once fall on distinct banks);
// * a product of a [kT, kT] tile (P, dS) with a [kT, D] tile (V, K, Q, dO)
//   gives each thread rows ty + 16i and the 4-column groups 64g + 4tx, so
//   a warp reads 16 contiguous 16-byte groups of the [kT, D] tile at once;
// * a row's softmax statistics are reduced over the 16 lanes that hold the
//   row with warp shuffles.
// On an H100 80GB HBM3 at 700 W this reads 37% of the f32 rate in the
// forward (B1 at (8, 2048, 32, 8, 128), causal: 10.98 ms against 4.10) and
// 41-45% in the backward (B2 and B3 at (8, 2048, 16, 8, 128): 7.45 and
// 9.12 ms against 3.08 and 4.10), about half the time of the plain f32
// version and of SDPA's f32 path (PERF.md's kernel table).
// A later design that reaches the tensor cores at f32 accuracy splits each
// operand into two TF32 parts and runs three products (3xTF32); it needs
// both operands of every product K-major, which V, dO and Q are not here.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace simt {

constexpr int kThreads = 256;

template <int D>
struct Tiles {
  static_assert(D % 64 == 0 && D <= 256, "head dims 64, 128, 256");
  static constexpr int kT = D == 256 ? 32 : 64;  // rows of every tile
  static constexpr int kLD = D + 4;      // row stride of a [kT, D] tile
  static constexpr int kLDP = kT + 16;   // row stride of a [kT, kT] tile
  static constexpr int kRI = kT / 16;    // a thread's rows (and columns)
  static constexpr int kG = D / 64;      // a thread's 4-column groups of D
  static constexpr int kTile = kT * kLD;     // floats of a [kT, D] tile
  static constexpr int kSquare = kT * kLDP;  // floats of a [kT, kT] tile
};

// Rows [row0, row0 + kT) of head `head`, batch `b` of a [B, S, heads, D]
// f32 tensor with element strides (sb, ss, sh) into the [kT, D] tile `dst`;
// rows past `seq` as zeros.  Every thread of the block takes part.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          const long long (&st)[3], int b,
                                          int head, int row0, int seq) {
  using C = Tiles<D>;
  constexpr int kVec = D / 4;
  const float* base = src + b * st[0] + head * st[2];
  for (int idx = threadIdx.x; idx < C::kT * kVec; idx += kThreads) {
    const int r = idx / kVec, c = idx % kVec * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < seq) {
      v = *reinterpret_cast<const float4*>(base + (row0 + r) * st[1] + c);
    }
    *reinterpret_cast<float4*>(dst + r * C::kLD + c) = v;
  }
}

// c[i][j] = sum over k of A[ty + 16i][k] * B[tx + 16j][k], k ascending, for
// two [kT, D] tiles A and B.
template <int D>
__device__ __forceinline__ void products_abt(
    float (&c)[Tiles<D>::kRI][Tiles<D>::kRI], const float* A, const float* B,
    int ty, int tx) {
  using C = Tiles<D>;
  constexpr int R = C::kRI;
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < R; ++j) c[i][j] = 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < D; k += 4) {
    float4 a[R], b[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * C::kLD + k);
      b[i] = *reinterpret_cast<const float4*>(B + (tx + 16 * i) * C::kLD + k);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        c[i][j] = fmaf(a[i].x, b[j].x, c[i][j]);
        c[i][j] = fmaf(a[i].y, b[j].y, c[i][j]);
        c[i][j] = fmaf(a[i].z, b[j].z, c[i][j]);
        c[i][j] = fmaf(a[i].w, b[j].w, c[i][j]);
      }
    }
  }
}

// acc[i][g][e] += sum over k < kT of P[ty + 16i][k] * B[k][64g + 4tx + e],
// k ascending, for a [kT, kT] tile P and a [kT, D] tile B.
template <int D>
__device__ __forceinline__ void products_pb(
    float (&acc)[Tiles<D>::kRI][Tiles<D>::kG][4], const float* P,
    const float* B, int ty, int tx) {
  using C = Tiles<D>;
  constexpr int R = C::kRI, G = C::kG;
#pragma unroll 2
  for (int k = 0; k < C::kT; k += 4) {
    float4 pv[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      pv[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * C::kLDP + k);
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float4 bv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        bv[g] = *reinterpret_cast<const float4*>(B + (k + kk) * C::kLD +
                                                 64 * g + 4 * tx);
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float pk = kk == 0 ? pv[i].x : kk == 1 ? pv[i].y
                         : kk == 2 ? pv[i].z : pv[i].w;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[i][g][0] = fmaf(pk, bv[g].x, acc[i][g][0]);
          acc[i][g][1] = fmaf(pk, bv[g].y, acc[i][g][1]);
          acc[i][g][2] = fmaf(pk, bv[g].z, acc[i][g][2]);
          acc[i][g][3] = fmaf(pk, bv[g].w, acc[i][g][3]);
        }
      }
    }
  }
}

// acc's rows (row0 + ty + 16i, those below `seq`) into head `head`, batch
// `b` of a [B, S, heads, D] f32 tensor with element strides st.
template <int D>
__device__ __forceinline__ void store_rows(
    float* dst, const long long (&st)[3],
    const float (&acc)[Tiles<D>::kRI][Tiles<D>::kG][4], int b, int head,
    int row0, int seq, int ty, int tx) {
  using C = Tiles<D>;
  float* base = dst + b * st[0] + head * st[2];
#pragma unroll
  for (int i = 0; i < C::kRI; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= seq) continue;
#pragma unroll
    for (int g = 0; g < C::kG; ++g) {
      *reinterpret_cast<float4*>(base + row * st[1] + 64 * g + 4 * tx) =
          make_float4(acc[i][g][0], acc[i][g][1], acc[i][g][2], acc[i][g][3]);
    }
  }
}

// The largest (or the sum) over the 16 lanes that hold one row.
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A scaled score z and, with the cap, c * tanh(z / c) and its derivative
// 1 - tanh^2 (the reference's order: scale, then cap).
template <bool kCap>
__device__ __forceinline__ float capped(float z, float softcap, float& dcap) {
  dcap = 1.f;
  if constexpr (kCap) {
    const float t = tanhf(z / softcap);
    dcap = 1.f - t * t;
    return t * softcap;
  }
  return z;
}

// Dynamic shared memory above 48 KB must be asked for before a launch.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace simt
