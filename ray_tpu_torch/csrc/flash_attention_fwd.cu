// Flash-attention forward for Hopper (sm_90a), bf16 in, bf16 out + f32 lse.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` driven by `_flash_fwd` in
// ray_tpu/ops/flash_attention.py.  It computes the same function: causal or
// full attention with an online softmax (running max m, denominator l and
// numerator acc in f32), GQA K/V read in place through kv head h / (H / KV),
// scores scaled by D^-0.5 and masked with -1e30 (not -inf, so no row gives a
// NaN), P cast to bf16 for the P.V product, l clamped at 1e-30, and
// lse = m + log(l) written as [B, H, S].
//
// What bounds it on the card: at the serving path's prefill shapes (S >= 1024,
// D = 128) the work is ~4*S^2*D/2 operations for every (batch, head) against
// ~4*S*D*2 bytes of q/k/v/out, i.e. hundreds of operations per byte, so the
// kernel is bound by tensor-core operations, not by memory.  What the design
// does about it:
// * the S x S score matrix never leaves the chip: one 64 x 64 tile of scores
//   lives in registers at a time;
// * both products run on the tensor cores (`mma.sync` m16n8k16, bf16 inputs,
//   f32 accumulators); the score accumulators are re-packed in registers as
//   the A operand of P.V, and the output accumulator and the softmax state
//   stay in registers for the whole K/V loop;
// * K/V tiles are double-buffered with `cp.async`, so the load of tile j+1
//   overlaps the products of tile j;
// * K/V tiles past the causal diagonal are skipped (per block, and per warp
//   within the diagonal tile), and the longest causal rows start first.
// It does not use `wgmma` or TMA yet, so it stays below the card's peak.
//
// Layout: q [B, S, H, D], k/v [B, S, KV, D] are read through element strides
// (the innermost dimension must be contiguous, every other stride a multiple
// of 8 and every base pointer 16-byte aligned); out has its own strides; lse
// is a contiguous [B, H, S] f32 array.  One thread block of 4 warps takes one
// (q tile of 64 rows, head, batch); each warp owns 16 rows of the tile.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = kTileRows;
constexpr int kBlockKV = kTileRows;

// Shared memory: the Q tile, then two K and two V buffers.
template <int D>
struct Smem {
  static constexpr int kLd = Tile<D>::kLd;
  static constexpr int kTile = Tile<D>::kElems;  // elements per tile
  static constexpr size_t kBytes = 5 * Tile<D>::kBytes;
  static_assert(kBytes <= 232448, "above the 227 KB a block may use");
};

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  float* lse;
  int seq, heads, kv_heads, causal;
  float scale;
  long long q_sb, q_ss, q_sh;  // element strides: batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  constexpr int kLd = Smem<D>::kLd;
  constexpr int kTile = Smem<D>::kTile;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sK = sQ + kTile;      // two buffers
  __nv_bfloat16* sV = sK + 2 * kTile;  // two buffers

  // Highest q tiles first: under causal masking they loop over the most
  // K/V tiles, so they should not be the stragglers of the grid.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * kBlockQ;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wr = warp * 16;          // this warp's first row in the tile
  const int g = lane / 4;            // mma fragment row (and row + 8)
  const int tig = lane % 4;          // mma fragment column pair
  const int lm_r = lane % 8;         // ldmatrix: row within a matrix
  const int lm_m = lane / 8;         // ldmatrix: which of the 4 matrices
  const int row0 = q0 + wr + g;      // the two query rows this thread holds
  const int row1 = row0 + 8;

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  int n_kv = (p.seq + kBlockKV - 1) / kBlockKV;
  if (p.causal) {
    // K/V tiles strictly after this q tile's diagonal are fully masked.
    n_kv = min(n_kv, (q0 + kBlockQ + kBlockKV - 1) / kBlockKV);
  }

  load_tile<D>(sQ, qb, p.q_ss, q0, p.seq);
  load_tile<D>(sK, kb, p.k_ss, 0, p.seq);
  load_tile<D>(sV, vb, p.v_ss, 0, p.seq);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max of rows row0, row1
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < n_kv) {
      const int nb = (j + 1) % 2;
      load_tile<D>(sK + nb * kTile, kb, p.k_ss, (j + 1) * kBlockKV, p.seq);
      load_tile<D>(sV + nb * kTile, vb, p.v_ss, (j + 1) * kBlockKV, p.seq);
    }
    cp_async_commit();

    const int k0 = j * kBlockKV;
    // every row of this warp lies before the tile: fully masked, skip
    if (p.causal && k0 > q0 + wr + 15) continue;
    const __nv_bfloat16* cK = sK + (j % 2) * kTile;
    const __nv_bfloat16* cV = sV + (j % 2) * kTile;

    // S = Q K^T: 16 rows x 64 columns per warp, as 8 n8 accumulator tiles.
    float s[kBlockKV / 8][4];
#pragma unroll
    for (int t = 0; t < kBlockKV / 8; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, sQ + (wr + lm_r + (lm_m % 2) * 8) * kLd + kk +
                         (lm_m / 2) * 8);
#pragma unroll
      for (int t = 0; t < kBlockKV / 8; t += 2) {
        uint32_t bk[4];
        ldmatrix_x4(bk, cK + (t * 8 + lm_r + (lm_m / 2) * 8) * kLd + kk +
                            (lm_m % 2) * 8);
        mma_bf16(s[t], a, bk[0], bk[1]);
        mma_bf16(s[t + 1], a, bk[2], bk[3]);
      }
    }

    // Scale, mask, and the online softmax update, all in registers.  A
    // thread holds columns k0 + 8t + 2tig + {0, 1} of rows row0 (s[t][0..1])
    // and row1 (s[t][2..3]); the 4 threads of a row group share a row.
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int t = 0; t < kBlockKV / 8; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + t * 8 + tig * 2 + (i % 2);
        const int qpos = i < 2 ? row0 : row1;
        float x = s[t][i] * p.scale;
        if (p.causal && qpos < kpos) x = kNegInf;
        if (kpos >= p.seq) x = -INFINITY;  // past the ragged edge: no column
        s[t][i] = x;
        mx[i / 2] = fmaxf(mx[i / 2], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    float rowsum[2] = {0.f, 0.f};
#pragma unroll
    for (int t = 0; t < kBlockKV / 8; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[t][i] = expf(s[t][i] - m[i / 2]);
        rowsum[i / 2] += s[t][i];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // acc += P V: the score accumulators of kv columns [16kk, 16kk + 16)
    // are exactly the A fragment of that k-step, once packed to bf16.
#pragma unroll
    for (int kk = 0; kk < kBlockKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, cV + (kk * 16 + lm_r + (lm_m % 2) * 8) * kLd +
                                  n * 8 + (lm_m / 2) * 8);
        mma_bf16(o[n], a, bv[0], bv[1]);
        mma_bf16(o[n + 1], a, bv[2], bv[3]);
      }
    }
  }
  cp_async_wait_all();

  // Epilogue: the row sums over the 4 threads of each row group, then
  // out = acc / max(l, 1e-30) in bf16 and lse = m + log(l).  Rows past the
  // ragged edge are not written.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = r == 0 ? row0 : row1;
    if (qpos >= p.seq) continue;
    __nv_bfloat16* dst = p.o + b * p.o_sb + qpos * p.o_ss + h * p.o_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + tig * 2) =
          __floats2bfloat162_rn(o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    }
    if (tig == 0) {
      p.lse[((long long)b * p.heads + h) * p.seq + qpos] = m[r] + logf(l[r]);
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int smem = static_cast<int>(Smem<D>::kBytes);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kBlockQ - 1) / kBlockQ, p.heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Returns a cudaError_t as int: 0 when the launch was accepted.
int flash_attention_fwd_bf16(int device, const void* q, const void* k,
                             const void* v, void* out, void* lse, int batch,
                             int seq, int heads, int kv_heads, int head_dim,
                             long long q_sb, long long q_ss, long long q_sh,
                             long long k_sb, long long k_ss, long long k_sh,
                             long long v_sb, long long v_ss, long long v_sh,
                             long long o_sb, long long o_ss, long long o_sh,
                             int causal, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(out);
  p.lse = static_cast<float*>(lse);
  p.seq = seq;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.causal = causal;
  p.scale = scale;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(launch<64>(p, batch, s));
    case 128: return static_cast<int>(launch<128>(p, batch, s));
    case 256: return static_cast<int>(launch<256>(p, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
