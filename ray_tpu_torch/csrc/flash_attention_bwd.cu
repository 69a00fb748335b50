// Flash-attention backward, dq, for Hopper (sm_90a): kernel B2 and the dq of
// the splash kernel B4; bf16 in, bf16 out, f32 accumulation.  (dk and dv,
// kernel B3 and B4's dk/dv, are flash_attention_bwd_dkv.cu.)
//
// B2 replaces the Pallas TPU kernel `_bwd_dq_kernel` driven by
// `_flash_bwd_pallas` in ray_tpu/ops/flash_attention.py.  It computes the
// same function from the forward's residuals: with scores
// S = Q K^T * D^-0.5 (causal positions masked with -1e30, not -inf),
// P = exp(S - lse) recomputed from the forward's log-sum-exp, dP = dO V^T,
// Delta = rowsum(dO * O) (computed by the caller in f32) and
// dS = P * (dP - Delta) * D^-0.5: dq = dS K.  dS is cast to bf16 before
// dS K, as the TPU kernel casts it to the input dtype; every sum is f32.
//
// What bounds it on the card: at the training path's shape (S = 2048,
// D = 128) it does 6 operations per (q, k) pair and head dim against a few
// bytes per row, i.e. hundreds of operations per byte: it is bound by
// tensor-core operations.  What the design does about it:
// * scores, probabilities and dS never leave the chip: one 64 x 64 tile
//   lives in registers at a time, as mma.sync C fragments that are re-packed
//   in registers as the A operand of the next product (no shared-memory
//   round trip);
// * every product runs on the tensor cores (mma.sync m16n8k16); the
//   transposed operand (K for dS K) comes from ldmatrix.trans on the
//   row-major tile, so no transposed copy exists in device memory;
// * the streamed K/V tiles are double-buffered with cp.async, so the next
//   tile loads during the current tile's products;
// * tiles past the causal diagonal are skipped: the K/V loop stops at the
//   diagonal (per block, and per warp within the diagonal tile) and the
//   longest rows start first.
// It does not use `wgmma` or TMA yet, so it stays below the card's peak.
//
// B4's dq replaces `_flash_attention_dq_kernel` of jax's
// splash_attention_kernel.py, which ray_tpu/ops/splash_attention.py builds.
// It is the same device code, compiled once more with the logit softcap on
// (`kCap`): the score is recomputed uncapped, t = tanh(s / c) (as
// s * (1 / c), `tanhf`), P = exp(c * t - lse) from the capped score, and dS
// gains the factor 1 - t^2 (d(c tanh(s / c)) / ds), i.e.
// dS = P * (dP - Delta) * (1 - t^2) * scale.  t is a per-element temporary,
// so no array stays live for it.  The splash wrapper passes scale 1 (its q
// arrives scaled).  The softcap-free instantiations are B2's code under its
// own kernel name.
//
// Registers: each warp owns 16 rows; its accumulator is 16 x D f32, i.e.
// D / 2 registers per thread.
//
// Layout: q, dO, dq [B, S, H, D] and k, v [B, S, KV, D] through element
// strides (innermost dimension contiguous, every other stride a multiple of
// 8, base pointers 16-byte aligned); lse and Delta are contiguous [B, H, S]
// f32.  Rows past S (the ragged edge) load as zeros, get P = 0 explicitly
// (their lse and Delta are not defined) and are not written.

#include "flash_common.cuh"

namespace {

using namespace flash;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;  // dO
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  int seq, heads, kv_heads, causal;
  float scale;
  float softcap, inv_softcap;  // read only by the kCap instantiations
  long long q_sb, q_ss, q_sh;  // element strides: batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  long long dq_sb, dq_ss, dq_sh;
};

// Six tiles: two resident, two streamed and double-buffered.
template <int D>
struct Smem {
  static constexpr size_t kTiles = 6 * Tile<D>::kBytes;
  static_assert(kTiles <= 232448, "above the 227 KB a block may use");
};

// ---------------------------------------------------------------------------
// B2: dq.  One block per (q tile of 64 rows, q head, batch); Q and dO stay
// in shared memory, K/V tiles stream through up to the causal diagonal.
// ---------------------------------------------------------------------------
template <int D, bool kCap>
__device__ __forceinline__ void dq_body(Params p) {
  constexpr int kT = Tile<D>::kElems;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sG = sQ + kT;
  __nv_bfloat16* sK = sG + kT;      // two buffers
  __nv_bfloat16* sV = sK + 2 * kT;  // two buffers

  // Highest q tiles first: under causal masking they loop over the most
  // K/V tiles, so they should not be the stragglers of the grid.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.heads / p.kv_heads);
  const int q0 = qt * kTileRows;
  const int lane = threadIdx.x % 32;
  const int wr = threadIdx.x / 32 * 16;  // this warp's first row in the tile
  const int g = lane / 4;                // mma fragment row (and row + 8)
  const int tig = lane % 4;              // mma fragment column pair
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* gb = p.g + b * p.g_sb + h * p.g_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  int n_kv = (p.seq + kTileRows - 1) / kTileRows;
  if (p.causal) n_kv = min(n_kv, qt + 1);  // tiles past the diagonal: masked

  load_tile<D>(sQ, qb, p.q_ss, q0, p.seq);
  load_tile<D>(sG, gb, p.g_ss, q0, p.seq);
  load_tile<D>(sK, kb, p.k_ss, 0, p.seq);
  load_tile<D>(sV, vb, p.v_ss, 0, p.seq);
  cp_async_commit();

  // lse and Delta of this thread's two rows; rows past S read nothing.
  const long long stat0 = ((long long)b * p.heads + h) * p.seq;
  bool live[2];
  float lse[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    live[r] = rows[r] < p.seq;
    lse[r] = live[r] ? p.lse[stat0 + rows[r]] : 0.f;
    dlt[r] = live[r] ? p.delta[stat0 + rows[r]] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait_all();
    __syncthreads();  // tile j landed; every warp is done with tile j - 1
    if (j + 1 < n_kv) {
      const int nb = (j + 1) % 2;
      load_tile<D>(sK + nb * kT, kb, p.k_ss, (j + 1) * kTileRows, p.seq);
      load_tile<D>(sV + nb * kT, vb, p.v_ss, (j + 1) * kTileRows, p.seq);
    }
    cp_async_commit();

    const int k0 = j * kTileRows;
    // every row of this warp lies before the tile: fully masked, skip
    if (p.causal && k0 > q0 + wr + 15) continue;
    const __nv_bfloat16* cK = sK + (j % 2) * kT;
    const __nv_bfloat16* cV = sV + (j % 2) * kT;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 columns per warp each.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t aq[4], ag[4];
      load_a<D>(aq, sQ, wr, kk);
      load_a<D>(ag, sG, wr, kk);
#pragma unroll
      for (int t = 0; t < 8; t += 2) {
        uint32_t bk[4], bv[4];
        load_b_rows<D>(bk, cK, t * 8, kk);
        mma_bf16(s[t], aq, bk[0], bk[1]);
        mma_bf16(s[t + 1], aq, bk[2], bk[3]);
        load_b_rows<D>(bv, cV, t * 8, kk);
        mma_bf16(dp[t], ag, bv[0], bv[1]);
        mma_bf16(dp[t + 1], ag, bv[2], bv[3]);
      }
    }

    // P = exp(S - lse), 0 where masked or past S; dS = P (dP - Delta) scale,
    // into s.  A thread holds columns k0 + 8t + 2tig + {0, 1} of its rows.
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + t * 8 + tig * 2 + (i % 2);
        const int r = i / 2;
        float x = s[t][i] * p.scale;
        float dcap = 1.f;  // d(capped score) / d(score), with the cap on
        if constexpr (kCap) {
          const float th = tanhf(x * p.inv_softcap);
          x = p.softcap * th;
          dcap = 1.f - th * th;
        }
        if (p.causal && rows[r] < kpos) x = kNegInf;
        const float pr = (live[r] && kpos < p.seq) ? expf(x - lse[r]) : 0.f;
        float ds = pr * (dp[t][i] - dlt[r]);
        if constexpr (kCap) ds *= dcap;
        s[t][i] = ds * p.scale;
      }
    }

    // dq += dS K: dS in bf16 as the A operand, K read transposed.
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk) {
      uint32_t a[4];
      pack_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bk[4];
        load_b_cols<D>(bk, cK, kk * 16, n * 8);
        mma_bf16(acc[n], a, bk[0], bk[1]);
        mma_bf16(acc[n + 1], a, bk[2], bk[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!live[r]) continue;
    __nv_bfloat16* dst = p.dq + b * p.dq_sb + rows[r] * p.dq_ss + h * p.dq_sh;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + tig * 2) =
          __floats2bfloat162_rn(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// B2 and B4's dq: the same body under their own names.
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
  dq_body<D, false>(p);
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads) splash_bwd_dq_kernel(Params p) {
  dq_body<D, kCap>(p);
}

template <int D>
cudaError_t launch_dq(void (*kernel)(Params), const Params& p, int batch,
                      cudaStream_t stream) {
  const int smem = static_cast<int>(Smem<D>::kTiles);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kTileRows - 1) / kTileRows, p.heads, batch);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int seq, int heads, int kv_heads, int causal, float scale,
                   const long long* qs, const long long* ks,
                   const long long* vs, const long long* gs) {
  Params p = {};
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.g = static_cast<const __nv_bfloat16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seq = seq;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.causal = causal;
  p.scale = scale;
  p.q_sb = qs[0]; p.q_ss = qs[1]; p.q_sh = qs[2];
  p.k_sb = ks[0]; p.k_ss = ks[1]; p.k_sh = ks[2];
  p.v_sb = vs[0]; p.v_ss = vs[1]; p.v_sh = vs[2];
  p.g_sb = gs[0]; p.g_ss = gs[1]; p.g_sh = gs[2];
  return p;
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t as int: 0 when the launch was
// accepted.  Strides are element strides (batch, sequence, head).

// B2.
int flash_attention_bwd_dq_bf16(
    int device, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int seq,
    int heads, int kv_heads, int head_dim, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long g_sb,
    long long g_ss, long long g_sh, long long dq_sb, long long dq_ss,
    long long dq_sh, int causal, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh}, gs[3] = {g_sb, g_ss, g_sh};
  Params p = make_params(q, k, v, dout, lse, delta, seq, heads, kv_heads,
                         causal, scale, qs, ks, vs, gs);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(launch_dq<64>(flash_bwd_dq_kernel<64>, p, batch, s));
    case 128: return static_cast<int>(launch_dq<128>(flash_bwd_dq_kernel<128>, p, batch, s));
    case 256: return static_cast<int>(launch_dq<256>(flash_bwd_dq_kernel<256>, p, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B4 (splash) dq: B2's arguments plus the softcap (0 turns the cap off).
int splash_attention_bwd_dq_bf16(
    int device, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int batch, int seq,
    int heads, int kv_heads, int head_dim, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long g_sb,
    long long g_ss, long long g_sh, long long dq_sb, long long dq_ss,
    long long dq_sh, int causal, float scale, float softcap, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh}, gs[3] = {g_sb, g_ss, g_sh};
  Params p = make_params(q, k, v, dout, lse, delta, seq, heads, kv_heads,
                         causal, scale, qs, ks, vs, gs);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dq_sb = dq_sb; p.dq_ss = dq_ss; p.dq_sh = dq_sh;
  const bool cap = softcap > 0.f;
  p.softcap = softcap;
  p.inv_softcap = cap ? 1.f / softcap : 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return static_cast<int>(
          cap ? launch_dq<128>(splash_bwd_dq_kernel<128, true>, p, batch, s)
              : launch_dq<128>(splash_bwd_dq_kernel<128, false>, p, batch, s));
    case 256:
      return static_cast<int>(
          cap ? launch_dq<256>(splash_bwd_dq_kernel<256, true>, p, batch, s)
              : launch_dq<256>(splash_bwd_dq_kernel<256, false>, p, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
