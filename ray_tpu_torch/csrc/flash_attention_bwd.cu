// Flash-attention backward for Hopper (sm_90a): dq (B2) and dk/dv (B3), bf16
// in, bf16 out, f32 accumulation.
//
// Replaces the Pallas TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// driven by `_flash_bwd_pallas` in ray_tpu/ops/flash_attention.py.  They
// compute the same function from the forward's residuals: with scores
// S = Q K^T * D^-0.5 (causal positions masked with -1e30, not -inf),
// P = exp(S - lse) recomputed from the forward's log-sum-exp, dP = dO V^T,
// Delta = rowsum(dO * O) (computed by the caller in f32) and
// dS = P * (dP - Delta) * D^-0.5:
//   B2: dq = dS K;
//   B3: dv = P^T dO and dk = dS^T Q, summed over the q tiles and over the
//       `reps` q heads of a GQA group that share one kv head.
// P (before P^T dO) and dS (before dS K and dS^T Q) are cast to bf16, as the
// TPU kernels cast them to the input dtype; every sum is f32.
//
// What bounds it on the card: at the training path's shape (S = 2048,
// D = 128) B2 does 6 and B3 8 operations per (q, k) pair and head against
// a few bytes per row, i.e. hundreds of operations per byte: both kernels
// are bound by tensor-core operations.  What the design does about it:
// * scores, probabilities and dS never leave the chip: one 64 x 64 tile
//   lives in registers at a time, as mma.sync C fragments that are re-packed
//   in registers as the A operand of the next product (no shared-memory
//   round trip);
// * every product runs on the tensor cores (mma.sync m16n8k16); the
//   transposed operands (K for dS K, dO for P^T dO, Q for dS^T Q) come from
//   ldmatrix.trans on the row-major tiles, so no transposed copy exists in
//   device memory;
// * the streamed tiles (K/V in B2, Q/dO in B3) are double-buffered with
//   cp.async, so the next tile loads during the current tile's products;
// * tiles past the causal diagonal are skipped: B2 stops its K/V loop at
//   the diagonal (per block, and per warp within the diagonal tile) and
//   starts the longest rows first; B3 starts its q loop at the diagonal and
//   starts the kv tiles with the most q tiles first.
// There are no atomics: B3 owns its dk/dv rows and loops over the group's
// q heads inside the block, so the result is the same bits on every run.
// It does not use `wgmma` or TMA yet, so it stays below the card's peak.
//
// Registers: each warp owns 16 rows; its accumulators are 16 x D f32, i.e.
// D / 2 registers per thread for each of dq (B2), dk and dv (B3).  B3 at
// D = 256 would need 256 accumulator registers per thread, above the 255 a
// thread may have, so at D = 256 each B3 block writes one half of the head
// dimension (DN = 128 columns of dk and dv) and the grid has two blocks per
// kv tile, each recomputing S^T and dP^T over all 256 columns.  (Shared
// memory cannot take the accumulators instead: the six tiles at D = 256
// already use 198 of the 227 KB.)
//
// Layout: q, dO, dq [B, S, H, D] and k, v, dk, dv [B, S, KV, D] through
// element strides (innermost dimension contiguous, every other stride a
// multiple of 8, base pointers 16-byte aligned); lse and Delta are
// contiguous [B, H, S] f32.  Rows past S (the ragged edge) load as zeros,
// get P = 0 explicitly (their lse and Delta are not defined) and are not
// written.

#include "flash_common.cuh"

namespace {

using namespace flash;

static_assert(kThreads == 2 * kTileRows,
              "B3 loads a tile's lse and Delta with one thread per value");

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* g;  // dO
  const float* lse;
  const float* delta;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int seq, heads, kv_heads, causal;
  float scale;
  long long q_sb, q_ss, q_sh;  // element strides: batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long g_sb, g_ss, g_sh;
  long long dq_sb, dq_ss, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
};

// Both kernels hold six tiles (two resident, two streamed and
// double-buffered); B3 adds the streamed tiles' lse and Delta.
template <int D>
struct Smem {
  static constexpr size_t kTiles = 6 * Tile<D>::kBytes;
  static constexpr size_t kStats = 2 * 2 * kTileRows * sizeof(float);
  static_assert(kTiles + kStats <= 232448, "above the 227 KB a block may use");
};

// ---------------------------------------------------------------------------
// B2: dq.  One block per (q tile of 64 rows, q head, batch); Q and dO stay
// in shared memory, K/V tiles stream through up to the causal diagonal.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(Params p) {
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
        if (p.causal && rows[r] < kpos) x = kNegInf;
        const float pr = (live[r] && kpos < p.seq) ? expf(x - lse[r]) : 0.f;
        s[t][i] = pr * (dp[t][i] - dlt[r]) * p.scale;
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

// ---------------------------------------------------------------------------
// B3: dk and dv.  One block per (kv tile of 64 rows, kv head, batch, column
// half at D = 256); K and V stay in shared memory, (q head, q tile) pairs
// stream through: the group's reps q heads, each over the q tiles from the
// causal diagonal on.  The block writes columns [dc, dc + DN) of dk and dv.
// ---------------------------------------------------------------------------
template <int D, int DN>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(Params p) {
  constexpr int kT = Tile<D>::kElems;
  constexpr int kSplits = D / DN;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sV = sK + kT;
  __nv_bfloat16* sQ = sV + kT;      // two buffers
  __nv_bfloat16* sG = sQ + 2 * kT;  // two buffers
  float* sL = reinterpret_cast<float*>(smem + Smem<D>::kTiles);  // two
  float* sD = sL + 2 * kTileRows;                                 // two

  // Lowest kv tiles first: under causal masking they loop over the most
  // q tiles.
  const int kt = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z / kSplits;
  const int dc = (blockIdx.z % kSplits) * DN;
  const int reps = p.heads / p.kv_heads;
  const int k0 = kt * kTileRows;
  const int lane = threadIdx.x % 32;
  const int wr = threadIdx.x / 32 * 16;
  const int g = lane / 4;
  const int tig = lane % 4;
  const int rows[2] = {k0 + wr + g, k0 + wr + g + 8};  // this thread's kv rows

  const int n_q = (p.seq + kTileRows - 1) / kTileRows;
  const int first = p.causal ? kt : 0;  // q tiles before the diagonal: masked
  const int n_live = n_q - first;
  const int n_it = reps * n_live;

  load_tile<D>(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, k0, p.seq);
  load_tile<D>(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, k0, p.seq);

  // Start loading step `it` (q head hk * reps + it / n_live, q tile
  // first + it % n_live) into buffer `buf`: Q and dO with cp.async, lse and
  // Delta with plain loads (zeros past S).
  auto stage = [&](int it, int buf) {
    const int h = hk * reps + it / n_live;
    const int q0 = (first + it % n_live) * kTileRows;
    load_tile<D>(sQ + buf * kT, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, q0,
                 p.seq);
    load_tile<D>(sG + buf * kT, p.g + b * p.g_sb + h * p.g_sh, p.g_ss, q0,
                 p.seq);
    const long long stat0 = ((long long)b * p.heads + h) * p.seq;
    const int c = threadIdx.x % kTileRows;
    const bool valid = q0 + c < p.seq;
    if (threadIdx.x < kTileRows) {
      sL[buf * kTileRows + c] = valid ? p.lse[stat0 + q0 + c] : 0.f;
    } else {
      sD[buf * kTileRows + c] = valid ? p.delta[stat0 + q0 + c] : 0.f;
    }
  };
  stage(0, 0);
  cp_async_commit();

  float dk[DN / 8][4], dv[DN / 8][4];
#pragma unroll
  for (int n = 0; n < DN / 8; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  for (int it = 0; it < n_it; ++it) {
    cp_async_wait_all();
    __syncthreads();  // step it landed; every warp is done with step it - 1
    if (it + 1 < n_it) stage(it + 1, (it + 1) % 2);
    cp_async_commit();

    const int buf = it % 2;
    const int q0 = (first + it % n_live) * kTileRows;
    const __nv_bfloat16* cQ = sQ + buf * kT;
    const __nv_bfloat16* cG = sG + buf * kT;
    const float* cL = sL + buf * kTileRows;
    const float* cD = sD + buf * kTileRows;

    // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x 64 q columns per warp.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      dp[t][0] = dp[t][1] = dp[t][2] = dp[t][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      uint32_t ak[4], av[4];
      load_a<D>(ak, sK, wr, kk);
      load_a<D>(av, sV, wr, kk);
#pragma unroll
      for (int t = 0; t < 8; t += 2) {
        uint32_t bq[4], bg[4];
        load_b_rows<D>(bq, cQ, t * 8, kk);
        mma_bf16(s[t], ak, bq[0], bq[1]);
        mma_bf16(s[t + 1], ak, bq[2], bq[3]);
        load_b_rows<D>(bg, cG, t * 8, kk);
        mma_bf16(dp[t], av, bg[0], bg[1]);
        mma_bf16(dp[t + 1], av, bg[2], bg[3]);
      }
    }

    // P^T = exp(S^T - lse) into s (0 where masked or past S) and
    // dS^T = P^T (dP^T - Delta) scale into dp.  A thread holds q columns
    // q0 + 8t + 2tig + {0, 1} of its two kv rows; lse and Delta are per
    // column here.
#pragma unroll
    for (int t = 0; t < 8; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = t * 8 + tig * 2 + (i % 2);
        const int qpos = q0 + col;
        float x = s[t][i] * p.scale;
        if (p.causal && qpos < rows[i / 2]) x = kNegInf;
        const float pr = qpos < p.seq ? expf(x - cL[col]) : 0.f;
        s[t][i] = pr;
        dp[t][i] = pr * (dp[t][i] - cD[col]) * p.scale;
      }
    }

    // dv += P^T dO and dk += dS^T Q over columns [dc, dc + DN): P^T and
    // dS^T in bf16 as A operands, dO and Q read transposed.
#pragma unroll
    for (int kk = 0; kk < kTileRows / 16; ++kk) {
      uint32_t ap[4], as[4];
      pack_a(ap, s[2 * kk], s[2 * kk + 1]);
      pack_a(as, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < DN / 8; n += 2) {
        uint32_t bg[4], bq[4];
        load_b_cols<D>(bg, cG, kk * 16, dc + n * 8);
        mma_bf16(dv[n], ap, bg[0], bg[1]);
        mma_bf16(dv[n + 1], ap, bg[2], bg[3]);
        load_b_cols<D>(bq, cQ, kk * 16, dc + n * 8);
        mma_bf16(dk[n], as, bq[0], bq[1]);
        mma_bf16(dk[n + 1], as, bq[2], bq[3]);
      }
    }
  }
  cp_async_wait_all();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= p.seq) continue;
    __nv_bfloat16* dkd =
        p.dk + b * p.dk_sb + rows[r] * p.dk_ss + hk * p.dk_sh + dc;
    __nv_bfloat16* dvd =
        p.dv + b * p.dv_sb + rows[r] * p.dv_ss + hk * p.dv_sh + dc;
#pragma unroll
    for (int n = 0; n < DN / 8; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(dkd + n * 8 + tig * 2) =
          __floats2bfloat162_rn(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvd + n * 8 + tig * 2) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int D>
cudaError_t launch_dq(const Params& p, int batch, cudaStream_t stream) {
  const int smem = static_cast<int>(Smem<D>::kTiles);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kTileRows - 1) / kTileRows, p.heads, batch);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Params& p, int batch, cudaStream_t stream) {
  constexpr int DN = D > 128 ? 128 : D;
  const int smem = static_cast<int>(Smem<D>::kTiles + Smem<D>::kStats);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D, DN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.seq + kTileRows - 1) / kTileRows, p.kv_heads,
                  batch * (D / DN));
  flash_bwd_dkv_kernel<D, DN><<<grid, kThreads, smem, stream>>>(p);
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

// Both entry points return a cudaError_t as int: 0 when the launch was
// accepted.  Strides are element strides (batch, sequence, head).

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
    case 64: return static_cast<int>(launch_dq<64>(p, batch, s));
    case 128: return static_cast<int>(launch_dq<128>(p, batch, s));
    case 256: return static_cast<int>(launch_dq<256>(p, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

int flash_attention_bwd_dkv_bf16(
    int device, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int seq, int heads, int kv_heads, int head_dim, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long g_sb, long long g_ss, long long g_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, int causal, float scale, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh}, gs[3] = {g_sb, g_ss, g_sh};
  Params p = make_params(q, k, v, dout, lse, delta, seq, heads, kv_heads,
                         causal, scale, qs, ks, vs, gs);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk_sb = dk_sb; p.dk_ss = dk_ss; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_ss = dv_ss; p.dv_sh = dv_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(launch_dkv<64>(p, batch, s));
    case 128: return static_cast<int>(launch_dkv<128>(p, batch, s));
    case 256: return static_cast<int>(launch_dkv<256>(p, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
