// Flash-attention backward, dk and dv, for Hopper (sm_90a): kernel B3 and
// the dk/dv of the splash kernel B4; bf16 in, bf16 out, f32 accumulation.
//
// B3 replaces the Pallas TPU kernel `_bwd_dkv_kernel` driven by
// `_flash_bwd_pallas` in ray_tpu/ops/flash_attention.py.  It computes the
// same function from the forward's residuals: with S^T = K Q^T * scale
// (scale = D^-0.5; causal positions masked, i.e. P = exp(-1e30 - lse) = 0),
// P^T = exp(S^T - lse) from the forward's natural-log lse, dP^T = V dO^T,
// Delta = rowsum(dO * O) (computed by the caller in f32) and
// dS^T = P^T (dP^T - Delta) * scale:
//   dv = P^T dO and dk = dS^T Q, summed over the q tiles and over the
//   `reps` q heads of the GQA group that shares one kv head.
// P^T and dS^T are cast to bf16 before the products that consume them, as
// the TPU kernel casts them to the input dtype; every sum is f32.  q rows
// past S (their lse and Delta are not defined) get P = 0.
//
// B4's dk/dv replaces `_flash_attention_dkv_kernel` of jax's
// splash_attention_kernel.py, which ray_tpu/ops/splash_attention.py builds.
// It is the same device code, compiled once more with the logit softcap on
// (`kCap`): t = tanh(s / c) of the recomputed scaled score s (as
// s * (1 / c), `tanhf`, as the forward computes it), P = exp(c * t - lse),
// and dS gains the factor 1 - t^2.  The splash wrapper passes scale 1 (its
// q arrives scaled).  The softcap-free instantiations are B3's code under
// its own kernel name, so a trace tells B4 from B3.
//
// What bounds it on the card: 8 operations per (q, k) pair and head dim
// (four products) against a few bytes per row, i.e. hundreds of operations
// per byte at the training shape (S = 2048, D = 128): tensor-core
// operations bound it.  With the cap, a tanh beside each exp loads the
// special-function units too.
//
// The design this one replaced, the training slice's, ran the four
// products on Ampere's `mma.sync` m16n8k16 with 64 kv rows per block, one
// warp per 16 rows, each warp reading every 64-row Q/dO tile through
// ldmatrix twice (as rows for S^T and dP^T, transposed for dV and dK),
// every thread issuing `cp.async` and waiting at a block barrier,
// per-element masks on every tile and one block per (kv tile, kv head,
// batch): 1.553 ms for B3 and 1.551 ms for B4's dk/dv at the training
// shape (B=8, S=2048, H=16, KV=8, D=128, causal), 18% of the bound, and
// 1.803 ms with the cap, on an H100 80GB HBM3 at 700 W (PERF.md's kernel
// table).  This design is built from what only Hopper has
// (hopper_common.cuh):
// * a work tile is 128 kv rows of one (kv head, batch), taken by two
//   consumer warpgroups of 64 rows, each holding its own 64 x D dK and dV
//   accumulators in registers; a producer warpgroup hands its registers to
//   them with `setmaxnreg` (24 against 240), inside one if/else that never
//   reconverges;
// * one producer warp keeps a ring of four Q/dO stages of 64 q rows filled
//   by TMA, each guarded by a full and an empty mbarrier, and loads K and V of
//   the work tile once, by TMA too.  Its lanes bring each stage's 64 lse
//   (times log2 e) and Delta values in with plain loads and arrive on the
//   stage's full barrier (a bulk copy would need a 16-byte-aligned source,
//   which (b * H + h) * S * 4 bytes is not for every S).  No consumer thread
//   computes a global address or waits on a copy it issued;
// * all four products are `wgmma`, each warpgroup on its 64 kv rows:
//   S^T = K.Q^T and dP^T = V.dO^T (m64n64k16, both operands K-major in
//   128-byte-swizzled shared memory), dV += P^T.dO and dK += dS^T.Q
//   (m64nDk16, A from registers: the S^T and dP^T accumulators turned into
//   P^T and dS^T and packed to bf16 are the A fragments, the forward's P
//   trick; B the same Q or dO stage read MN-major, transpose bit set).  So
//   each stage in shared memory serves 128 kv rows and is read once per
//   product, with no transposed copy anywhere;
// * a warpgroup's dV and dK products of stage j run on the tensor cores
//   while it waits for stage j + 1 and issues its S^T; its dP^T follows once
//   they have landed (with dP^T in flight too, P^T, dS^T, S^T, dP^T and the
//   accumulators would need more registers than a consumer has, and ptxas
//   serializes the products: warning C7512).  The two warpgroups' products
//   fill each other's softmax gaps;
// * the softmax terms run in registers in the log2 domain (one multiply by
//   scale * log2 e, `exp2f`), and the causal and ragged compares run only
//   on the stages that need them: the stage on a warpgroup's diagonal and
//   the last, ragged one.  Stages whose q rows all precede a warpgroup's
//   kv rows (wholly masked) are waited for and released, never computed, so
//   the two warpgroups' ring phases never drift;
// * the grid is persistent, one block per SM walking its work tiles from
//   the longest (under causal masking the kv tiles nearest the start of S
//   loop over the most q stages) to the shortest, every other round in
//   reverse ("snake"), and a tile's first Q/dO stages load while the
//   previous tile's epilogue runs;
// * the epilogue writes dK and dV in bf16 into the warpgroup's own K and V
//   rows of shared memory, in the swizzled layout, and TMA stores copy them
//   out (rows past S are dropped by the map).
// One block owns each dk/dv tile and sums in a fixed order (the group's q
// heads, then the q stages), with no atomics: the result is the same bits
// on every run.
//
// D = 256: two 64 x 256 f32 accumulators would take 256 registers a
// thread, and 128 K/V rows (128 KB) leave no room for a ring of 64 KB
// stages.  So a work tile there is 64 kv rows, and both consumer
// warpgroups take all of them, each writing one half of the columns
// (DN = 128 of dk and dv): each recomputes S^T and dP^T over all 256
// columns, as the two column blocks of the design this one replaced did,
// with two stages in place of four.
//
// Layout: q, dO [B, S, H, D] and k, v [B, S, KV, D] are read, and dk, dv
// [B, S, KV, D] written, through 4-D TMA maps built per launch from their
// element strides (the innermost dimension contiguous, every other stride a
// nonzero multiple of 8 elements, every base pointer 16-byte aligned); lse
// and Delta are contiguous [B, H, S] f32.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kBlockQ = 64;  // q rows per stage
constexpr int kWarpgroupThreads = 128;
constexpr int kConsumers = 2 * kWarpgroupThreads;
constexpr int kThreads = kConsumers + kWarpgroupThreads;  // + the producer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 * 24 + 256 * 240 = 384 * 168
// named barriers: 1 + wg for a warpgroup's epilogue, kBothBarrier for both
constexpr int kBothBarrier = 3;
// a stage's full barrier: the producer lane that arms the copies, then the
// 32 lanes that stored its lse and Delta
constexpr int kFullArrivals = 1 + 32;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  // D = 256: both warpgroups on the same 64 kv rows, each on half of D
  static constexpr bool kSplitCols = D > 128;
  static constexpr int kBlockN = kSplitCols ? 64 : 128;  // kv rows per tile
  static constexpr int kCols = kSplitCols ? D / 2 : D;   // per warpgroup
  static constexpr int kChunks = D / 64;  // 64-column swizzle atoms
  static constexpr int kStages = kSplitCols ? 2 : 4;
  static constexpr int kKVElems = kBlockN * D;     // K (and V)
  static constexpr int kStageElems = kBlockQ * D;  // Q (and dO) of a stage
  static constexpr uint32_t kKVBytes = 2 * kKVElems;
  static constexpr uint32_t kStageBytes = 2 * 2 * kStageElems;  // Q and dO
  // K, V, the Q ring, the dO ring, the lse and Delta rings; 1 KB to align
  // the tiles to 1024 bytes
  static constexpr size_t kSmem = 2 * kKVBytes + kStages * kStageBytes +
                                  2 * kStages * kBlockQ * sizeof(float) + 1024;
  static_assert(D % 64 == 0 && D <= 256, "head dims 64, 128, 256");
  static_assert(kSmem <= 232448, "above the 227 KB a block may use");
};

constexpr int kMaxStages = 4;
static_assert(Cfg<64>::kStages <= kMaxStages &&
              Cfg<128>::kStages <= kMaxStages &&
              Cfg<256>::kStages <= kMaxStages, "the barriers' ring");

struct Params {
  const float* lse;
  const float* delta;
  int batch, seq, heads, kv_heads, causal;
  int n_tiles;                 // kv tiles x kv heads x batch
  float scale;
  float score_log2;            // from a (capped) score to log2 units
  float softcap, inv_softcap;  // read only by the kCap instantiations
};

struct Barriers {
  uint64_t full[kMaxStages], empty[kMaxStages];
  uint64_t kv_full, kv_empty;
};

// A work tile: kv rows [kv0, kv0 + kBlockN) of kv head hk and batch b, and
// its stages: for each of the group's q heads, the q stages from `first`
// (the causal diagonal) on, n_live of them.
struct Tile {
  int b, hk, kv0, first, n_live, n_st;
};

// Tile i of the grid's walk: the lowest kv tiles of every (kv head, batch)
// first, since under causal masking they loop over the most q stages.
template <int D>
__device__ __forceinline__ Tile tile_at(const Params& p, int i) {
  const int hb = p.kv_heads * p.batch;
  Tile t;
  t.kv0 = i / hb * Cfg<D>::kBlockN;
  t.hk = i % hb % p.kv_heads;
  t.b = i % hb / p.kv_heads;
  t.first = p.causal ? t.kv0 / kBlockQ : 0;
  t.n_live = (p.seq + kBlockQ - 1) / kBlockQ - t.first;
  t.n_st = p.heads / p.kv_heads * t.n_live;
  return t;
}

// The producer: one warp issues every copy of the block, tile after tile.
// Stage uses are counted across tiles, so the ring runs on from one tile
// into the next: a tile's first stages go out before its K and V, whose
// buffers free only when the consumers have stored the previous tile's dK
// and dV from them.
template <int D>
__device__ __forceinline__ void produce(
    const Params& p, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tg, __nv_bfloat16* sK,
    __nv_bfloat16* sV, __nv_bfloat16* sQ, __nv_bfloat16* sG, float* sL,
    float* sDl, Barriers& bar, int lane) {
  using C = Cfg<D>;
  const int reps = p.heads / p.kv_heads;
  int it = 0;  // stage uses so far
  for (int n = 0, i; (i = snake_tile(n)) < p.n_tiles; ++n) {
    const Tile tile = tile_at<D>(p, i);
    const int kv_after = min(C::kStages, tile.n_st) - 1;
    for (int s = 0; s < tile.n_st; ++s, ++it) {
      const int st = it % C::kStages;
      const int h = tile.hk * reps + s / tile.n_live;
      const int q0 = (tile.first + s % tile.n_live) * kBlockQ;
      // a fresh barrier counts as having completed the phase before phase 0
      mbar_wait(&bar.empty[st], ((it / C::kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&bar.full[st], C::kStageBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(sQ + st * C::kStageElems + c * kBlockQ * 64, tq,
                      &bar.full[st], c * 64, h, q0, tile.b);
          tma_load_4d(sG + st * C::kStageElems + c * kBlockQ * 64, tg,
                      &bar.full[st], c * 64, h, q0, tile.b);
        }
      }
      const long long row0 =
          (static_cast<long long>(tile.b) * p.heads + h) * p.seq + q0;
#pragma unroll
      for (int k = 0; k < kBlockQ / 32; ++k) {
        const int c = lane + 32 * k;
        const bool valid = q0 + c < p.seq;
        sL[st * kBlockQ + c] = valid ? p.lse[row0 + c] * kLog2e : 0.f;
        sDl[st * kBlockQ + c] = valid ? p.delta[row0 + c] : 0.f;
      }
      mbar_arrive(&bar.full[st]);
      if (s == kv_after) {
        mbar_wait(&bar.kv_empty, (n & 1) ^ 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(&bar.kv_full, 2 * C::kKVBytes);
#pragma unroll
          for (int c = 0; c < C::kChunks; ++c) {
            tma_load_4d(sK + c * C::kBlockN * 64, tk, &bar.kv_full, c * 64,
                        tile.hk, tile.kv0, tile.b);
            tma_load_4d(sV + c * C::kBlockN * 64, tv, &bar.kv_full, c * 64,
                        tile.hk, tile.kv0, tile.b);
          }
        }
      }
    }
  }
}

// P^T and dS^T of one stage from the S^T and dP^T accumulators, packed to
// bf16 as the A fragments of the dV and dK products (k-step kk takes q
// columns [16kk, 16kk + 16)).  A thread holds q columns 8j + 2tig + {0, 1}
// (j < 8) of kv rows `row` (s[4j], s[4j + 1]) and row + 8 (s[4j + 2],
// s[4j + 3]); lse2 (lse * log2 e) and Delta are per column.  kMask applies
// the causal and ragged-edge compares.
template <bool kCap, bool kMask>
__device__ __forceinline__ void grads_tile(
    const float (&s)[32], const float (&dp)[32], uint32_t (&pa)[4][4],
    uint32_t (&da)[4][4], const Params& p, const float* lse2,
    const float* dlt, int q0, int row, int tig) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = 8 * kk + 2 * i;  // = 4j + 2r, j = 2kk + i / 2, r = i % 2
      const int col = 8 * (2 * kk + i / 2) + 2 * tig;
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + col);
      const float2 dl = *reinterpret_cast<const float2*>(dlt + col);
      float pr[2], ds[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float z = s[idx + e];
        float dcap = 1.f;  // d(capped score) / d(score), with the cap on
        if constexpr (kCap) {
          const float th = tanhf(z * p.scale * p.inv_softcap);
          z = p.softcap * th;
          dcap = 1.f - th * th;
        }
        pr[e] = exp2f(z * p.score_log2 - (e ? l2.y : l2.x));
        if constexpr (kMask) {
          const int q = q0 + col + e;
          if ((p.causal && q < row + 8 * (i % 2)) || q >= p.seq) pr[e] = 0.f;
        }
        float d = pr[e] * (dp[idx + e] - (e ? dl.y : dl.x));
        if constexpr (kCap) d *= dcap;
        ds[e] = d * p.scale;
      }
      pa[kk][i] = pack_bf16(pr[0], pr[1]);
      da[kk][i] = pack_bf16(ds[0], ds[1]);
    }
  }
}

// One consumer warpgroup, tile after tile: its 64 kv rows (columns
// [dc, dc + DN) of dk and dv), the whole stage loop, the epilogue.  Stage
// j's dV and dK products stay in flight while it waits for stage j + 1 and
// issues that stage's S^T; dP^T goes out once they have landed, and stage j
// is released then.
template <int D, bool kCap>
__device__ __forceinline__ void consume(
    const Params& p, const CUtensorMap* tdk, const CUtensorMap* tdv,
    __nv_bfloat16* sK, __nv_bfloat16* sV, const __nv_bfloat16* sQ,
    const __nv_bfloat16* sG, const float* sL, const float* sDl,
    Barriers& bar, int wg) {
  using C = Cfg<D>;
  constexpr int kN = C::kBlockN;
  constexpr int DN = C::kCols;
  const int t = threadIdx.x % kWarpgroupThreads;
  const int warp = t / 32;
  const int g = t % 32 / 4;  // accumulator row (and row + 8) of the warp
  const int tig = t % 4;     // accumulator column pair
  const int row_off = C::kSplitCols ? 0 : wg * 64;  // rows in the kv tile
  const int dc = C::kSplitCols ? wg * DN : 0;       // first dk/dv column
  // this warpgroup's 64 rows of K and V in every chunk
  const uint32_t k_base = smem_u32(sK) + row_off * 128;
  const uint32_t v_base = smem_u32(sV) + row_off * 128;

  float dk[DN / 2], dv[DN / 2];
  float s[32], dp[32];           // S^T and dP^T of the newest stage
  uint32_t pa[4][4], da[4][4];   // P^T and dS^T: A operands of dV and dK

  int it = 0;  // stage uses so far, as the producer counts them
  for (int n = 0, i; (i = snake_tile(n)) < p.n_tiles; ++n) {
    const Tile tile = tile_at<D>(p, i);
    const int kv_row0 = tile.kv0 + row_off;
    const bool live = kv_row0 < p.seq;  // a tile's upper half may lie past S
    const int row = kv_row0 + warp * 16 + g;
#pragma unroll
    for (int c = 0; c < DN / 2; ++c) dk[c] = dv[c] = 0.f;
    int pending = -1;  // the stage whose dV/dK products may be in flight
    auto retire = [&]() {
      wgmma_wait<0>();
      fence_regs(dk);
      fence_regs(dv);
      if (pending >= 0) mbar_arrive(&bar.empty[pending]);
      pending = -1;
    };

    mbar_wait(&bar.kv_full, n & 1);
    for (int j = 0; j < tile.n_st; ++j, ++it) {
      const int st = it % C::kStages;
      const int q0 = (tile.first + j % tile.n_live) * kBlockQ;
      mbar_wait(&bar.full[st], (it / C::kStages) & 1);
      if (!live || (p.causal && q0 + kBlockQ - 1 < kv_row0)) {
        // every (q, kv) pair of the stage is masked: nothing to add
        retire();
        mbar_arrive(&bar.empty[st]);
        continue;
      }
      const uint32_t q_st = smem_u32(sQ + st * C::kStageElems);
      const uint32_t g_st = smem_u32(sG + st * C::kStageElems);
      // S^T = K Q^T and dP^T = V dO^T: 64 x 64 each, D / 16 k-steps.  S^T
      // queues behind the previous stage's dV and dK products; dP^T goes
      // out once those have landed, so that no more than S^T's, dP^T's and
      // the dK/dV accumulators are locked by products in flight at once
      // (with P^T and dS^T too, ptxas serializes the products: C7512).
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss<64>(s, sw128_desc(k_base + (kk / 4) * kN * 128 + col, 16, 1024),
                     sw128_desc(q_st + (kk / 4) * kBlockQ * 128 + col, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's dV and dK have landed
      fence_regs(dk);
      fence_regs(dv);
      if (pending >= 0) mbar_arrive(&bar.empty[pending]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss<64>(dp, sw128_desc(v_base + (kk / 4) * kN * 128 + col, 16, 1024),
                     sw128_desc(g_st + (kk / 4) * kBlockQ * 128 + col, 16, 1024),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      const float* lse2 = sL + st * kBlockQ;
      const float* dlt = sDl + st * kBlockQ;
      if ((p.causal && q0 == kv_row0) || q0 + kBlockQ > p.seq) {
        grads_tile<kCap, true>(s, dp, pa, da, p, lse2, dlt, q0, row, tig);
      } else {
        grads_tile<kCap, false>(s, dp, pa, da, p, lse2, dlt, q0, row, tig);
      }
      // dV += P^T dO and dK += dS^T Q: 4 k-steps of 16 q rows, dO and Q
      // read MN-major (the next 64 columns one chunk further)
      const uint32_t chunk0 = (dc / 64) * kBlockQ * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DN>(dv, pa[kk],
                     sw128_desc(g_st + chunk0 + kk * 16 * 128, kBlockQ * 128, 1024));
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs<DN>(dk, da[kk],
                     sw128_desc(q_st + chunk0 + kk * 16 * 128, kBlockQ * 128, 1024));
      }
      wgmma_commit();
      pending = st;
    }
    retire();

    // Epilogue: dK and dV in bf16 into this warpgroup's K and V rows, read
    // no more, in the layout the dk/dv maps' 128-byte swizzle expects
    // (16-byte group n % 8 of a row at (n % 8) ^ (row % 8), row % 8 == g);
    // at D = 256 the other warpgroup reads the same rows until it is done.
    if constexpr (C::kSplitCols) named_barrier_sync(kBothBarrier, kConsumers);
    if (live) {
      unsigned char* k_bytes = reinterpret_cast<unsigned char*>(sK);
      unsigned char* v_bytes = reinterpret_cast<unsigned char*>(sV);
      const int trow = row_off + warp * 16 + g;
#pragma unroll
      for (int c = 0; c < DN / 8; ++c) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = ((dc + 8 * c) / 64) * kN * 128 + (trow + 8 * r) * 128 +
                          (((c % 8) ^ g) << 4) + tig * 4;
          *reinterpret_cast<uint32_t*>(k_bytes + off) =
              pack_bf16(dk[4 * c + 2 * r], dk[4 * c + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(v_bytes + off) =
              pack_bf16(dv[4 * c + 2 * r], dv[4 * c + 2 * r + 1]);
        }
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, kWarpgroupThreads);
    if (t == 0) {
      if (live) {
#pragma unroll
        for (int c = dc / 64; c < (dc + DN) / 64; ++c) {
          tma_store_4d(tdk, sK + c * kN * 64 + row_off * 64, c * 64, tile.hk,
                       kv_row0, tile.b);
          tma_store_4d(tdv, sV + c * kN * 64 + row_off * 64, c * 64, tile.hk,
                       kv_row0, tile.b);
        }
        tma_store_wait();
      }
      mbar_arrive(&bar.kv_empty);  // K and V may take the next tile
    }
  }
}

// The body of both kernels; kCap applies the logit softcap.
template <int D, bool kCap>
__device__ __forceinline__ void dkv_body(
    const Params& p, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tg, const CUtensorMap* tdk,
    const CUtensorMap* tdv) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers bar;
  // 128-byte swizzled tiles start on 1024-byte boundaries
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  __nv_bfloat16* sV = sK + C::kKVElems;
  __nv_bfloat16* sQ = sV + C::kKVElems;
  __nv_bfloat16* sG = sQ + C::kStages * C::kStageElems;
  float* sL = reinterpret_cast<float*>(sG + C::kStages * C::kStageElems);
  float* sDl = sL + C::kStages * kBlockQ;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&bar.full[s], kFullArrivals);
      mbar_init(&bar.empty[s], kConsumers);
    }
    mbar_init(&bar.kv_full, 1);
    mbar_init(&bar.kv_empty, 2);  // one thread of each consumer warpgroup
    fence_barrier_init();
  }
  __syncthreads();

  // One if/else for the two roles, never reconverging (setmaxnreg).  The
  // warpgroup index goes through a shuffle so that ptxas sees it, and every
  // branch on it, as uniform: a wgmma under a branch it must treat as
  // divergent is serialized (warning C7520).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / kWarpgroupThreads, 0);
  if (wg == kConsumers / kWarpgroupThreads) {
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == kConsumers / 32) {
      produce<D>(p, tq, tk, tv, tg, sK, sV, sQ, sG, sL, sDl, bar,
                 threadIdx.x % 32);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D, kCap>(p, tdk, tdv, sK, sV, sQ, sG, sL, sDl, bar, wg);
  }
}

#define DKV_MAPS                                                            \
  const __grid_constant__ CUtensorMap tq,                                   \
      const __grid_constant__ CUtensorMap tk,                               \
      const __grid_constant__ CUtensorMap tv,                               \
      const __grid_constant__ CUtensorMap tg,                               \
      const __grid_constant__ CUtensorMap tdk,                              \
      const __grid_constant__ CUtensorMap tdv

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const Params p, DKV_MAPS) {
  dkv_body<D, false>(p, &tq, &tk, &tv, &tg, &tdk, &tdv);
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    splash_bwd_dkv_kernel(const Params p, DKV_MAPS) {
  dkv_body<D, kCap>(p, &tq, &tk, &tv, &tg, &tdk, &tdv);
}

#undef DKV_MAPS

using Kernel = void (*)(const Params, const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap);

struct Tensors {
  const void *q, *k, *v, *g;
  void *dk, *dv;
  // element strides: batch, seq, head
  long long qs[3], ks[3], vs[3], gs[3], dks[3], dvs[3];
};

template <int D>
cudaError_t launch(Kernel kernel, Params p, const Tensors& x, int batch,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  p.batch = batch;
  p.n_tiles = (p.seq + C::kBlockN - 1) / C::kBlockN * p.kv_heads * batch;
  CUtensorMap tq, tk, tv, tg, tdk, tdv;
  const int s = p.seq;
  cudaError_t err;
  if ((err = make_bshd_map(&tq, x.q, batch, s, p.heads, D, x.qs[0], x.qs[1],
                           x.qs[2], kBlockQ)) != cudaSuccess ||
      (err = make_bshd_map(&tg, x.g, batch, s, p.heads, D, x.gs[0], x.gs[1],
                           x.gs[2], kBlockQ)) != cudaSuccess ||
      (err = make_bshd_map(&tk, x.k, batch, s, p.kv_heads, D, x.ks[0],
                           x.ks[1], x.ks[2], C::kBlockN)) != cudaSuccess ||
      (err = make_bshd_map(&tv, x.v, batch, s, p.kv_heads, D, x.vs[0],
                           x.vs[1], x.vs[2], C::kBlockN)) != cudaSuccess ||
      (err = make_bshd_map(&tdk, x.dk, batch, s, p.kv_heads, D, x.dks[0],
                           x.dks[1], x.dks[2], 64)) != cudaSuccess ||
      (err = make_bshd_map(&tdv, x.dv, batch, s, p.kv_heads, D, x.dvs[0],
                           x.dvs[1], x.dvs[2], 64)) != cudaSuccess) {
    return err;
  }
  const int smem = static_cast<int>(C::kSmem);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess) {
    return err;
  }
  kernel<<<min(p.n_tiles, sms), kThreads, smem, stream>>>(p, tq, tk, tv, tg,
                                                          tdk, tdv);
  return cudaGetLastError();
}

Params make_params(const void* lse, const void* delta, int seq, int heads,
                   int kv_heads, int causal, float scale, float softcap) {
  Params p = {};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.seq = seq;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.causal = causal;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.softcap = softcap;
  p.inv_softcap = cap ? 1.f / softcap : 0.f;
  // without the cap the scale folds into the exponent's multiply; with it
  // the capped score is already scaled
  p.score_log2 = cap ? kLog2e : scale * kLog2e;
  return p;
}

Tensors make_tensors(const void* q, const void* k, const void* v,
                     const void* g, void* dk, void* dv, const long long* qs,
                     const long long* ks, const long long* vs,
                     const long long* gs, const long long* dks,
                     const long long* dvs) {
  Tensors x = {q, k, v, g, dk, dv, {}, {}, {}, {}, {}, {}};
  for (int i = 0; i < 3; ++i) {
    x.qs[i] = qs[i];
    x.ks[i] = ks[i];
    x.vs[i] = vs[i];
    x.gs[i] = gs[i];
    x.dks[i] = dks[i];
    x.dvs[i] = dvs[i];
  }
  return x;
}

}  // namespace

extern "C" {

// Both entry points return a cudaError_t as int: 0 when the launch was
// accepted.  Strides are element strides (batch, sequence, head).

// B3.
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
  const long long dks[3] = {dk_sb, dk_ss, dk_sh};
  const long long dvs[3] = {dv_sb, dv_ss, dv_sh};
  const Params p = make_params(lse, delta, seq, heads, kv_heads, causal,
                               scale, 0.f);
  const Tensors x = make_tensors(q, k, v, dout, dk, dv, qs, ks, vs, gs, dks,
                                 dvs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(launch<64>(flash_bwd_dkv_kernel<64>, p, x, batch, s));
    case 128: return static_cast<int>(launch<128>(flash_bwd_dkv_kernel<128>, p, x, batch, s));
    case 256: return static_cast<int>(launch<256>(flash_bwd_dkv_kernel<256>, p, x, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// B4 (splash) dk/dv: B3's arguments plus the softcap (0 turns the cap off).
int splash_attention_bwd_dkv_bf16(
    int device, const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int batch,
    int seq, int heads, int kv_heads, int head_dim, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long g_sb, long long g_ss, long long g_sh, long long dk_sb,
    long long dk_ss, long long dk_sh, long long dv_sb, long long dv_ss,
    long long dv_sh, int causal, float scale, float softcap, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh};
  const long long vs[3] = {v_sb, v_ss, v_sh}, gs[3] = {g_sb, g_ss, g_sh};
  const long long dks[3] = {dk_sb, dk_ss, dk_sh};
  const long long dvs[3] = {dv_sb, dv_ss, dv_sh};
  const Params p = make_params(lse, delta, seq, heads, kv_heads, causal,
                               scale, softcap);
  const Tensors x = make_tensors(q, k, v, dout, dk, dv, qs, ks, vs, gs, dks,
                                 dvs);
  const bool cap = softcap > 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return static_cast<int>(
          cap ? launch<128>(splash_bwd_dkv_kernel<128, true>, p, x, batch, s)
              : launch<128>(splash_bwd_dkv_kernel<128, false>, p, x, batch, s));
    case 256:
      return static_cast<int>(
          cap ? launch<256>(splash_bwd_dkv_kernel<256, true>, p, x, batch, s)
              : launch<256>(splash_bwd_dkv_kernel<256, false>, p, x, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_dkv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
