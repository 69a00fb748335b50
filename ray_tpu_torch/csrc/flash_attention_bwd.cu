// Flash-attention backward, dq, for Hopper (sm_90a): kernel B2 and the dq of
// the splash kernel B4; bf16 in, bf16 out, f32 accumulation.  (dk and dv,
// kernel B3 and B4's dk/dv, are flash_attention_bwd_dkv.cu.)
//
// B2 replaces the Pallas TPU kernel `_bwd_dq_kernel` driven by
// `_flash_bwd_pallas` in ray_tpu/ops/flash_attention.py.  It computes the
// same function from the forward's residuals: with scores
// S = Q K^T * scale (scale = D^-0.5; causal positions masked, i.e.
// P = exp(-1e30 - lse) = 0), P = exp(S - lse) recomputed from the forward's
// natural-log lse, dP = dO V^T, Delta = rowsum(dO * O) (computed by the
// caller in f32) and dS = P * (dP - Delta) * scale: dq = dS K.  dS is cast
// to bf16 before dS K, as the TPU kernel casts it to the input dtype; every
// sum is f32.
//
// B4's dq replaces `_flash_attention_dq_kernel` of jax's
// splash_attention_kernel.py, which ray_tpu/ops/splash_attention.py builds.
// It is the same device code, compiled once more with the logit softcap on
// (`kCap`): t = tanh(s / c) of the recomputed scaled score s (as
// s * (1 / c), `tanhf`, as the forward computes it), P = exp(c * t - lse),
// and dS gains the factor 1 - t^2 (d(c tanh(s / c)) / ds).  The splash
// wrapper passes scale 1 (its q arrives scaled).  The softcap-free
// instantiations are B2's code under its own kernel name, so a trace tells
// B4 from B2.
//
// What bounds it on the card: 6 operations per (q, k) pair and head dim
// (three products) against a few bytes per row, i.e. hundreds of operations
// per byte at the training shape (S = 2048, D = 128): tensor-core
// operations bound it.  With the cap, a tanh beside each exp loads the
// special-function units too.
//
// The design this one replaced, the training slice's, ran the three
// products on Ampere's `mma.sync` m16n8k16 with 64 q rows per block, one
// warp per 16 rows, each warp reading its Q and dO and every K/V tile
// through ldmatrix (K twice: as rows for S, transposed for dS K), every
// thread issuing `cp.async` and waiting at a block barrier per tile,
// per-element masks on every tile and one block per (q tile, head, batch):
// 1.350 ms for B2 and 1.335 ms for B4's dq at the training shape (B=8,
// S=2048, H=16, KV=8, D=128, causal), 15% of the bound, and 1.716 ms with
// the cap, on an H100 80GB HBM3 at 700 W (PERF.md's kernel table).  This
// design is built from what only Hopper has (hopper_common.cuh), on the
// forward's pattern (flash_attention_fwd.cu):
// * a work tile is 128 q rows of one (q head, batch), taken by two consumer
//   warpgroups of 64 rows, each holding its own 64 x D dQ accumulator in
//   registers; a producer warpgroup hands its registers to them with
//   `setmaxnreg` (24 against 240), inside one if/else that never
//   reconverges;
// * one producer thread loads Q and dO of the tile once by TMA and keeps a
//   ring of four K/V stages of 64 kv rows filled, each guarded by a full and
//   an empty mbarrier, so each stage in shared memory serves 128 q rows.
//   lse and Delta are constant over a tile: each consumer thread loads its
//   two rows' values once, at tile start (lse times log2 e);
// * all three products are `wgmma`, each warpgroup on its 64 q rows:
//   S = Q.K^T and dP = dO.V^T (m64n64k16, both operands K-major in
//   128-byte-swizzled shared memory) and dQ += dS.K (m64nDk16, A from
//   registers: the S accumulators turned into dS and packed to bf16 are the
//   A fragment, the forward's P trick; B the same K stage read MN-major,
//   transpose bit set).  K is read twice from one shared tile, with no
//   transposed copy anywhere;
// * a warpgroup's dQ product of stage j runs on the tensor cores while it
//   computes dS of stage j + 1: S and dP of stage j + 1 go out with it, and
//   dS of j + 1 is packed only once the dQ product has landed (the dQ
//   accumulators, S, dP and packed dS are 144 registers under products in
//   flight at D = 128, inside the consumers' 240; with more, ptxas
//   serializes the products: warning C7512).  The two warpgroups' products
//   fill each other's gaps;
// * dS runs in registers in the log2 domain (one multiply by
//   scale * log2 e, `exp2f`), and the causal and ragged compares run only
//   on the stages that need them: the stage on a warpgroup's diagonal and
//   the last, ragged one.  The K/V walk stops at the tile's diagonal; a
//   stage whose kv rows all lie past a warpgroup's q rows (the lower
//   warpgroup's last stage under the causal mask, every stage of a
//   warpgroup whose rows all lie past S) is waited for and released, never
//   computed, so the two warpgroups' ring phases never drift;
// * the grid is persistent, one block per SM walking its work tiles from
//   the longest (under causal masking the last q tiles of S walk the most
//   stages) to the shortest, every other round in reverse ("snake"), with
//   the q heads of a GQA group next to each other so that the K/V stages
//   they share hit L2; a tile's first K/V stages load while the previous
//   tile's epilogue runs;
// * the epilogue writes dq in bf16 into the warpgroup's own Q rows of
//   shared memory, in the swizzled layout, and TMA stores copy it out (rows
//   past S are dropped by the map).
// One block owns each dq tile and sums in a fixed order (the K/V stages),
// with no atomics: the result is the same bits on every run.
//
// D = 256: 128 rows of Q and dO (128 KB) leave room for a single 64 KB K/V
// stage.  So a work tile there is 64 q rows, and both consumer warpgroups
// take all of them, each writing one half of dq's columns (DN = 128): each
// recomputes S and dP over all 256 columns, with two stages, as the dk/dv
// kernel does.
//
// Layout: q, dO [B, S, H, D] and k, v [B, S, KV, D] are read, and dq
// [B, S, H, D] written, through 4-D TMA maps built per launch from their
// element strides (the innermost dimension contiguous, every other stride a
// nonzero multiple of 8 elements, every base pointer 16-byte aligned); lse
// and Delta are contiguous [B, H, S] f32.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kBlockN = 64;  // kv rows per K/V stage
constexpr int kWarpgroupThreads = 128;
constexpr int kConsumers = 2 * kWarpgroupThreads;
constexpr int kThreads = kConsumers + kWarpgroupThreads;  // + the producer
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;  // 128 * 24 + 256 * 240 = 384 * 168
// named barriers: 1 + wg for a warpgroup's epilogue, kBothBarrier for both
constexpr int kBothBarrier = 3;
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  // D = 256: both warpgroups on the same 64 q rows, each on half of D
  static constexpr bool kSplitCols = D > 128;
  static constexpr int kBlockM = kSplitCols ? 64 : 128;  // q rows per tile
  static constexpr int kCols = kSplitCols ? D / 2 : D;   // per warpgroup
  static constexpr int kChunks = D / 64;  // 64-column swizzle atoms
  static constexpr int kStages = kSplitCols ? 2 : 4;
  static constexpr int kQElems = kBlockM * D;   // Q (and dO) of a tile
  static constexpr int kKVElems = kBlockN * D;  // K (and V) of a stage
  static constexpr uint32_t kQBytes = 2 * 2 * kQElems;     // Q and dO
  static constexpr uint32_t kStageBytes = 2 * 2 * kKVElems;  // K and V
  // Q, dO, the K ring, the V ring; 1 KB to align the tiles to 1024 bytes
  static constexpr size_t kSmem = kQBytes + kStages * kStageBytes + 1024;
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
  int n_tiles;                 // q tiles x heads x batch
  float scale;
  float score_log2;            // from a (capped) score to log2 units
  float softcap, inv_softcap;  // read only by the kCap instantiations
};

struct Barriers {
  uint64_t full[kMaxStages], empty[kMaxStages];
  uint64_t q_full, q_empty;
};

// A work tile: q rows [q0, q0 + kBlockM) of head h and batch b, and the
// K/V stages they see.
struct Tile {
  int h, b, q0, n_kv;
};

// Tile i of the grid's walk: the highest q tiles of every (head, batch)
// first, since under causal masking they walk the most K/V stages; inside
// a round the heads of one batch in order, so a GQA group's q heads, which
// read the same K/V stages, run side by side.
template <int D>
__device__ __forceinline__ Tile tile_at(const Params& p, int i) {
  constexpr int kM = Cfg<D>::kBlockM;
  const int hb = p.heads * p.batch;
  const int n_qt = (p.seq + kM - 1) / kM;
  Tile t;
  t.q0 = (n_qt - 1 - i / hb) * kM;
  t.h = i % hb % p.heads;
  t.b = i % hb / p.heads;
  t.n_kv = (p.seq + kBlockN - 1) / kBlockN;
  // K/V stages strictly after this q tile's diagonal are fully masked
  if (p.causal) t.n_kv = min(t.n_kv, (t.q0 + kM) / kBlockN);
  return t;
}

// The K/V stages a warpgroup whose q rows start at wg_row0 computes: the
// first n_run of the tile's; the rest lie wholly past its causal diagonal
// (all of them when its rows lie past S).
__device__ __forceinline__ int run_stages(const Params& p, const Tile& tile,
                                          int wg_row0) {
  if (wg_row0 >= p.seq) return 0;
  return p.causal ? min(tile.n_kv, wg_row0 / kBlockN + 1) : tile.n_kv;
}

// The producer: one thread issues every copy of the block, tile after
// tile.  K/V stage uses are counted across tiles, so the ring runs on from
// one tile into the next: a tile's first stages go out before its Q and dO,
// whose buffers free only when the consumers have stored the previous
// tile's dq from them.
template <int D>
__device__ __forceinline__ void produce(
    const Params& p, const CUtensorMap* tq, const CUtensorMap* tk,
    const CUtensorMap* tv, const CUtensorMap* tg, __nv_bfloat16* sQ,
    __nv_bfloat16* sG, __nv_bfloat16* sK, __nv_bfloat16* sV, Barriers& bar) {
  using C = Cfg<D>;
  const int reps = p.heads / p.kv_heads;
  int it = 0;  // K/V stage uses so far
  for (int n = 0, i; (i = snake_tile(n)) < p.n_tiles; ++n) {
    const Tile tile = tile_at<D>(p, i);
    const int kvh = tile.h / reps;
    const int q_after = min(C::kStages, tile.n_kv) - 1;
    for (int j = 0; j < tile.n_kv; ++j, ++it) {
      const int st = it % C::kStages;
      // a fresh barrier counts as having completed the phase before phase 0
      mbar_wait(&bar.empty[st], ((it / C::kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&bar.full[st], C::kStageBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(sK + st * C::kKVElems + c * kBlockN * 64, tk,
                    &bar.full[st], c * 64, kvh, j * kBlockN, tile.b);
        tma_load_4d(sV + st * C::kKVElems + c * kBlockN * 64, tv,
                    &bar.full[st], c * 64, kvh, j * kBlockN, tile.b);
      }
      if (j == q_after) {
        mbar_wait(&bar.q_empty, (n & 1) ^ 1);
        mbar_arrive_expect_tx(&bar.q_full, C::kQBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(sQ + c * C::kBlockM * 64, tq, &bar.q_full, c * 64,
                      tile.h, tile.q0, tile.b);
          tma_load_4d(sG + c * C::kBlockM * 64, tg, &bar.q_full, c * 64,
                      tile.h, tile.q0, tile.b);
        }
      }
    }
  }
}

// dS of one stage from the S and dP accumulators, in place of S.  A thread
// holds kv columns k0 + 8j + 2tig + {0, 1} (j < 8) of q rows `row` (s[4j],
// s[4j + 1]) and row + 8 (s[4j + 2], s[4j + 3]); lse2 (lse * log2 e) and
// Delta are per row.  kMask applies the causal and ragged-edge compares.
template <bool kCap, bool kMask>
__device__ __forceinline__ void grads_tile(float (&s)[32],
                                           const float (&dp)[32],
                                           const Params& p,
                                           const float (&lse2)[2],
                                           const float (&dlt)[2], int k0,
                                           int row, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int idx = 4 * j + i;
      const int r = i >> 1;
      float z = s[idx];
      float dcap = 1.f;  // d(capped score) / d(score), with the cap on
      if constexpr (kCap) {
        const float th = tanhf(z * p.scale * p.inv_softcap);
        z = p.softcap * th;
        dcap = 1.f - th * th;
      }
      float pr = exp2f(z * p.score_log2 - lse2[r]);
      if constexpr (kMask) {
        const int kpos = k0 + 8 * j + 2 * tig + (i & 1);
        if ((p.causal && kpos > row + 8 * r) || kpos >= p.seq) pr = 0.f;
      }
      float d = pr * (dp[idx] - dlt[r]);
      if constexpr (kCap) d *= dcap;
      s[idx] = d * p.scale;
    }
  }
}

// One consumer warpgroup, tile after tile: its 64 q rows (columns
// [dc, dc + DN) of dq), the whole K/V walk, the epilogue.  The walk is
// software-pipelined: iteration j issues S_j and dP_j and then
// dQ += dS_{j-1}.K_{j-1}, computes dS_j while the tensor cores work on
// that product, and packs dS_j once it has landed, releasing stage j - 1.
template <int D, bool kCap>
__device__ __forceinline__ void consume(
    const Params& p, const CUtensorMap* tdq, __nv_bfloat16* sQ,
    const __nv_bfloat16* sG, const __nv_bfloat16* sK,
    const __nv_bfloat16* sV, Barriers& bar, int wg) {
  using C = Cfg<D>;
  constexpr int kM = C::kBlockM;
  constexpr int DN = C::kCols;
  const int t = threadIdx.x % kWarpgroupThreads;
  const int warp = t / 32;
  const int g = t % 32 / 4;  // accumulator row (and row + 8) of the warp
  const int tig = t % 4;     // accumulator column pair
  const int row_off = C::kSplitCols ? 0 : wg * 64;  // rows in the q tile
  const int dc = C::kSplitCols ? wg * DN : 0;       // first dq column
  // this warpgroup's 64 rows of Q and dO in every chunk
  const uint32_t q_base = smem_u32(sQ) + row_off * 128;
  const uint32_t g_base = smem_u32(sG) + row_off * 128;

  float acc[DN / 2];
  float s[32], dp[32];      // S and dP of the newest stage; dS in s
  uint32_t pa[4][4];        // dS of the stage before it: the A of dQ
  float lse2[2], dlt[2];    // this thread's two rows

  // S = Q K^T and dP = dO V^T of stage st: 64 x 64 each, D / 16 k-steps
  auto issue_s_dp = [&](int st) {
    const uint32_t k_base = smem_u32(sK + st * C::kKVElems);
    const uint32_t v_base = smem_u32(sV + st * C::kKVElems);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss<64>(s, sw128_desc(q_base + (kk / 4) * kM * 128 + col, 16, 1024),
                   sw128_desc(k_base + (kk / 4) * kBlockN * 128 + col, 16, 1024),
                   kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss<64>(dp, sw128_desc(g_base + (kk / 4) * kM * 128 + col, 16, 1024),
                   sw128_desc(v_base + (kk / 4) * kBlockN * 128 + col, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
  };
  // dQ += dS K: 4 k-steps of 16 kv rows, K read MN-major (the next 64
  // columns one chunk further)
  auto issue_dq = [&](int st) {
    const uint32_t k_cols =
        smem_u32(sK + st * C::kKVElems) + (dc / 64) * kBlockN * 128;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs<DN>(acc, pa[kk],
                   sw128_desc(k_cols + kk * 16 * 128, kBlockN * 128, 1024));
    }
    wgmma_commit();
  };
  // the dS values of kv columns [16kk, 16kk + 16), packed to bf16, are the
  // A fragment of k-step kk
  auto pack_ds = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      }
    }
  };

  int it = 0;  // K/V stage uses so far, as the producer counts them
  for (int n = 0, i; (i = snake_tile(n)) < p.n_tiles; ++n) {
    const Tile tile = tile_at<D>(p, i);
    const int wg_row0 = tile.q0 + row_off;
    const bool live = wg_row0 < p.seq;  // a tile's upper half may lie past S
    const int row = wg_row0 + warp * 16 + g;
    const int n_run = run_stages(p, tile, wg_row0);
    // lse and Delta of this thread's rows; rows past S read nothing (their
    // Q and dO rows load as zeros, so their dS is 0, and they are not
    // stored)
    const long long stat0 =
        (static_cast<long long>(tile.b) * p.heads + tile.h) * p.seq;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool valid = row + 8 * r < p.seq;
      lse2[r] = valid ? p.lse[stat0 + row + 8 * r] * kLog2e : 0.f;
      dlt[r] = valid ? p.delta[stat0 + row + 8 * r] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < DN / 2; ++c) acc[c] = 0.f;
    auto grads = [&](int j) {
      const int k0 = j * kBlockN;
      if ((p.causal && k0 == wg_row0) || k0 + kBlockN > p.seq) {
        grads_tile<kCap, true>(s, dp, p, lse2, dlt, k0, row, tig);
      } else {
        grads_tile<kCap, false>(s, dp, p, lse2, dlt, k0, row, tig);
      }
    };

    mbar_wait(&bar.q_full, n & 1);
    if (n_run > 0) {
      const int st0 = it % C::kStages;
      mbar_wait(&bar.full[st0], (it / C::kStages) & 1);
      wgmma_fence();
      issue_s_dp(st0);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      grads(0);
      pack_ds();
      for (int j = 1; j < n_run; ++j) {
        const int st = (it + j) % C::kStages;
        const int prev = (it + j - 1) % C::kStages;
        // the wait ahead of the fence: a wait loop between two products
        // makes ptxas put a warpgroup.arrive before the second (C7519)
        mbar_wait(&bar.full[st], ((it + j) / C::kStages) & 1);
        fence_regs(acc);
        wgmma_fence();
        issue_s_dp(st);
        issue_dq(prev);
        wgmma_wait<1>();  // S_j and dP_j have landed; dQ may still run
        fence_regs(s);
        fence_regs(dp);
        grads(j);
        wgmma_wait<0>();
        fence_regs(acc);
        mbar_arrive(&bar.empty[prev]);
        pack_ds();
      }
      const int last = (it + n_run - 1) % C::kStages;
      fence_regs(acc);
      wgmma_fence();
      issue_dq(last);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&bar.empty[last]);
    }
    for (int k = it + n_run; k < it + tile.n_kv; ++k) {
      // every (q, kv) pair of the stage is masked: nothing to add
      const int st = k % C::kStages;
      mbar_wait(&bar.full[st], (k / C::kStages) & 1);
      mbar_arrive(&bar.empty[st]);
    }
    it += tile.n_kv;

    // Epilogue: dq in bf16 into this warpgroup's Q rows, read no more, in
    // the layout the dq map's 128-byte swizzle expects (16-byte group n % 8
    // of a row at (n % 8) ^ (row % 8), row % 8 == g); at D = 256 the other
    // warpgroup reads the same rows until it is done.
    if constexpr (C::kSplitCols) named_barrier_sync(kBothBarrier, kConsumers);
    if (live) {
      unsigned char* q_bytes = reinterpret_cast<unsigned char*>(sQ);
      const int trow = row_off + warp * 16 + g;
#pragma unroll
      for (int c = 0; c < DN / 8; ++c) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int off = ((dc + 8 * c) / 64) * kM * 128 + (trow + 8 * r) * 128 +
                          (((c % 8) ^ g) << 4) + tig * 4;
          *reinterpret_cast<uint32_t*>(q_bytes + off) =
              pack_bf16(acc[4 * c + 2 * r], acc[4 * c + 2 * r + 1]);
        }
      }
    }
    fence_proxy_async();
    named_barrier_sync(1 + wg, kWarpgroupThreads);
    if (t == 0) {
      if (live) {
#pragma unroll
        for (int c = dc / 64; c < (dc + DN) / 64; ++c) {
          tma_store_4d(tdq, sQ + c * kM * 64 + row_off * 64, c * 64, tile.h,
                       wg_row0, tile.b);
        }
        tma_store_wait();
      }
      mbar_arrive(&bar.q_empty);  // Q and dO may take the next tile
    }
  }
}

// The body of both kernels; kCap applies the logit softcap.
template <int D, bool kCap>
__device__ __forceinline__ void dq_body(const Params& p,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        const CUtensorMap* tg,
                                        const CUtensorMap* tdq) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers bar;
  // 128-byte swizzled tiles start on 1024-byte boundaries
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  __nv_bfloat16* sG = sQ + C::kQElems;
  __nv_bfloat16* sK = sG + C::kQElems;
  __nv_bfloat16* sV = sK + C::kStages * C::kKVElems;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&bar.full[s], 1);
      mbar_init(&bar.empty[s], kConsumers);
    }
    mbar_init(&bar.q_full, 1);
    mbar_init(&bar.q_empty, 2);  // one thread of each consumer warpgroup
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
    if (threadIdx.x == kConsumers) {
      produce<D>(p, tq, tk, tv, tg, sQ, sG, sK, sV, bar);
    }
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    consume<D, kCap>(p, tdq, sQ, sG, sK, sV, bar, wg);
  }
}

#define DQ_MAPS                                                             \
  const __grid_constant__ CUtensorMap tq,                                   \
      const __grid_constant__ CUtensorMap tk,                               \
      const __grid_constant__ CUtensorMap tv,                               \
      const __grid_constant__ CUtensorMap tg,                               \
      const __grid_constant__ CUtensorMap tdq

// B2 and B4's dq: the same body under their own names.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const Params p, DQ_MAPS) {
  dq_body<D, false>(p, &tq, &tk, &tv, &tg, &tdq);
}

template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    splash_bwd_dq_kernel(const Params p, DQ_MAPS) {
  dq_body<D, kCap>(p, &tq, &tk, &tv, &tg, &tdq);
}

#undef DQ_MAPS

using Kernel = void (*)(const Params, const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap,
                        const CUtensorMap);

struct Tensors {
  const void *q, *k, *v, *g;
  void* dq;
  // element strides: batch, seq, head
  long long qs[3], ks[3], vs[3], gs[3], dqs[3];
};

template <int D>
cudaError_t launch(Kernel kernel, Params p, const Tensors& x, int batch,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  p.batch = batch;
  p.n_tiles = (p.seq + C::kBlockM - 1) / C::kBlockM * p.heads * batch;
  CUtensorMap tq, tk, tv, tg, tdq;
  const int s = p.seq;
  cudaError_t err;
  if ((err = make_bshd_map(&tq, x.q, batch, s, p.heads, D, x.qs[0], x.qs[1],
                           x.qs[2], C::kBlockM)) != cudaSuccess ||
      (err = make_bshd_map(&tg, x.g, batch, s, p.heads, D, x.gs[0], x.gs[1],
                           x.gs[2], C::kBlockM)) != cudaSuccess ||
      (err = make_bshd_map(&tk, x.k, batch, s, p.kv_heads, D, x.ks[0],
                           x.ks[1], x.ks[2], kBlockN)) != cudaSuccess ||
      (err = make_bshd_map(&tv, x.v, batch, s, p.kv_heads, D, x.vs[0],
                           x.vs[1], x.vs[2], kBlockN)) != cudaSuccess ||
      (err = make_bshd_map(&tdq, x.dq, batch, s, p.heads, D, x.dqs[0],
                           x.dqs[1], x.dqs[2], 64)) != cudaSuccess) {
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
                                                          tdq);
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
                     const void* g, void* dq, const long long* qs,
                     const long long* ks, const long long* vs,
                     const long long* gs, const long long* dqs) {
  Tensors x = {q, k, v, g, dq, {}, {}, {}, {}, {}};
  for (int i = 0; i < 3; ++i) {
    x.qs[i] = qs[i];
    x.ks[i] = ks[i];
    x.vs[i] = vs[i];
    x.gs[i] = gs[i];
    x.dqs[i] = dqs[i];
  }
  return x;
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
  const long long dqs[3] = {dq_sb, dq_ss, dq_sh};
  const Params p = make_params(lse, delta, seq, heads, kv_heads, causal,
                               scale, 0.f);
  const Tensors x = make_tensors(q, k, v, dout, dq, qs, ks, vs, gs, dqs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(launch<64>(flash_bwd_dq_kernel<64>, p, x, batch, s));
    case 128: return static_cast<int>(launch<128>(flash_bwd_dq_kernel<128>, p, x, batch, s));
    case 256: return static_cast<int>(launch<256>(flash_bwd_dq_kernel<256>, p, x, batch, s));
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
  const long long dqs[3] = {dq_sb, dq_ss, dq_sh};
  const Params p = make_params(lse, delta, seq, heads, kv_heads, causal,
                               scale, softcap);
  const Tensors x = make_tensors(q, k, v, dout, dq, qs, ks, vs, gs, dqs);
  const bool cap = softcap > 0.f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 128:
      return static_cast<int>(
          cap ? launch<128>(splash_bwd_dq_kernel<128, true>, p, x, batch, s)
              : launch<128>(splash_bwd_dq_kernel<128, false>, p, x, batch, s));
    case 256:
      return static_cast<int>(
          cap ? launch<256>(splash_bwd_dq_kernel<256, true>, p, x, batch, s)
              : launch<256>(splash_bwd_dq_kernel<256, false>, p, x, batch, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
