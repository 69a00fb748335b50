// Flash-attention forward for Hopper (sm_90a), out in the input type + f32
// lse: kernel B1 (flash) and the forward of kernel B4 (splash), in bf16 and
// f16 (the wgmma body below, templated on the 16-bit type T) and in f32
// (a body of its own on the CUDA cores, at the end of this file: the
// tensor cores take no f32 operands).  The reference's kernels are generic
// in the element type, and its model code runs them in every float type.
//
// B1 replaces the Pallas TPU kernel `_fwd_kernel` driven by `_flash_fwd` in
// ray_tpu/ops/flash_attention.py.  It computes the same function: causal or
// full attention with an online softmax (running max m, denominator l and
// numerator acc in f32), GQA K/V read in place through kv head h / (H / KV),
// scores scaled by D^-0.5 and masked with -1e30 (not -inf, so no row gives a
// NaN), P cast to the input type for the P.V product, l clamped at 1e-30, and
// lse = m + log(l) written as [B, H, S].
//
// B4 replaces the forward of the splash kernel that ray_tpu/ops/splash_attention.py
// builds (`_get_kernel`, upstream `flash_attention_kernel` of jax's
// splash_attention_kernel.py).  It is the same device code, compiled once more
// with the logit softcap on (`kCap`): the scaled f32 score s becomes
// c * tanh(s / c) before the causal mask, and lse is taken over the capped
// scores.  (s / c is computed as s * (1 / c), and tanh is `tanhf`, as the
// backward recomputes it, so the lse handed to the backward belongs to the
// function the backward differentiates; the splash wrapper passes scale 1
// because its q arrives scaled.)  The softcap-free instantiation is B1's code
// under its own kernel name, so a trace tells B4 from B1.
//
// What bounds it on the card: at the serving path's prefill shapes (S >= 1024,
// D = 128) the work is ~4*S^2*D/2 operations for every (batch, head) against
// ~4*S*D*2 bytes of q/k/v/out, i.e. hundreds of operations per byte, so the
// kernel is bound by tensor-core operations.  With the cap, one tanh per
// score beside the exp makes the special-function units a second bound of
// about the same size at the training shape.
//
// The design this one replaced, the first slice's, ran both products on
// `mma.sync` m16n8k16 with 64-row tiles, one warp per 16 rows, K/V
// double-buffered by `cp.async` from all 128 threads, and a masked, `expf`
// softmax on every tile: 1.605 ms for B1 at the serving shape (B=8, S=2048,
// H=32, KV=8, D=128) and 0.822 ms for B4's forward at the training shape
// (H=16), 17% of the bound, on an H100 80GB HBM3 at 700 W (PERF.md's kernel
// table).  This design is built from what only Hopper has
// (hopper_common.cuh):
// * a work tile is 128 q rows of one (head, batch), taken by two consumer
//   warpgroups of 64 rows; a producer warpgroup hands its registers to them
//   with `setmaxnreg` (40 against 232), inside one if/else that never
//   reconverges;
// * one producer thread keeps a ring of two K and two V stages filled by
//   TMA (128 rows at D <= 128, 64 rows at D = 256 so that Q and the ring fit
//   in shared memory), each stage guarded by a full and an empty mbarrier,
//   and loads Q by TMA too (two buffers at D <= 128).  No consumer thread
//   computes an address or waits on a copy it issued, and every K/V tile in
//   shared memory serves 128 q rows;
// * both products are `wgmma`: S = Q.K^T (m64n{128|64}k16) with Q and K
//   read by descriptor from 128-byte-swizzled shared memory, and
//   O += P.V (m64n{D}k16) with P from registers (the score accumulators
//   packed to T are the A fragment) and V read MN-major (transpose bit);
// * the products hide the softmax: inside a warpgroup, the softmax of K/V
//   tile j runs while the tensor cores work on P.V of tile j - 1, and the
//   two warpgroups take turns issuing their products (named barriers), so
//   one's softmax runs under the other's products;
// * the softmax runs in registers in the log2 domain: one multiply by
//   scale * log2(e) folded into the exponent's fma, `ex2.approx`, and the
//   causal and ragged-edge compares only on the tiles that need them (the
//   diagonal tile and the last one); masked scores take -1e30 before the
//   scale, columns past S -inf;
// * K/V tiles past the causal diagonal are skipped (per tile, and per
//   warpgroup);
// * the grid is persistent, one block per SM: a block walks its work tiles
//   from the longest causal rows down (alternate rounds in reverse, so the
//   blocks' totals even out), and the next tile's K/V and Q land while the
//   current one finishes, in place of a new block's start-up per tile;
// * the epilogue writes out = acc / l in T into the warpgroup's own Q rows
//   of shared memory, in the swizzled layout, and one TMA store per 64
//   columns copies it out (rows past S are dropped by the map); lse is
//   written for rows < S only.
// At D = 256 the softcapped instantiation spills a few bytes (its 64 x 256
// accumulator takes 128 registers a thread); the others spill nothing.
//
// Layout: q [B, S, H, D], k/v [B, S, KV, D] and out [B, S, H, D] are read
// and written through 4-D TMA maps built per launch from their element
// strides (the innermost dimension contiguous, every other stride a nonzero
// multiple of 8 elements, every base pointer 16-byte aligned); lse is a
// contiguous [B, H, S] f32 array.

#include "attention_f32.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;                  // q rows per work tile
constexpr int kWarpgroupThreads = 128;
constexpr int kConsumers = 2 * kWarpgroupThreads;  // 64 q rows each
constexpr int kThreads = kConsumers + kWarpgroupThreads;  // + the producer
constexpr int kStages = 2;                    // K (and V) buffers in the ring
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;            // 128 * 40 + 256 * 232 = 384 * 168
// named barriers: 1 + wg for a warpgroup's epilogue, kTurnBarrier + wg for
// its turn at the tensor cores
constexpr int kTurnBarrier = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int kBlockN = D <= 128 ? 128 : 64;  // K/V rows per stage
  static constexpr int kChunks = D / 64;      // 64-column swizzle atoms
  static constexpr int kQElems = kBlockM * D;
  static constexpr int kKVElems = kBlockN * D;
  static constexpr uint32_t kQBytes = 2 * kQElems;
  static constexpr uint32_t kKVBytes = 2 * kKVElems;
  // Two Q buffers let the next tile's Q land while this tile's epilogue
  // stages out in its own; at D = 256 only one fits beside the ring.
  static constexpr int kQBufs = D <= 128 ? 2 : 1;
  // the Q buffers, then the K ring, then the V ring; 1 KB to align to 1024
  static constexpr size_t kSmem =
      kQBufs * kQBytes + 2 * kStages * kKVBytes + 1024;
  static_assert(D % 64 == 0 && D <= 256, "head dims 64, 128, 256");
  static_assert(kSmem <= 232448, "above the 227 KB a block may use");
};

struct Params {
  float* lse;
  int batch, seq, heads, kv_heads, causal;
  int n_tiles;                 // q tiles x heads x batch
  float scale;
  float score_log2;            // the factor from a score to log2 units
  float softcap, inv_softcap;  // read only by the kCap instantiations
};

struct Barriers {
  uint64_t q_full[2], q_empty[2];
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};

// A work tile: 128 q rows of one (head, batch) and the K/V tiles they see.
struct Tile {
  int h, b, q0, n_kv;
};

// Tile i of the grid's walk: the highest q tiles of every (head, batch)
// first, since under causal masking they loop over the most K/V tiles and
// should not be the stragglers; then the next lower, and so on.
template <int D>
__device__ __forceinline__ Tile tile_at(const Params& p, int i) {
  constexpr int kN = Cfg<D>::kBlockN;
  const int hb = p.heads * p.batch;
  const int n_qt = (p.seq + kBlockM - 1) / kBlockM;
  Tile t;
  t.q0 = (n_qt - 1 - i / hb) * kBlockM;
  t.h = i % hb % p.heads;
  t.b = i % hb / p.heads;
  t.n_kv = (p.seq + kN - 1) / kN;
  if (p.causal) {
    // K/V tiles strictly after this q tile's diagonal are fully masked.
    t.n_kv = min(t.n_kv, (t.q0 + kBlockM + kN - 1) / kN);
  }
  return t;
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The K/V tiles consumer warpgroup wg computes of a tile: the first n_run;
// the rest lie wholly past its causal diagonal (all of them when its rows
// lie past S).
template <int D>
__device__ __forceinline__ int run_tiles(const Params& p, const Tile& tile,
                                         int wg) {
  const int row0 = tile.q0 + wg * 64;
  if (row0 >= p.seq) return 0;
  return p.causal ? min(tile.n_kv, (row0 + 63) / Cfg<D>::kBlockN + 1)
                  : tile.n_kv;
}

// The producer: one thread issues every copy of the block, tile after
// tile.  K/V stage uses are counted across tiles, so the ring runs on from
// one tile into the next; a tile's first K/V stages go out before its Q,
// whose buffer frees only when the consumers have stored an earlier tile.
template <typename T, int D>
__device__ __forceinline__ void produce(const Params& p,
                                        const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv,
                                        T* sQ, T* sK,
                                        T* sV, Barriers& bar) {
  using C = Cfg<D>;
  constexpr int kN = C::kBlockN;
  int it = 0;  // K/V stage uses so far
  for (int n = 0, i; (i = snake_tile(n)) < p.n_tiles; ++n) {
    const Tile tile = tile_at<D>(p, i);
    const int kvh = tile.h / (p.heads / p.kv_heads);
    for (int j = 0; j < tile.n_kv; ++j, ++it) {
      const int st = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      // a fresh barrier counts as having completed the phase before phase 0
      mbar_wait(&bar.k_empty[st], phase ^ 1);
      mbar_arrive_expect_tx(&bar.k_full[st], C::kKVBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(sK + st * C::kKVElems + c * kN * 64, tk, &bar.k_full[st],
                    c * 64, kvh, j * kN, tile.b);
      }
      mbar_wait(&bar.v_empty[st], phase ^ 1);
      mbar_arrive_expect_tx(&bar.v_full[st], C::kKVBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_4d(sV + st * C::kKVElems + c * kN * 64, tv, &bar.v_full[st],
                    c * 64, kvh, j * kN, tile.b);
      }
      if (j == 0) {
        const int buf = n % C::kQBufs;
        mbar_wait(&bar.q_empty[buf], ((n / C::kQBufs) & 1) ^ 1);
        mbar_arrive_expect_tx(&bar.q_full[buf], C::kQBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_4d(sQ + buf * C::kQElems + c * kBlockM * 64, tq,
                      &bar.q_full[buf], c * 64, tile.h, tile.q0, tile.b);
        }
      }
    }
  }
}

// Scale (and cap), mask, and the online softmax update of one tile of
// scores, all in registers.  A thread holds columns k0 + 8t + 2tig + {0, 1}
// of rows row0 (s[4t], s[4t + 1]) and row0 + 8 (s[4t + 2], s[4t + 3]); the
// 4 threads of a row group share a row.  m is in log2 units.  On return s
// holds P = exp(score - m), l is updated, and alpha is the factor the
// accumulator still has to be rescaled by (after the P.V product in flight).
template <int kN, bool kCap, bool kMask>
__device__ __forceinline__ void softmax_tile(float (&s)[kN / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             const Params& p, int k0,
                                             int row0, int tig) {
  float mz[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int t = 0; t < kN / 8; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float z = s[4 * t + i];
      if constexpr (kCap) z = p.softcap * tanhf(z * p.scale * p.inv_softcap);
      if constexpr (kMask) {
        const int kpos = k0 + t * 8 + tig * 2 + (i & 1);
        if (p.causal && row0 + 8 * (i >> 1) < kpos) z = kNegInf;
        if (kpos >= p.seq) z = -INFINITY;  // past the ragged edge: no column
      }
      s[4 * t + i] = z;
      mz[i >> 1] = fmaxf(mz[i >> 1], z);
    }
  }
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mz[r] = fmaxf(mz[r], __shfl_xor_sync(0xffffffffu, mz[r], 1));
    mz[r] = fmaxf(mz[r], __shfl_xor_sync(0xffffffffu, mz[r], 2));
    const float m_new = fmaxf(m[r], mz[r] * p.score_log2);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
  }
  float rowsum[2] = {0.f, 0.f};
#pragma unroll
  for (int t = 0; t < kN / 8; ++t) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float e =
          fast_exp2(fmaf(s[4 * t + i], p.score_log2, neg_m[i >> 1]));
      s[4 * t + i] = e;
      rowsum[i >> 1] += e;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rowsum[r];
}

// One consumer warpgroup on one tile: 64 q rows, the whole K/V loop (stage
// uses numbered from `it0`), the epilogue.  The loop is software-pipelined:
// iteration j issues S_j = Q.K_j^T and then acc += P_{j-1}.V_{j-1}, and
// runs the softmax of S_j while the tensor cores work on P_{j-1}.V_{j-1};
// the accumulator is rescaled once that product has landed.
template <typename T, int D, bool kCap>
__device__ __forceinline__ void consume(const Params& p, const CUtensorMap* to,
                                        T* sQ,
                                        const T* sK,
                                        const T* sV,
                                        Barriers& bar, int wg,
                                        const Tile& tile, int buf,
                                        uint32_t q_phase, int it0) {
  using C = Cfg<D>;
  constexpr int kN = C::kBlockN;
  const int h = tile.h, b = tile.b, q0 = tile.q0, n_kv = tile.n_kv;
  sQ += buf * C::kQElems;
  const int t = threadIdx.x % kWarpgroupThreads;
  const int warp = t / 32;
  const int g = t % 32 / 4;   // accumulator row (and row + 8) of the warp
  const int tig = t % 4;      // accumulator column pair
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + g;
  const bool live = wg_row0 < p.seq;  // a tile's second half may lie past S
  // It waits for and releases the K/V tiles past n_run, computing nothing.
  const int n_run = run_tiles<D>(p, tile, wg);
  // The iterations both warpgroups run take turns at the tensor cores
  // (FA3's ping-pong): a warpgroup issues its products only once the other
  // has issued its own, so one's softmax runs under the other's products.
  const int n_both = min(run_tiles<D>(p, tile, 0), run_tiles<D>(p, tile, 1));

  float acc[D / 2];
#pragma unroll
  for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float s[kN / 2];          // scores of the newest tile
  uint32_t pa[kN / 16][4];  // P of the tile before it: the A operand of P.V

  // this warpgroup's 64 rows of Q in every chunk
  const uint32_t q_base = smem_u32(sQ) + wg * 64 * 128;

  // S = Q K_j^T: 64 rows x kN columns, D / 16 k-steps
  auto issue_qk = [&](int st) {
    const uint32_t k_base = smem_u32(sK + st * C::kKVElems);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      wgmma_ss<T, kN>(
          s, sw128_desc(q_base + (kk / 4) * kBlockM * 128 + col, 16, 1024),
          sw128_desc(k_base + (kk / 4) * kN * 128 + col, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // acc += P V_j: kN / 16 k-steps, V read MN-major
  auto issue_pv = [&](int st) {
    const uint32_t v_base = smem_u32(sV + st * C::kKVElems);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      wgmma_rs<T, D>(acc, pa[kk],
                  sw128_desc(v_base + kk * 16 * 128, kN * 128, 1024));
    }
    wgmma_commit();
  };
  auto softmax = [&](int j, float (&alpha)[2]) {
    const int k0 = j * kN;
    if ((p.causal && k0 + kN - 1 > wg_row0) || k0 + kN > p.seq) {
      softmax_tile<kN, kCap, true>(s, m, l, alpha, p, k0, row0, tig);
    } else {
      softmax_tile<kN, kCap, false>(s, m, l, alpha, p, k0, row0, tig);
    }
  };
  // the score accumulators of columns [16kk, 16kk + 16), packed to T,
  // are the A fragment of k-step kk
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[kk][i] = pack2<T>(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
      }
    }
  };

  mbar_wait(&bar.q_full[buf], q_phase);
  if (n_run > 0) {
    float alpha[2];
    const int st0 = it0 % kStages;
    mbar_wait(&bar.k_full[st0], (it0 / kStages) & 1);
    wgmma_fence();
    issue_qk(st0);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&bar.k_empty[st0]);
    softmax(0, alpha);  // acc is still 0: nothing to rescale
    pack_p();
    for (int j = 1; j < n_run; ++j) {
      const int it = it0 + j;
      const int st = it % kStages, prev = (it - 1) % kStages;
      // both waits ahead of the fence: a wait loop between the two products
      // makes ptxas put a warpgroup.arrive before P.V (warning C7519)
      mbar_wait(&bar.k_full[st], (it / kStages) & 1);
      mbar_wait(&bar.v_full[prev], ((it - 1) / kStages) & 1);
      fence_regs(acc);
      wgmma_fence();
      if (j < n_both) named_barrier_sync(kTurnBarrier + wg, kConsumers);
      issue_qk(st);
      issue_pv(prev);
      if (j < n_both) named_barrier_arrive(kTurnBarrier + 1 - wg, kConsumers);
      wgmma_wait<1>();  // S_j has landed; P_{j-1}.V_{j-1} may still run
      fence_regs(s);
      mbar_arrive(&bar.k_empty[st]);
      softmax(j, alpha);
      wgmma_wait<0>();
      fence_regs(acc);
      mbar_arrive(&bar.v_empty[prev]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= alpha[0];
        acc[4 * n + 1] *= alpha[0];
        acc[4 * n + 2] *= alpha[1];
        acc[4 * n + 3] *= alpha[1];
      }
      pack_p();
    }
    const int last = (it0 + n_run - 1) % kStages;
    mbar_wait(&bar.v_full[last], ((it0 + n_run - 1) / kStages) & 1);
    fence_regs(acc);
    wgmma_fence();
    issue_pv(last);
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&bar.v_empty[last]);
  }
  for (int it = it0 + n_run; it < it0 + n_kv; ++it) {
    const int st = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    mbar_wait(&bar.k_full[st], phase);
    mbar_arrive(&bar.k_empty[st]);
    mbar_wait(&bar.v_full[st], phase);
    mbar_arrive(&bar.v_empty[st]);
  }

  // Epilogue: the row sums over the 4 threads of each row group, then
  // out = acc / max(l, 1e-30) in T and lse = m + log(l).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
  if (!live) {
    if (t == 0) mbar_arrive(&bar.q_empty[buf]);  // its Q rows were not read
    return;
  }
  const float inv_l[2] = {1.f / l[0], 1.f / l[1]};
  // This warpgroup's Q rows are read no more: they take its out tile, in
  // the layout the out map's 128-byte swizzle expects (16-byte group n % 8
  // of a row at position (n % 8) ^ (row % 8), and row % 8 == g).
  unsigned char* out_tile = reinterpret_cast<unsigned char*>(sQ);
  const int trow = wg * 64 + warp * 16 + g;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      unsigned char* dst = out_tile + (n / 8) * kBlockM * 128 +
                           (trow + 8 * r) * 128 + (((n % 8) ^ g) << 4) +
                           tig * 4;
      *reinterpret_cast<uint32_t*>(dst) =
          pack2<T>(acc[4 * n + 2 * r] * inv_l[r],
                    acc[4 * n + 2 * r + 1] * inv_l[r]);
    }
  }
  fence_proxy_async();
  named_barrier_sync(1 + wg, kWarpgroupThreads);
  if (t == 0) {
#pragma unroll
    for (int c = 0; c < C::kChunks; ++c) {
      tma_store_4d(to, sQ + c * kBlockM * 64 + wg * 64 * 64, c * 64, h,
                   wg_row0, b);
    }
    tma_store_wait();
    mbar_arrive(&bar.q_empty[buf]);  // the buffer may take the next Q
  }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row < p.seq) {
        p.lse[(static_cast<long long>(b) * p.heads + h) * p.seq + row] =
            m[r] * kLn2 + logf(l[r]);
      }
    }
  }
}

// The body of both kernels; kCap applies the logit softcap.  The grid is
// persistent, one block per SM walking its tiles (snake_tile), so one
// tile's loads run under the previous tile's products and epilogue instead
// of after a new block's start-up.
template <typename T, int D, bool kCap>
__device__ __forceinline__ void fwd_body(const Params& p,
                                         const CUtensorMap* tq,
                                         const CUtensorMap* tk,
                                         const CUtensorMap* tv,
                                         const CUtensorMap* to) {
  using C = Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Barriers bar;
  // 128-byte swizzled tiles start on 1024-byte boundaries
  T* sQ = reinterpret_cast<T*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  T* sK = sQ + C::kQBufs * C::kQElems;
  T* sV = sK + kStages * C::kKVElems;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      mbar_init(&bar.q_full[q], 1);
      mbar_init(&bar.q_empty[q], 2);  // one thread of each consumer group
    }
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar.k_full[s], 1);
      mbar_init(&bar.v_full[s], 1);
      mbar_init(&bar.k_empty[s], kConsumers);
      mbar_init(&bar.v_empty[s], kConsumers);
    }
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
    if (threadIdx.x == kConsumers) produce<T, D>(p, tq, tk, tv, sQ, sK, sV, bar);
  } else {
    setmaxnreg_inc<kConsumerRegs>();
    // warpgroup 0 takes the first turn; so the turns balance, warpgroup 0
    // takes one more at the end
    if (wg == 1) named_barrier_arrive(kTurnBarrier, kConsumers);
    int it = 0;  // K/V stage uses so far, as the producer counts them
    for (int n = 0, i; (i = snake_tile(n)) < p.n_tiles; ++n) {
      const Tile tile = tile_at<D>(p, i);
      consume<T, D, kCap>(p, to, sQ, sK, sV, bar, wg, tile, n % C::kQBufs,
                       (n / C::kQBufs) & 1, it);
      it += tile.n_kv;
    }
    if (wg == 0) named_barrier_sync(kTurnBarrier, kConsumers);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap to) {
  fwd_body<T, D, false>(p, &tq, &tk, &tv, &to);
}

template <typename T, int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    splash_fwd_kernel(const Params p, const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap to) {
  fwd_body<T, D, kCap>(p, &tq, &tk, &tv, &to);
}

using Kernel = void (*)(const Params, const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const CUtensorMap);

struct Tensors {
  const void *q, *k, *v;
  void* out;
  long long qs[3], ks[3], vs[3], os[3];  // element strides: batch, seq, head
};

template <typename T, int D>
cudaError_t launch(Kernel kernel, Params p, const Tensors& x, int batch,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  p.batch = batch;
  p.n_tiles = (p.seq + kBlockM - 1) / kBlockM * p.heads * batch;
  CUtensorMap tq, tk, tv, to;
  cudaError_t err;
  if ((err = make_bshd_map<T>(&tq, x.q, batch, p.seq, p.heads, D, x.qs[0],
                           x.qs[1], x.qs[2], kBlockM)) != cudaSuccess ||
      (err = make_bshd_map<T>(&tk, x.k, batch, p.seq, p.kv_heads, D, x.ks[0],
                           x.ks[1], x.ks[2], C::kBlockN)) != cudaSuccess ||
      (err = make_bshd_map<T>(&tv, x.v, batch, p.seq, p.kv_heads, D, x.vs[0],
                           x.vs[1], x.vs[2], C::kBlockN)) != cudaSuccess ||
      (err = make_bshd_map<T>(&to, x.out, batch, p.seq, p.heads, D, x.os[0],
                           x.os[1], x.os[2], 64)) != cudaSuccess) {
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
  kernel<<<min(p.n_tiles, sms), kThreads, smem, stream>>>(p, tq, tk, tv, to);
  return cudaGetLastError();
}

Params make_params(void* lse, int seq, int heads, int kv_heads, int causal,
                   float scale, float softcap) {
  Params p = {};
  p.lse = static_cast<float*>(lse);
  p.seq = seq;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.causal = causal;
  p.scale = scale;
  const bool cap = softcap > 0.f;
  p.softcap = softcap;
  p.inv_softcap = cap ? 1.f / softcap : 0.f;
  // without the cap the scale folds into the exponent's fma; with it the
  // capped score is already scaled
  p.score_log2 = cap ? kLog2e : scale * kLog2e;
  return p;
}

Tensors make_tensors(const void* q, const void* k, const void* v, void* out,
                     long long q_sb, long long q_ss, long long q_sh,
                     long long k_sb, long long k_ss, long long k_sh,
                     long long v_sb, long long v_ss, long long v_sh,
                     long long o_sb, long long o_ss, long long o_sh) {
  return Tensors{q, k, v, out, {q_sb, q_ss, q_sh}, {k_sb, k_ss, k_sh},
                 {v_sb, v_ss, v_sh}, {o_sb, o_ss, o_sh}};
}

// ------------------------------------------------------------------ f32

// The f32 body of B1 and of B4's forward (attention_f32.cuh): block
// (h + heads * b, y) takes q tile n_qt - 1 - y of (head h, batch b), the
// longest causal rows first, and walks the K/V tiles up to its diagonal
// with the online softmax in f32: scores scaled (and capped) before the
// causal mask (-1e30) and the ragged edge (-inf), P through shared memory
// into P.V, out = acc / max(l, 1e-30) and lse = m + log(l), as the
// reference computes them.
template <int D, bool kCap>
__device__ __forceinline__ void fwd_f32_body(const Params& p,
                                             const Tensors& x) {
  using C = simt::Tiles<D>;
  constexpr int kT = C::kT, R = C::kRI, G = C::kG;
  extern __shared__ float4 smem_f4[];
  float* sQ = reinterpret_cast<float*>(smem_f4);
  float* sK = sQ + C::kTile;
  float* sV = sK + C::kTile;
  float* sP = sV + C::kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int h = blockIdx.x % p.heads, b = blockIdx.x / p.heads;
  const int kvh = h / (p.heads / p.kv_heads);
  const int n_qt = (p.seq + kT - 1) / kT;
  const int qt = n_qt - 1 - static_cast<int>(blockIdx.y);
  const int q0 = qt * kT;
  simt::load_tile<D>(sQ, static_cast<const float*>(x.q), x.qs, b, h, q0,
                     p.seq);

  float m[R], l[R], acc[R][G][4];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;  // this thread's share of the row sum
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] = 0.f;
    }
  }
  const int n_kv = p.causal ? qt + 1 : n_qt;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kT;
    __syncthreads();  // the previous tile's K, V and P are read no more
    simt::load_tile<D>(sK, static_cast<const float*>(x.k), x.ks, b, kvh, k0,
                       p.seq);
    simt::load_tile<D>(sV, static_cast<const float*>(x.v), x.vs, b, kvh, k0,
                       p.seq);
    __syncthreads();
    float s[R][R];
    simt::products_abt<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int kpos = k0 + tx + 16 * c;
        float dcap;
        float z = simt::capped<kCap>(s[i][c] * p.scale, p.softcap, dcap);
        if (p.causal && row < kpos) z = kNegInf;
        if (kpos >= p.seq) z = -INFINITY;  // past the ragged edge
        s[i][c] = z;
        mx = fmaxf(mx, z);
      }
      const float m_new = fmaxf(m[i], simt::row_max(mx));
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const float pr = expf(s[i][c] - m_new);
        sum += pr;
        sP[(ty + 16 * i) * C::kLDP + tx + 16 * c] = pr;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][e] *= alpha;
      }
    }
    __syncthreads();
    simt::products_pb<D>(acc, sP, sV, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    l[i] = fmaxf(simt::row_sum(l[i]), 1e-30f);
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][g][e] /= l[i];
    }
    const int row = q0 + ty + 16 * i;
    if (tx == 0 && row < p.seq) {
      p.lse[(static_cast<long long>(b) * p.heads + h) * p.seq + row] =
          m[i] + logf(l[i]);
    }
  }
  simt::store_rows<D>(static_cast<float*>(x.out), x.os, acc, b, h, q0,
                      p.seq, ty, tx);
}

template <int D>
__global__ void __launch_bounds__(simt::kThreads)
    flash_fwd_f32_kernel(const Params p, const Tensors x) {
  fwd_f32_body<D, false>(p, x);
}

template <int D, bool kCap>
__global__ void __launch_bounds__(simt::kThreads)
    splash_fwd_f32_kernel(const Params p, const Tensors x) {
  fwd_f32_body<D, kCap>(p, x);
}

using F32Kernel = void (*)(const Params, const Tensors);

template <int D>
cudaError_t launch_f32(F32Kernel kernel, Params p, const Tensors& x,
                       int batch, cudaStream_t stream) {
  using C = simt::Tiles<D>;
  p.batch = batch;
  const int smem = static_cast<int>((3 * C::kTile + C::kSquare) *
                                    sizeof(float));
  cudaError_t err = simt::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.heads * batch, (p.seq + C::kT - 1) / C::kT);
  kernel<<<grid, simt::kThreads, smem, stream>>>(p, x);
  return cudaGetLastError();
}

// ------------------------------------------------------------- dispatch

// B1 (cap false, flash's kernel names) or B4's forward (splash's names) in
// element type T: __nv_bfloat16 or __half run the wgmma body, float the
// f32 one.
template <typename T>
cudaError_t forward(const Params& p, const Tensors& x, int batch,
                    int head_dim, bool splash, cudaStream_t s) {
  const bool cap = p.softcap > 0.f;
  if constexpr (std::is_same<T, float>::value) {
    switch (head_dim) {
      case 64:
        if (!splash) return launch_f32<64>(flash_fwd_f32_kernel<64>, p, x, batch, s);
        break;
      case 128:
        return launch_f32<128>(!splash ? flash_fwd_f32_kernel<128>
                               : cap ? splash_fwd_f32_kernel<128, true>
                                     : splash_fwd_f32_kernel<128, false>,
                               p, x, batch, s);
      case 256:
        return launch_f32<256>(!splash ? flash_fwd_f32_kernel<256>
                               : cap ? splash_fwd_f32_kernel<256, true>
                                     : splash_fwd_f32_kernel<256, false>,
                               p, x, batch, s);
    }
  } else {
    switch (head_dim) {
      case 64:
        if (!splash) return launch<T, 64>(flash_fwd_kernel<T, 64>, p, x, batch, s);
        break;
      case 128:
        return launch<T, 128>(!splash ? flash_fwd_kernel<T, 128>
                              : cap ? splash_fwd_kernel<T, 128, true>
                                    : splash_fwd_kernel<T, 128, false>,
                              p, x, batch, s);
      case 256:
        return launch<T, 256>(!splash ? flash_fwd_kernel<T, 256>
                              : cap ? splash_fwd_kernel<T, 256, true>
                                    : splash_fwd_kernel<T, 256, false>,
                              p, x, batch, s);
    }
  }
  return cudaErrorInvalidValue;  // no instantiation for this head dim
}

template <typename T>
int entry(int device, const void* q, const void* k, const void* v, void* out,
          void* lse, int batch, int seq, int heads, int kv_heads,
          int head_dim, long long q_sb, long long q_ss, long long q_sh,
          long long k_sb, long long k_ss, long long k_sh, long long v_sb,
          long long v_ss, long long v_sh, long long o_sb, long long o_ss,
          long long o_sh, int causal, float scale, float softcap,
          bool splash, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Params p = make_params(lse, seq, heads, kv_heads, causal, scale,
                               softcap);
  const Tensors x = make_tensors(q, k, v, out, q_sb, q_ss, q_sh, k_sb, k_ss,
                                 k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh);
  return static_cast<int>(forward<T>(p, x, batch, head_dim, splash,
                                     static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t as int: 0 when the launch was
// accepted.  Strides are element strides (batch, sequence, head).  The
// suffix names the element type of q, k, v and out: bf16, f16 or f32.

#define FWD_ARGS                                                            \
  int device, const void *q, const void *k, const void *v, void *out,      \
      void *lse, int batch, int seq, int heads, int kv_heads, int head_dim, \
      long long q_sb, long long q_ss, long long q_sh, long long k_sb,       \
      long long k_ss, long long k_sh, long long v_sb, long long v_ss,       \
      long long v_sh, long long o_sb, long long o_ss, long long o_sh,       \
      int causal, float scale
#define FWD_PASS                                                            \
  device, q, k, v, out, lse, batch, seq, heads, kv_heads, head_dim, q_sb,   \
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,     \
      causal, scale

// B1, and B4's forward (softcap 0 turns the cap off).
#define FWD_ENTRIES(SUFFIX, T)                                              \
  int flash_attention_fwd_##SUFFIX(FWD_ARGS, void* stream) {               \
    return entry<T>(FWD_PASS, 0.f, false, stream);                          \
  }                                                                         \
  int splash_attention_fwd_##SUFFIX(FWD_ARGS, float softcap,                \
                                    void* stream) {                         \
    return entry<T>(FWD_PASS, softcap, true, stream);                       \
  }

FWD_ENTRIES(bf16, __nv_bfloat16)
FWD_ENTRIES(f16, __half)
FWD_ENTRIES(f32, float)

#undef FWD_ENTRIES
#undef FWD_PASS
#undef FWD_ARGS

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
