// Causal and/or sliding-window flash attention (prefill), online softmax in
// f32, grouped-query heads read in place, optional logit softcap and query
// offset.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:
// flash_attention_bhsd (_flash_kernel). That kernel takes q (BH,S,D) and k/v
// (BH,T,D), so its JAX wrapper (kernels/ops.py:flash_attention) copies every
// KV head G times and transposes q, k and v; it also needs S and T to be
// multiples of its blocks. Its grid walks the KV blocks in order and keeps
// m, l and acc in VMEM from one grid step to the next.
//
// Here: q (B,S,H,D) and k/v (B,T,K,D) are read where they lie, through their
// batch and sequence strides; query head h reads KV head h / (H/K). One CTA
// owns one (b, h, tile of queries) and loops over KV tiles inside the block
// (CUDA grids run in no order, so the sequential KV axis of the TPU grid
// becomes this loop). Query i sits at position i + q_offset. A KV tile
// wholly above the diagonal or before the window of the CTA's queries is
// never loaded, and only tiles that cross the diagonal, the window's edge or
// T pay for the mask; keys past T and queries past S are masked, so any S
// and T work. A query row with no visible key gives 0. Scores are
// s = (q.k)/sqrt(D), then softcap * tanh(s / softcap) where softcap > 0.
//
// Bound on the H100: at the serve shape (S = T = 512, D = 64, causal) bytes
// and operations are close, 5.6 us to move q, k, v and out once against
// 4.4 us for the 4*S*T*D/2 flops per head at the bf16 tensor-core rate; the
// operations grow as S*T and take over for longer prompts.
//
// bf16 (the served type), for Hopper (sm_90a): both products run on wgmma,
// fed from shared memory by TMA, warp-specialised.
//  - A CTA is a producer warpgroup and one consumer warpgroup of 64 query
//    rows (two CTAs an SM) up to D 64, two consumers (128 rows, one CTA an
//    SM) above it (``Shape``). The producer gives up registers (setmaxnreg
//    24) and the consumers ask for the rest; ptxas still allocates every
//    thread under the launch bounds' cap (128 or 168 registers), which is
//    what sizes the tiles.
//  - One producer thread loads the CTA's Q tile once, then K and V tiles of
//    64 keys into a ring of four stages with cp.async.bulk.tensor; each
//    stage has a full mbarrier (the TMA bytes land on it) and an empty one
//    (each consumer warp arrives when its products have read the stage).
//  - S = Q.K^T is wgmma m64n64k16 with Q and K both K-major (D contiguous)
//    in shared memory. Q, K and V are stored as boxes of W columns of D (W
//    = 64, 32 or 16 bf16: the widest that divides D) with the matching
//    128-, 64- or 32-byte swizzle, which TMA writes and the wgmma
//    descriptors read; a k-slice of 16 inside a box row adds its offset to
//    the descriptor's start address.
//  - The online softmax (running m, l per row, base-2 exponent) runs on the
//    S accumulators, whose per-thread layout is mma.sync's (hopper.cuh).
//    Only tiles that cross the diagonal, the window's edge or T run the
//    mask, and only a capped call the tanh, each in a loop of its own.
//  - O += P.V is wgmma m64nDk16 with P from registers and V from shared
//    memory as the transposed (MN-major) B operand. P is carried as two
//    bf16 terms (hi = bf16(p), lo = bf16(p - hi)) through two products, so
//    P keeps about 16 bits; l is summed from the f32 p. (P rounded once to
//    bf16, as the reference model rounds its probabilities, moved
//    tinyllama-1.1b's bf16 decode-against-prefill logits gap at full depth
//    on an H100 from 0.083 to 0.104, past its 0.1 limit.)
//  - Each consumer is software-pipelined: it issues S of tile i and P.V of
//    tile i - 1 together, and runs tile i's softmax while the tensor cores
//    finish P.V.
//  - Query tiles are launched last first, so that the longest causal rows
//    start first; the G query heads of one KV head sit next to each other
//    in the grid, so that their K/V tiles are read from L2 after the first.
//  - The tensor maps (4-D: D, heads, S or T, B, with the caller's strides)
//    are encoded per call on the host by cuTensorMapEncodeTiled, reached
//    through cudaGetDriverEntryPoint (hopper.cuh::encode_map), so the
//    library links no libcuda. TMA
//    needs 16-byte-aligned bases and strides that are multiples of 16
//    bytes; the wrapper checks both. Rows past S or T arrive as zeros and
//    are masked.
//
// f32: the tolerance (2e-5) rules out TF32 and bf16 products, so the f32
// kernel computes on the CUDA cores: TPR threads share a query row (TPR the
// least power of two that leaves at most 40 dims a thread), each keeping its
// dims of q and of the running acc in registers, and K/V tiles of 32 keys
// are staged as f32 with a padded layout.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using repro::kNeg;

// KV range [lo, hi) that the queries q0 .. q0 + bq - 1 (at positions shifted
// by q_offset) may see.
__device__ __forceinline__ void kv_range(int q0, int bq, int t_len, int causal, int window,
                                         int q_offset, int& lo, int& hi) {
  lo = 0;
  hi = t_len;
  if (causal) hi = min(t_len, max(0, q0 + bq + q_offset));
  if (window > 0) lo = max(0, q0 + q_offset - window + 1);
}

__device__ __forceinline__ float cap(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBK = 64;       // keys per KV tile
constexpr int kStages = 4;    // K/V tiles in the ring
constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;

// The CTA's shape for head dim D: consumer warpgroups of 64 query rows
// each, and CTAs an SM. Up to D 64 one consumer and two CTAs an SM (one
// CTA's loads and epilogue overlap the other's products); above it the
// accumulators of O no longer fit the 128 registers a thread of two such
// CTAs may hold, so two consumers share one CTA an SM (168 registers).
// Registers after setmaxnreg: the producer keeps 24, the consumers share
// the rest of a CTA's part of the SM's 64K, less 1K (at most 240 a
// thread; a split that adds up to all 64K left setmaxnreg.inc waiting).
template <int D>
struct Shape {
  static constexpr int CONSUMERS = D <= 64 ? 1 : 2;
  static constexpr int CTAS = D <= 64 ? 2 : 1;
  static constexpr int BQ = 64 * CONSUMERS;  // queries per CTA
  static constexpr int THREADS = 128 * (CONSUMERS + 1);
  static constexpr int SPLIT =
      (65536 / CTAS - 1024 - 128 * kProducerRegs) / (128 * CONSUMERS) / 8 * 8;
  static constexpr int CONSUMER_REGS = SPLIT < 240 ? SPLIT : 240;
};

// Shared memory of one CTA: Q, then the K stages, the V stages and the
// barriers (full[kStages], empty[kStages], q_full), after up to 1024 bytes
// that align the tiles to the swizzle's period.
template <int D>
struct Tiles {
  static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;  // columns of a box
  static constexpr int BOXES = D / W;
  static constexpr int ROW = 2 * W;                                   // bytes of a box row
  static constexpr uint32_t SWIZZLE = W == 64 ? 1 : W == 32 ? 2 : 3;  // descriptor code
  static constexpr int Q_BOX = Shape<D>::BQ * ROW, KV_BOX = kBK * ROW;
  static constexpr int Q_BYTES = BOXES * Q_BOX, KV_BYTES = BOXES * KV_BOX;
  static constexpr int BARRIERS = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr int SMEM = 1024 + BARRIERS + 8 * (2 * kStages + 1);
  static_assert(D % 16 == 0 && Q_BOX % 1024 == 0 && KV_BOX % 1024 == 0,
                "boxes must keep the swizzle's alignment");
};

// One unit of work: a tile of BQ queries of one (batch, head), and the KV
// tiles those queries may see.
struct Work {
  int b, h, kvh, q0, t_first, n_tiles;
};

// Work item ``item``: the grid walks the query tiles last first (the SMs
// take CTAs in about the order of their index, so the longest causal rows
// start first), and inside a tile the batches and heads, with the G heads
// of one KV head side by side (so that their K/V tiles are read from L2
// after the first).
template <int BQ>
__device__ __forceinline__ Work work_item(int item, int batch, int s_len, int t_len,
                                          int n_heads, int n_kv, int causal, int window,
                                          int q_offset) {
  Work w;
  const int per_tile = batch * n_heads, n_qt = (s_len + BQ - 1) / BQ;
  const int r = item % per_tile;
  w.b = r / n_heads;
  w.h = r % n_heads;
  w.kvh = w.h / (n_heads / n_kv);
  w.q0 = (n_qt - 1 - item / per_tile) * BQ;
  int lo, hi;
  kv_range(w.q0, BQ, t_len, causal, window, q_offset, lo, hi);
  w.t_first = (lo / kBK) * kBK;
  w.n_tiles = hi > w.t_first ? (hi - w.t_first + kBK - 1) / kBK : 0;
  return w;
}

// One CTA a work item. (A persistent grid of one CTA an SM, walking the
// items in a fixed order with the producer running ahead into the next
// item, measured slower at the causal shapes: the card's own scheduling
// balances unequal tiles better.)
template <int D>
__global__ void __launch_bounds__(Shape<D>::THREADS, Shape<D>::CTAS)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                            const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap,
                            __nv_bfloat16* __restrict__ o, int batch, int s_len, int t_len,
                            int n_heads, int n_kv, long long o_sb, long long o_ss, int causal,
                            int window, int q_offset, float scale, float softcap) {
  using T = Tiles<D>;
  constexpr int KD = D / 16;    // k-slices of Q.K^T
  constexpr int NB = kBK / 8;   // 8-key column blocks of S
  constexpr int NO = D / 8;     // 8-dim column blocks of O
  constexpr int KP = kBK / 16;  // k-slices of P.V
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (repro::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t qs = base, ks = base + T::Q_BYTES, vs = ks + kStages * T::KV_BYTES;
  // Barriers: full[kStages], empty[kStages], q_full.
  const uint32_t bars = base + T::BARRIERS;
  auto full = [&](int i) { return bars + 8 * (i % kStages); };
  auto empty = [&](int i) { return bars + 8 * (kStages + i % kStages); };
  const uint32_t q_full = bars + 16 * kStages;
  const Work w = work_item<Shape<D>::BQ>(blockIdx.x, batch, s_len, t_len, n_heads, n_kv, causal,
                                          window, q_offset);

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) {
      repro::mbar_init(full(i), 1);
      repro::mbar_init(empty(i), 4 * Shape<D>::CONSUMERS);
    }
    repro::mbar_init(q_full, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (wg == Shape<D>::CONSUMERS) {
    // Producer: one thread issues every load.
    repro::setmaxnreg_dec<kProducerRegs>();
    if (tid == 0 && w.n_tiles > 0) {
      repro::tma_prefetch_map(&qmap);
      repro::tma_prefetch_map(&kmap);
      repro::tma_prefetch_map(&vmap);
      repro::mbar_arrive_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < T::BOXES; ++c)
        repro::tma_load_4d(qs + c * T::Q_BOX, &qmap, q_full, c * T::W, w.h, w.q0, w.b);
      for (int it = 0; it < w.n_tiles; ++it) {
        if (it >= kStages) repro::mbar_wait(empty(it), (it / kStages - 1) & 1);
        repro::mbar_arrive_expect_tx(full(it), 2 * T::KV_BYTES);
        const int s = it % kStages, t0 = w.t_first + it * kBK;
#pragma unroll
        for (int c = 0; c < T::BOXES; ++c) {
          repro::tma_load_4d(ks + s * T::KV_BYTES + c * T::KV_BOX, &kmap, full(it), c * T::W,
                             w.kvh, t0, w.b);
          repro::tma_load_4d(vs + s * T::KV_BYTES + c * T::KV_BOX, &vmap, full(it), c * T::W,
                             w.kvh, t0, w.b);
        }
      }
    }
    return;
  }

  // Consumers.
  repro::setmaxnreg_inc<Shape<D>::CONSUMER_REGS>();
  const int warp = tid >> 5, lane = tid & 31;
  const int group = lane >> 2, quad = lane & 3;
  const int qw0 = w.q0 + 64 * wg;  // this warpgroup's first query
  // The two query rows of this lane's accumulator fragments.
  const int row0 = 64 * wg + 16 * warp + group;
  const int pos0 = w.q0 + row0 + q_offset, pos1 = pos0 + 8;
  const uint32_t q_tile = qs + 64 * wg * T::ROW;

  float sacc[kBK / 2], oacc[D / 2];
  uint32_t ph[KP][4], pl[KP][4];  // P of the tile before, as hi + lo
#pragma unroll
  for (int i = 0; i < kBK / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  // Issue S = Q.K^T of tile ``it`` (this warpgroup's 64 rows against the
  // tile's keys) once its stage has landed.
  auto issue_scores = [&](int it) {
    const uint32_t kt = ks + (it % kStages) * T::KV_BYTES;
    repro::mbar_wait(full(it), (it / kStages) & 1);
#pragma unroll
    for (int j = 0; j < KD; ++j) {
      const int c = 16 * j / T::W, off = (16 * j % T::W) * 2;
      repro::wgmma_ss<kBK>(
          sacc, repro::gmma_desc(q_tile + c * T::Q_BOX + off, 16, 8 * T::ROW, T::SWIZZLE),
          repro::gmma_desc(kt + c * T::KV_BOX + off, 16, 8 * T::ROW, T::SWIZZLE), j > 0);
    }
    repro::wgmma_commit();
  };
  // Issue O += P.V of tile ``it``, hi and lo through the same V slice.
  auto issue_pv = [&](int it) {
    const uint32_t vt = vs + (it % kStages) * T::KV_BYTES;
#pragma unroll
    for (int j = 0; j < KP; ++j) {
      const uint64_t dv =
          repro::gmma_desc(vt + j * 16 * T::ROW, T::KV_BOX, 8 * T::ROW, T::SWIZZLE);
      repro::wgmma_rs_tb<D>(oacc, ph[j], dv);
      repro::wgmma_rs_tb<D>(oacc, pl[j], dv);
    }
    repro::wgmma_commit();
  };
  // Each warp frees tile ``it``'s stage once its products have read it.
  auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) repro::mbar_arrive(empty(it));
  };
  // The online softmax of tile ``it``'s scores, in place: scale (and cap)
  // them into base-2 units, mask where the tile crosses the diagonal, the
  // window's edge or T for this warpgroup's rows, update m and l, and leave
  // p in sacc; a0, a1 are the factors O must be scaled by. The cap and the
  // mask are loops of their own, so that no tile pays for a branch it does
  // not take. The arithmetic is, operation for operation, that of this
  // kernel's earlier mma.sync form, and so are the output bits: phase 11 of
  // chip_smoke.py gates a training run (whisper-base) that turns on one
  // chaotic step and was set on those bits.
  auto softmax = [&](int it, float& a0, float& a1) {
    const int t0 = w.t_first + it * kBK;
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sacc[i] = cap(sacc[i] * scale, softcap) * kLog2e;
    } else {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) sacc[i] = sacc[i] * scale * kLog2e;
    }
    if (t0 + kBK > t_len || (causal && t0 + kBK - 1 > qw0 + q_offset) ||
        (window > 0 && t0 <= qw0 + 63 + q_offset - window)) {
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = t0 + n * 8 + 2 * quad + (e & 1);
          const int qp = e < 2 ? pos0 : pos1;
          if (kp >= t_len || (causal && kp > qp) || (window > 0 && kp <= qp - window))
            sacc[4 * n + e] = -INFINITY;
        }
      }
    }
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      mt0 = fmaxf(mt0, fmaxf(sacc[4 * n], sacc[4 * n + 1]));
      mt1 = fmaxf(mt1, fmaxf(sacc[4 * n + 2], sacc[4 * n + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mt0 = fmaxf(mt0, __shfl_xor_sync(0xffffffffu, mt0, off));
      mt1 = fmaxf(mt1, __shfl_xor_sync(0xffffffffu, mt1, off));
    }
    const float mn0 = fmaxf(m0, mt0), mn1 = fmaxf(m1, mt1);
    // A row that has seen no key yet keeps m = -inf; subtract 0 instead so
    // that exp2 gives 0, not NaN.
    const float ms0 = mn0 == -INFINITY ? 0.f : mn0, ms1 = mn1 == -INFINITY ? 0.f : mn1;
    a0 = exp2f(m0 - ms0);
    a1 = exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      sacc[4 * n] = exp2f(sacc[4 * n] - ms0);
      sacc[4 * n + 1] = exp2f(sacc[4 * n + 1] - ms0);
      sacc[4 * n + 2] = exp2f(sacc[4 * n + 2] - ms1);
      sacc[4 * n + 3] = exp2f(sacc[4 * n + 3] - ms1);
      l0 += sacc[4 * n] + sacc[4 * n + 1];
      l1 += sacc[4 * n + 2] + sacc[4 * n + 3];
    }
  };
  // Scale O by a0, a1 and take P (in sacc) as the A operand of P.V: slice
  // j holds keys 16j .. 16j + 15, S blocks 2j and 2j + 1.
  auto rescale_and_pack = [&](float a0, float a1) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      oacc[4 * n] *= a0;
      oacc[4 * n + 1] *= a0;
      oacc[4 * n + 2] *= a1;
      oacc[4 * n + 3] *= a1;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int j = n / 2, r = 2 * (n % 2);
      repro::split_bf16(sacc[4 * n], sacc[4 * n + 1], ph[j][r], pl[j][r]);
      repro::split_bf16(sacc[4 * n + 2], sacc[4 * n + 3], ph[j][r + 1], pl[j][r + 1]);
    }
  };

  if (w.n_tiles > 0 && qw0 < s_len) {
    // Software pipeline: while the softmax of tile it runs, the tensor
    // cores compute P.V of tile it - 1.
    repro::mbar_wait(q_full, 0);
    float a0, a1;
    repro::fence_regs(sacc);
    repro::wgmma_fence();
    issue_scores(0);
    repro::wgmma_wait<0>();
    repro::fence_regs(sacc);
    softmax(0, a0, a1);
    rescale_and_pack(a0, a1);
    for (int it = 1; it < w.n_tiles; ++it) {
      repro::fence_regs(sacc);
      repro::fence_regs(oacc);
      repro::fence_regs(ph);
      repro::fence_regs(pl);
      repro::wgmma_fence();
      issue_scores(it);
      issue_pv(it - 1);
      repro::wgmma_wait<1>();  // the scores; P.V may still run
      repro::fence_regs(sacc);
      softmax(it, a0, a1);
      repro::wgmma_wait<0>();
      repro::fence_regs(oacc);
      // P's registers stay untouched until the products have read them.
      repro::fence_regs(ph);
      repro::fence_regs(pl);
      release(it - 1);
      rescale_and_pack(a0, a1);
    }
    repro::fence_regs(oacc);
    repro::fence_regs(ph);
    repro::fence_regs(pl);
    repro::wgmma_fence();
    issue_pv(w.n_tiles - 1);
    repro::wgmma_wait<0>();
    repro::fence_regs(oacc);
    release(w.n_tiles - 1);
  } else {  // no query of this warpgroup is below S: only free the stages
    for (int it = 0; it < w.n_tiles; ++it) {
      repro::mbar_wait(full(it), (it / kStages) & 1);
      release(it);
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
  const int qa = w.q0 + row0, qb = qa + 8;
  __nv_bfloat16* oa = o + w.b * o_sb + static_cast<long long>(qa) * o_ss +
                      static_cast<long long>(w.h) * D + 2 * quad;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    if (qa < s_len)
      *reinterpret_cast<__nv_bfloat162*>(oa + n * 8) =
          __floats2bfloat162_rn(oacc[4 * n] * r0, oacc[4 * n + 1] * r0);
    if (qb < s_len)
      *reinterpret_cast<__nv_bfloat162*>(oa + 8 * o_ss + n * 8) =
          __floats2bfloat162_rn(oacc[4 * n + 2] * r1, oacc[4 * n + 3] * r1);
  }
}

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kBQ32 = 64;  // queries per CTA of the f32 kernel
constexpr int kBK32 = 32;  // keys per KV tile of the f32 kernel

// How a query row's D dims are split over threads: TPR threads (a power of
// two, so a row's threads sit in one warp) of DP dims each, the fewest
// threads that leave at most 40 dims a thread; PS floats per (key, thread
// part) in shared memory, padded so the parts of a row start in different
// banks.
template <int D>
struct Split {
  static constexpr int TPR = D <= 40 ? 1 : D <= 80 ? 2 : D <= 160 ? 4 : 8;
  static constexpr int DP = D / TPR;
  static constexpr int PS = DP + 4;
  static_assert(D % TPR == 0 && DP % 4 == 0, "D must split into 16-byte vectors");
};

// Stage rows t0..t0+kBK32-1 of one KV head into dst[key][part][PS]; rows at
// or past tk are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const float* __restrict__ base,
                                          long long stride_t, int t0, int tk) {
  constexpr int PER_ROW = D / 4;
  constexpr int kDP = Split<D>::DP, kPS = Split<D>::PS;
  constexpr int RS = Split<D>::TPR * kPS;
  for (int i = threadIdx.x; i < kBK32 * PER_ROW; i += blockDim.x) {
    const int j = i / PER_ROW;
    const int c = (i % PER_ROW) * 4;
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t0 + j < tk)
      f = *reinterpret_cast<const float4*>(base + static_cast<long long>(t0 + j) * stride_t + c);
    *reinterpret_cast<float4*>(dst + j * RS + (c / kDP) * kPS + (c % kDP)) = f;
  }
}

template <int D>
__global__ void __launch_bounds__(kBQ32 * Split<D>::TPR)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int s_len,
                           int t_len, int n_heads, int n_kv, long long q_sb, long long q_ss,
                           long long k_sb, long long k_st, long long v_sb, long long v_st,
                           long long o_sb, long long o_ss, int causal, int window, int q_offset,
                           float scale, float softcap) {
  constexpr int TPR = Split<D>::TPR;  // threads per query row
  constexpr int kDP = Split<D>::DP, kPS = Split<D>::PS;
  constexpr int RS = TPR * kPS;
  __shared__ __align__(16) float ks[kBK32 * RS];
  __shared__ __align__(16) float vs[kBK32 * RS];

  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ32;
  const int qi = q0 + row;
  const int qpos = qi + q_offset;
  const int kvh = h / (n_heads / n_kv);

  float qr[kDP];
  if (qi < s_len) {
    const float* qp = q + b * q_sb + qi * q_ss + static_cast<long long>(h) * D + part * kDP;
#pragma unroll
    for (int c = 0; c < kDP; c += 4) {
      const float4 f = *reinterpret_cast<const float4*>(qp + c);
      qr[c] = f.x;
      qr[c + 1] = f.y;
      qr[c + 2] = f.z;
      qr[c + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < kDP; ++c) qr[c] = 0.f;
  }

  float m = kNeg, l = 0.f;
  float acc[kDP];
#pragma unroll
  for (int c = 0; c < kDP; ++c) acc[c] = 0.f;

  int lo, hi;
  kv_range(q0, kBQ32, t_len, causal, window, q_offset, lo, hi);
  const float* kb = k + b * k_sb + static_cast<long long>(kvh) * D;
  const float* vb = v + b * v_sb + static_cast<long long>(kvh) * D;

  for (int t0 = (lo / kBK32) * kBK32; t0 < hi; t0 += kBK32) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<D>(ks, kb, k_st, t0, t_len);
    load_tile<D>(vs, vb, v_st, t0, t_len);
    __syncthreads();

    float sc[kBK32];
    unsigned valid = 0u;
    float mt = kNeg;
#pragma unroll
    for (int j = 0; j < kBK32; ++j) {
      const float* kr = ks + j * RS + part * kPS;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kDP; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + c);
        dot += qr[c] * kv.x + qr[c + 1] * kv.y + qr[c + 2] * kv.z + qr[c + 3] * kv.w;
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[j] = cap(dot * scale, softcap);
      const int kp = t0 + j;
      const bool ok = kp < t_len && (!causal || kp <= qpos) && (window <= 0 || kp > qpos - window);
      if (ok) {
        valid |= 1u << j;
        mt = fmaxf(mt, sc[j]);
      }
    }
    if (valid != 0u) {
      const float mn = fmaxf(m, mt);
      const float alpha = expf(m - mn);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < kDP; ++c) acc[c] *= alpha;
#pragma unroll
      for (int j = 0; j < kBK32; ++j) {
        if (valid & (1u << j)) {
          const float p = expf(sc[j] - mn);
          l += p;
          const float* vr = vs + j * RS + part * kPS;
#pragma unroll
          for (int c = 0; c < kDP; c += 4) {
            const float4 vv = *reinterpret_cast<const float4*>(vr + c);
            acc[c] += p * vv.x;
            acc[c + 1] += p * vv.y;
            acc[c + 2] += p * vv.z;
            acc[c + 3] += p * vv.w;
          }
        }
      }
      m = mn;
    }
  }

  if (qi < s_len) {
    const float denom = fmaxf(l, 1e-30f);
    float* op = o + b * o_sb + qi * o_ss + static_cast<long long>(h) * D + part * kDP;
#pragma unroll
    for (int c = 0; c < kDP; c += 4)
      *reinterpret_cast<float4*>(op + c) =
          make_float4(acc[c] / denom, acc[c + 1] / denom, acc[c + 2] / denom, acc[c + 3] / denom);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  int b, s, t, h, kv;
  long long st[8];
  int causal, window, q_offset;
  float scale, softcap;
};

// A 4-D map (D, heads, rows, batch) over a bf16 tensor whose heads lie D
// apart, boxes of (W, 1, box_rows, 1) with the swizzle of Tiles<D>.
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int heads, int rows, int batch,
            long long row_stride, long long batch_stride, int box_rows) {
  using T = Tiles<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(T::W), 1u,
                             static_cast<cuuint32_t>(box_rows), 1u};
  return repro::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                           2 * T::W);
}

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr int smem = Tiles<D>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  if (repro::tensor_map_encoder() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  if ((a.st[0] | a.st[1] | a.st[2] | a.st[3] | a.st[4] | a.st[5]) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA: strides of 16 bytes
  CUtensorMap qm, km, vm;
  if (!encode<D>(&qm, a.q, a.h, a.s, a.b, a.st[1], a.st[0], Shape<D>::BQ) ||
      !encode<D>(&km, a.k, a.kv, a.t, a.b, a.st[3], a.st[2], kBK) ||
      !encode<D>(&vm, a.v, a.kv, a.t, a.b, a.st[5], a.st[4], kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (a.s + Shape<D>::BQ - 1) / Shape<D>::BQ * a.b * a.h;
  flash_attention_bf16_kernel<D><<<grid, Shape<D>::THREADS, smem, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(a.o), a.b, a.s, a.t, a.h, a.kv, a.st[6],
      a.st[7], a.causal, a.window, a.q_offset, a.scale, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  const dim3 grid((a.s + kBQ32 - 1) / kBQ32, a.h, a.b), block(kBQ32 * Split<D>::TPR);
  flash_attention_f32_kernel<D><<<grid, block, 0, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.s, a.t, a.h, a.kv, a.st[0],
      a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], a.causal, a.window,
      a.q_offset, a.scale, a.softcap);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch(const Args& a, int d, cudaStream_t stream) {
  if (a.b <= 0 || a.s <= 0 || a.t <= 0 || a.kv <= 0 || a.h % a.kv != 0 || a.b > 65535 ||
      a.h > 65535 || static_cast<long long>((a.s + 63) / 64) * a.b * a.h > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!repro::aligned16(a.q) || !repro::aligned16(a.k) || !repro::aligned16(a.v) ||
      !repro::aligned16(a.o))
    return static_cast<int>(cudaErrorMisalignedAddress);
#define REPRO_CASE(D) \
  case D: return BF16 ? launch_bf16<D>(a, stream) : launch_f32<D>(a, stream);
  switch (d) {
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(80)
    REPRO_CASE(96)
    REPRO_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_CASE
}

}  // namespace

// q (B,S,H,D), k/v (B,T,K,D), o (B,S,H,D): unit stride over D, heads D apart;
// strides (in elements) in the order q_b, q_s, k_b, k_t, v_b, v_t, o_b, o_s.
// For bf16 the q, k and v strides must be multiples of 8 (16 bytes, for TMA).
#define REPRO_FLASH_ENTRY(NAME, BF16)                                                     \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, int b, int s, \
                      int t, int h, int kv, int d, long long q_sb, long long q_ss,        \
                      long long k_sb, long long k_st, long long v_sb, long long v_st,     \
                      long long o_sb, long long o_ss, int causal, int window,             \
                      int q_offset, float scale, float softcap, void* stream) {           \
    const Args a{q, k, v, o, b, s, t, h, kv,                                              \
                 {q_sb, q_ss, k_sb, k_st, v_sb, v_st, o_sb, o_ss},                        \
                 causal, window, q_offset, scale, softcap};                               \
    return launch<BF16>(a, d, static_cast<cudaStream_t>(stream));                         \
  }

REPRO_FLASH_ENTRY(repro_flash_attention_f32, false)
REPRO_FLASH_ENTRY(repro_flash_attention_bf16, true)
