// Flash decode: one query token for each head of a grouped-query group
// against a length-masked KV cache, split over the keys (flash-decoding);
// online softmax in f32, optional sliding window and logit softcap; the
// scores are scale * (q.k), the scale the wrapper's (1/sqrt(D) unless the
// model gives its own).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_bkgd (_decode_kernel). That kernel takes q (BK,G,D) and
// k/v (BK,T,D), so its JAX wrapper (kernels/ops.py:flash_decode) transposes
// the whole KV cache on every decode step; it also needs T to be a multiple
// of its block, and gets the lengths by scalar prefetch. Its grid walks the
// KV blocks of one (b, kv head) in order on one core.
//
// Bound on the H100: bytes, and at the served shapes latency. A step reads
// the cache rows below each row's length once and does 4 * G flops per
// cache element (16 flops a byte at G = 8, far below the ridge point). At
// batch 4 there are only B*K = 16 (tinyllama) to 128 (zamba2) (b, kv head)
// pairs and 0.4 to 16 us of bytes, so a call's time is launch, one DRAM
// round trip and the chain of work after it: the design keeps that chain
// short.
//
// The wrapper cuts the cache capacity T into splits of a multiple of 64
// keys, their count chosen from T and the CTA count (one wave of CTAs:
// more, shorter splits measured slower, each CTA's chain being latency),
// never from the lengths (which live on the device), and at most 16: the
// splits of one (b, kv head, group of up to 16 query heads) form one
// thread block cluster. Each CTA reads lengths[b] itself and intersects its
// split with the visible keys [max(0, len - window), len).
//
// bf16 (the served type), for Hopper (sm_90a), one launch and no scratch:
//  - One thread issues the CTA's K and V tiles of 64 keys by TMA
//    (cp.async.bulk.tensor over the (B,T,K,D) cache, boxes of 64 or 32
//    columns with the 128- or 64-byte swizzle, as K2's; at D 80 one
//    unswizzled box of 160-byte rows, whose ldmatrix reads meet 2-way bank
//    conflicts, measured 1.13x faster at zamba2's shape than five 32-byte
//    boxes) into a ring of 2 to 4 stages (at most 3 above D 128, whose four
//    would not fit in shared memory) with an mbarrier each; a split of
//    several tiles keeps them all in flight, and a stage is refilled once
//    every warp has read it. Keys past T arrive as zeros and are masked with
//    the rest.
//  - Four warps each take 16 keys of a tile. The scores run on the tensor
//    cores with the keys as the M dimension: S^T = K.q^T by mma.sync
//    m16n8k16 (K from the swizzled tile by ldmatrix, q from registers, the
//    heads padded to 8 or 16), exact products in f32. Each warp keeps its
//    own online softmax (base 2) per head on the accumulator fragments. P
//    goes to the A operand of O = P.V by movmatrix's transpose, as two bf16
//    terms hi + lo (about 16 bits of p), V by ldmatrix.trans: no scalar
//    reads of V, no shared-memory round trip for P, and no CTA-wide barrier
//    but one a tile (the ring's refill).
//  - After the last tile the warps' states merge in shared memory into the
//    CTA's (m, l, acc) per head; a cluster barrier, then each CTA reads
//    every CTA's m and l over distributed shared memory
//    (cluster.map_shared_rank; a lane per split, a warp per head), weighs
//    them e^(m_s - M) over the splits with l > 0, over max(sum, 1e-30), and
//    writes its share of the (head, dim) outputs from the others' acc. A
//    row of length 0 has no such split and gives zeros, as the TPU kernel
//    does. A second cluster barrier keeps every CTA's state alive until all
//    have read it.
//  - A call encodes its two tensor maps on the host (hopper.cuh::encode_map;
//    a cache of them measured no host time saved a call, with
//    benchmarks/torch_kernel_variants.py --host) and launches once with
//    cudaLaunchKernelEx and a cluster dimension of the split count (16
//    needs the non-portable cluster size).
//
// f32 (checks of the f32 model, no serve path): two passes through a global
// scratch, on the CUDA cores. Pass 1 (decode_split_kernel): one 128-thread
// CTA per (split, kv head and head group, b) walks its range in tiles of 64
// keys held in a two-stage cp.async ring (rows padded by 16 bytes), one
// thread per (head, key) for the scores, one warp per head for the softmax,
// threads over (head, dim pair) for P.V, and writes (m, l, acc[D]) to its
// scratch row (m = -1e30, l = 0 where it sees no key). Pass 2
// (decode_combine_kernel): one warp per (b, query head) merges the splits'
// states with the weights above.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;
using repro::kNeg;
using repro::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;          // keys per tile
constexpr int kGroup = 16;       // query heads per CTA at most
constexpr int kMaxCluster = 16;  // splits of one cluster at most (non-portable size)

// ---------------------------------------------------------------------------
// bf16: one clustered launch
// ---------------------------------------------------------------------------

constexpr int kMaxStages = 4;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a CTA for head dim D, from a 1024-byte-aligned base: the
// ring (stages of a K tile then a V tile), the queries [kGroup][QROW] in
// bf16, and the stages' full barriers. Once the last tile is read, the
// ring's first bytes hold the merge: each warp's state (acc [kGroup][AROW],
// m, l), the CTA's merged state (acc [kGroup][D], m, l), which the cluster
// reads, and this CTA's weights of the cluster's states [kGroup][16].
template <int D>
struct Ring {
  static constexpr int W = D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : D;  // columns of a box
  static constexpr int BOXES = D / W;
  static constexpr int ROW = 2 * W;                                 // bytes of a box row
  static constexpr uint32_t MASK = W == 64 ? 7 : W == 32 ? 3 : 0;   // the swizzle's lines
  static constexpr int BOX = kBK * ROW;
  static constexpr int TILE = BOXES * BOX;  // bytes of a K or V tile
  static constexpr int QROW = D + 8;        // padded query row, elements
  static constexpr int AROW = D + 8;        // padded acc row of a warp's state, floats
  static constexpr int WARP_ACC = 0;
  static constexpr int WARP_M = WARP_ACC + 4 * kWarps * kGroup * AROW;
  static constexpr int WARP_L = WARP_M + 4 * kWarps * kGroup;
  static constexpr int CTA_ACC = WARP_L + 4 * kWarps * kGroup;
  static constexpr int CTA_M = CTA_ACC + 4 * kGroup * D;
  static constexpr int CTA_L = CTA_M + 4 * kGroup;
  static constexpr int WTS = CTA_L + 4 * kGroup;
  static constexpr int MERGE_END = WTS + 4 * kGroup * kMaxCluster;
  static_assert(D % 16 == 0 && BOX % 1024 == 0, "boxes must keep the swizzle's alignment");
  static_assert(MERGE_END <= 2 * 2 * TILE, "the smallest ring must hold the merge");
  static constexpr int FIXED = 1024 + 2 * kGroup * QROW, STAGE = 2 * TILE + 8;
  static int smem(int stages) { return FIXED + stages * STAGE; }
  // The most stages that fit the SM's shared memory, up to kMaxStages.
  static constexpr int MAX_STAGES = FIXED + kMaxStages * STAGE <= 232448 ? kMaxStages
                                    : FIXED + (kMaxStages - 1) * STAGE <= 232448 ? kMaxStages - 1
                                                                                  : 2;
  static_assert(FIXED + MAX_STAGES * STAGE <= 232448, "two stages must fit the SM's shared memory");
};

// One CTA: split blockIdx.x of (kv head and head group blockIdx.y, batch
// blockIdx.z); the cluster is the split axis. NB: blocks of 8 query heads.
template <int D, int NB>
__global__ void __launch_bounds__(kThreads)
decode_cluster_kernel(const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const bf16* __restrict__ q,
                      const int* __restrict__ lengths, bf16* __restrict__ o, int t_len,
                      int g_heads, int n_hg, int split_len, int stages, long long q_sb,
                      long long o_sb, int window, float scale, float softcap) {
  using R = Ring<D>;
  constexpr int KS = D / 16;  // k-slices of the scores, 16-column blocks of O
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (repro::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = repro::smem_u32(base);
  bf16* qs = reinterpret_cast<bf16*>(base + stages * 2 * R::TILE);
  const uint32_t bars = repro::smem_u32(qs + kGroup * R::QROW);
  auto full = [&](int it) { return bars + 8 * (it % stages); };

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg, b = blockIdx.z;
  const int nh = min(kGroup, g_heads - hg * kGroup);  // heads of this CTA
  const int h0 = kvh * g_heads + hg * kGroup;         // its first query head
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = lane >> 2, quad = lane & 3;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) repro::mbar_init(bars + 8 * i, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();
  // Tile ``it`` (keys t0 .. t0 + 63) of K and V into its stage, completing
  // on its barrier.
  auto issue = [&](int it, int t0) {
    const uint32_t kt = sbase + (it % stages) * 2 * R::TILE, vt = kt + R::TILE;
    repro::mbar_arrive_expect_tx(full(it), 2 * R::TILE);
#pragma unroll
    for (int c = 0; c < R::BOXES; ++c) {
      repro::tma_load_4d(kt + c * R::BOX, &kmap, full(it), c * R::W, kvh, t0, b);
      repro::tma_load_4d(vt + c * R::BOX, &vmap, full(it), c * R::W, kvh, t0, b);
    }
  };
  const int len = min(max(lengths[b], 0), t_len);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int s0 = split * split_len;
  const int vlo = max(s0, lo), vhi = min(min(s0 + split_len, t_len), len);
  const int t_first = vlo < vhi ? s0 + (vlo - s0) / kBK * kBK : 0;
  const int n_tiles = vlo < vhi ? (vhi - t_first + kBK - 1) / kBK : 0;
  if (tid == 0)
    for (int it = 0; it < min(stages, n_tiles); ++it) issue(it, t_first + it * kBK);

  // The CTA's queries, rows past nh zero, while the first tiles load.
  {
    const bf16* qb = q + b * q_sb + static_cast<long long>(h0) * D;
    for (int i = tid; i < kGroup * (D / 8); i += kThreads) {
      const int g = i / (D / 8), c = i % (D / 8) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (g < nh) v = *reinterpret_cast<const uint4*>(qb + g * D + c);
      *reinterpret_cast<uint4*>(qs + g * R::QROW + c) = v;
    }
  }
  __syncthreads();
  // q as the B operand of S^T = K.q^T: per k-slice, b0 and b1 of heads 0-7,
  // then of heads 8-15.
  uint32_t qf[KS][4];
  {
    const bf16* qrow = qs + ((lane & 7) + 8 * (lane >> 4)) * R::QROW + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) repro::ldmatrix_x4(qf[ks], qrow + 16 * ks);
  }

  // This warp's keys 16 * warp .. + 15 of each tile: the row and column
  // block of this lane's ldmatrix address (K as the A operand; V, with
  // .trans, as the B operand of P.V), in a swizzled tile.
  const int lrow = 16 * warp + (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 8 * (lane >> 4);
  auto at = [&](int tile, int col) {
    const uint32_t off = lrow * R::ROW + (col % R::W) * 2;
    return base + tile + (col / R::W) * R::BOX + repro::swizzle(off, R::MASK);
  };
  // m and l of heads 8 nb + 2 quad + c (the scores' columns), l a partial
  // sum over this lane's keys; O rows are heads group and group + 8.
  float m[NB][2], l[NB][2], oacc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
    m[nb][0] = m[nb][1] = -INFINITY;
    l[nb][0] = l[nb][1] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j) oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int kt = (it % stages) * 2 * R::TILE, vt = kt + R::TILE;
    repro::mbar_wait(full(it), (it / stages) & 1);
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      repro::ldmatrix_x4(a, at(kt, 16 * ks + lcol));
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        repro::mma_bf16_16816(s[nb], a, qf[ks][2 * nb], qf[ks][2 * nb + 1]);
    }
    // Scale (and cap) into base-2 units; keys outside [vlo, vhi) are -inf.
    const int kp0 = t_first + it * kBK + 16 * warp + group, kp1 = kp0 + 8;
    const bool ok0 = kp0 >= vlo && kp0 < vhi, ok1 = kp1 >= vlo && kp1 < vhi;
    if (softcap > 0.f) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] = softcap * tanhf(s[nb][e] * scale / softcap);
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[nb][e] *= scale;
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = (e < 2 ? ok0 : ok1) ? s[nb][e] * kLog2e : -INFINITY;
    // Online softmax per head over this warp's keys (groups of lanes with
    // one quad share a head); p stays in s.
    float alpha[NB][2];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float mt = fmaxf(s[nb][c], s[nb][c + 2]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float mn = fmaxf(m[nb][c], mt);
        // A head that has seen no key keeps m = -inf; subtract 0 instead so
        // that exp2 gives 0, not NaN.
        const float ms = mn == -INFINITY ? 0.f : mn;
        alpha[nb][c] = exp2f(m[nb][c] - ms);
        m[nb][c] = mn;
        s[nb][c] = exp2f(s[nb][c] - ms);
        s[nb][c + 2] = exp2f(s[nb][c + 2] - ms);
        l[nb][c] = l[nb][c] * alpha[nb][c] + s[nb][c] + s[nb][c + 2];
      }
    }
    // Scale O's rows (heads group, group + 8) by their heads' factors, held
    // by the lane of quad group / 2.
    float r[2] = {1.f, 1.f};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const float a0 = __shfl_sync(0xffffffffu, alpha[nb][0], group >> 1);
      const float a1 = __shfl_sync(0xffffffffu, alpha[nb][1], group >> 1);
      r[nb] = (group & 1) ? a1 : a0;
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      oacc[j][0] *= r[0];
      oacc[j][1] *= r[0];
      oacc[j][2] *= r[1];
      oacc[j][3] *= r[1];
    }
    // P^T's fragments (keys by heads) transposed into P's A fragments (heads
    // by keys), as hi + lo: a0/a1 keys 0-7 of heads 0-7/8-15, a2/a3 keys 8-15.
    uint32_t ph[4] = {0u, 0u, 0u, 0u}, pl[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      uint32_t h0r, l0r, h1r, l1r;
      repro::split_bf16(s[nb][0], s[nb][1], h0r, l0r);
      repro::split_bf16(s[nb][2], s[nb][3], h1r, l1r);
      ph[nb] = repro::movmatrix_trans(h0r);
      pl[nb] = repro::movmatrix_trans(l0r);
      ph[2 + nb] = repro::movmatrix_trans(h1r);
      pl[2 + nb] = repro::movmatrix_trans(l1r);
    }
#pragma unroll
    for (int j = 0; j < KS; ++j) {
      uint32_t vb[4];
      repro::ldmatrix_x4_trans(vb, at(vt, 16 * j + lcol));
      repro::mma_bf16_16816(oacc[2 * j], ph, vb[0], vb[1]);
      repro::mma_bf16_16816(oacc[2 * j + 1], ph, vb[2], vb[3]);
      repro::mma_bf16_16816(oacc[2 * j], pl, vb[0], vb[1]);
      repro::mma_bf16_16816(oacc[2 * j + 1], pl, vb[2], vb[3]);
    }
    __syncthreads();  // every warp has read this stage
    if (tid == 0 && it + stages < n_tiles) issue(it + stages, t_first + (it + stages) * kBK);
  }
  // Each warp's state into the ring's first bytes (every read of the ring
  // is behind the loop's last barrier; a CTA with no tile issued no load).
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) l[nb][c] += __shfl_xor_sync(0xffffffffu, l[nb][c], off);
  {
    float* wacc = reinterpret_cast<float*>(base + R::WARP_ACC) + warp * kGroup * R::AROW;
    float* wm = reinterpret_cast<float*>(base + R::WARP_M) + warp * kGroup;
    float* wl = reinterpret_cast<float*>(base + R::WARP_L) + warp * kGroup;
    if (group == 0) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          wm[8 * nb + 2 * quad + c] = m[nb][c];
          wl[8 * nb + 2 * quad + c] = l[nb][c];
        }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(wacc + group * R::AROW + 8 * j + 2 * quad) =
          make_float2(oacc[j][0], oacc[j][1]);
      if (NB > 1)
        *reinterpret_cast<float2*>(wacc + (group + 8) * R::AROW + 8 * j + 2 * quad) =
            make_float2(oacc[j][2], oacc[j][3]);
    }
  }
  __syncthreads();
  // The warps' states merged into the CTA's (m, l, acc) per head.
  float* cacc = reinterpret_cast<float*>(base + R::CTA_ACC);
  float* cm = reinterpret_cast<float*>(base + R::CTA_M);
  float* cl = reinterpret_cast<float*>(base + R::CTA_L);
  {
    const float* wacc = reinterpret_cast<const float*>(base + R::WARP_ACC);
    const float* wm = reinterpret_cast<const float*>(base + R::WARP_M);
    const float* wl = reinterpret_cast<const float*>(base + R::WARP_L);
    for (int i = tid; i < nh * D; i += kThreads) {
      const int g = i / D, d = i % D;
      float mx = -INFINITY;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (wl[w * kGroup + g] > 0.f) mx = fmaxf(mx, wm[w * kGroup + g]);
      float den = 0.f, acc = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float lw = wl[w * kGroup + g];
        if (lw > 0.f) {
          const float a = exp2f(wm[w * kGroup + g] - mx);
          den += a * lw;
          acc += a * wacc[(w * kGroup + g) * R::AROW + d];
        }
      }
      cacc[g * D + d] = acc;
      if (d == 0) {
        cm[g] = mx;
        cl[g] = den;
      }
    }
  }

  // The cluster's merge: weights of the splits' states per head, then this
  // CTA's share of the (head, dim pair) outputs.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int n = static_cast<int>(cluster.num_blocks());
  float* wts = reinterpret_cast<float*>(base + R::WTS);  // [kGroup][kMaxCluster]
  for (int g = warp; g < nh; g += kWarps) {  // lane r reads split r's m and l
    float mr = -INFINITY, lr = 0.f;
    if (lane < n) {
      lr = cluster.map_shared_rank(cl, lane)[g];
      mr = cluster.map_shared_rank(cm, lane)[g];
    }
    float mx = lr > 0.f ? mr : -INFINITY;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float w = lr > 0.f ? exp2f(mr - mx) : 0.f;
    float den = w * lr;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    if (lane < n) wts[g * kMaxCluster + lane] = w / fmaxf(den, 1e-30f);
  }
  __syncthreads();
  const int pairs = nh * D / 2, per = (pairs + n - 1) / n;
  const int first = static_cast<int>(cluster.block_rank()) * per;
  for (int i = first + tid; i < min(pairs, first + per); i += kThreads) {
    const int g = 2 * i / D, d = 2 * i % D;
    float x = 0.f, y = 0.f;
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(cluster.map_shared_rank(cacc, r) + g * D + d);
      const float w = wts[g * kMaxCluster + r];
      x += w * v.x;
      y += w * v.y;
    }
    *reinterpret_cast<__nv_bfloat162*>(o + b * o_sb + static_cast<long long>(h0 + g) * D + d) =
        __floats2bfloat162_rn(x, y);
  }
  cluster.sync();  // no CTA leaves while another reads its state
}

// ---------------------------------------------------------------------------
// f32: two passes on the CUDA cores
// ---------------------------------------------------------------------------

template <typename T, int D>
struct Dec {
  static constexpr int V = repro::kVec16<T>;  // elements per 16-byte vector
  static constexpr int RS = D + V;            // padded row, elements
  // Keys a tile: half of kBK above D 128, whose two stages of 64 keys of K
  // and V would pass the SM's shared memory.
  static constexpr int BK = D <= 128 ? kBK : kBK / 2;
  static constexpr int TILE = BK * RS;
  // Output (head, dim pair) items a thread holds at most: kGroup heads.
  static constexpr int IPT = (kGroup * D / 2 + kThreads - 1) / kThreads;
  static_assert(D % V == 0 && D % 2 == 0, "D must split into 16-byte vectors");
  // Bytes of shared memory for nh heads: two stages of K and V, then the
  // f32 queries, scores, per-head m, l, alpha and the slice partials.
  static int smem_bytes(int nh) {
    return static_cast<int>(4 * TILE * sizeof(T) +
                            sizeof(float) * (nh * D + nh * BK + 3 * nh + 2 * kThreads));
  }
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int t0,
                                          int vlo, int vhi) {
  constexpr int V = Dec<T, D>::V, RS = Dec<T, D>::RS, PER_ROW = D / V;
  for (int i = threadIdx.x; i < Dec<T, D>::BK * PER_ROW; i += kThreads) {
    const int j = i / PER_ROW, c = (i % PER_ROW) * V;
    const int kp = t0 + j;
    const bool ok = kp >= vlo && kp < vhi;
    const T* s = ok ? src + static_cast<long long>(kp) * stride + c : src;
    repro::cp_async16(dst + j * RS + c, s, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, float* __restrict__ scratch, int t_len,
                    int n_heads, int g_heads, int n_hg, int n_splits, int split_len,
                    long long q_sb, long long k_sb, long long k_st, long long v_sb,
                    long long v_st, int window, float scale, float softcap) {
  constexpr int RS = Dec<T, D>::RS, TILE = Dec<T, D>::TILE, V = Dec<T, D>::V;
  constexpr int IPT = Dec<T, D>::IPT;
  constexpr int kBK = Dec<T, D>::BK;  // keys a tile of this kernel
  constexpr int DP = D / 2;  // dim pairs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [stage][kBK][RS]
  T* vs = ks + 2 * TILE;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int b = blockIdx.z;
  const int nh = min(kGroup, g_heads - hg * kGroup);  // heads of this CTA
  const int h0 = kvh * g_heads + hg * kGroup;         // its first query head
  float* qs = reinterpret_cast<float*>(vs + 2 * TILE);  // [nh][D]
  float* ss = qs + nh * D;                              // [nh][kBK] scores, then p
  float* m_s = ss + nh * kBK;
  float* l_s = m_s + nh;
  float* a_s = l_s + nh;
  float* red = a_s + nh;  // [2 * kThreads] slice partials

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), t_len);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int s0 = split * split_len;
  const int vlo = max(s0, lo), vhi = min(min(s0 + split_len, t_len), len);
  // Scratch row of (b, head h0 + g, split): m, l, acc[D].
  float* out = scratch + ((static_cast<long long>(b) * n_heads + h0) * n_splits + split) * (D + 2);
  const long long head_stride = static_cast<long long>(n_splits) * (D + 2);

  if (vlo >= vhi) {
    for (int g = tid; g < nh; g += kThreads) {
      out[g * head_stride] = kNeg;
      out[g * head_stride + 1] = 0.f;
    }
    return;
  }

  const T* kb = k + b * k_sb + static_cast<long long>(kvh) * D;
  const T* vb = v + b * v_sb + static_cast<long long>(kvh) * D;
  const int first = (vlo - s0) / kBK, last = (vhi - 1 - s0) / kBK;
  load_tile<T, D>(ks, kb, k_st, s0 + first * kBK, vlo, vhi);
  load_tile<T, D>(vs, vb, v_st, s0 + first * kBK, vlo, vhi);
  repro::cp_async_commit();

  const T* qb = q + b * q_sb + static_cast<long long>(h0) * D;
  for (int i = tid; i < nh * D; i += kThreads) qs[i] = to_f32(qb[i]);
  for (int g = tid; g < nh; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }

  // P.V work split: ni (head, dim pair) items; with fewer items than
  // threads, ns slices of the keys each take every ns-th key.
  const int ni = nh * DP;
  const int ns = ni >= kThreads ? 1 : kThreads / ni;
  const int slice = ns == 1 ? 0 : tid / ni;
  const int item0 = ns == 1 ? tid : tid % ni;
  const int step = ns == 1 ? kThreads : ni;
  float acc[IPT][2];
#pragma unroll
  for (int i = 0; i < IPT; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int it = first; it <= last; ++it) {
    const int t0 = s0 + it * kBK;
    const int st = (it - first) & 1;
    if (it < last) {
      load_tile<T, D>(ks + (st ^ 1) * TILE, kb, k_st, t0 + kBK, vlo, vhi);
      load_tile<T, D>(vs + (st ^ 1) * TILE, vb, v_st, t0 + kBK, vlo, vhi);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + st * TILE;
    const T* vt = vs + st * TILE;

    // Scores: thread per (head, key); a warp's lanes share the head.
    for (int p = tid; p < nh * kBK; p += kThreads) {
      const int g = p / kBK, j = p % kBK, kp = t0 + j;
      float s = kNeg;
      if (kp >= vlo && kp < vhi) {
        const float* qg = qs + g * D;
        const T* kr = kt + j * RS;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += V) {
          float f[V];
          repro::load_f32<T, V>(f, kr + c);
#pragma unroll
          for (int e = 0; e < V; ++e) dot += qg[c + e] * f[e];
        }
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      ss[p] = s;
    }
    __syncthreads();

    // Online softmax: warp per head. Every tile holds a visible key.
    for (int g = warp; g < nh; g += kWarps) {
      float sv[kBK / 32];
      float mt = kNeg;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const int j = lane + 32 * i, kp = t0 + j;
        sv[i] = ss[g * kBK + j];
        if (kp >= vlo && kp < vhi) mt = fmaxf(mt, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mo = m_s[g];
      const float mn = fmaxf(mo, mt);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const int j = lane + 32 * i, kp = t0 + j;
        const float p = kp >= vlo && kp < vhi ? expf(sv[i] - mn) : 0.f;
        ss[g * kBK + j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float alpha = expf(mo - mn);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = mn;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V over this thread's items and key slice.
    if (slice < ns) {
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
        const int item = item0 + i * step;
        if (item < ni) {
          const int g = item / DP, d = (item % DP) * 2;
          const float alpha = a_s[g];
          float x = acc[i][0] * alpha, y = acc[i][1] * alpha;
          const float* pg = ss + g * kBK;
          const T* vc = vt + d;
          for (int j = slice; j < kBK; j += ns) {
            const float p = pg[j];
            x += p * to_f32(vc[j * RS]);
            y += p * to_f32(vc[j * RS + 1]);
          }
          acc[i][0] = x;
          acc[i][1] = y;
        }
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }

  // Write m, l and the slices' summed acc.
  for (int g = tid; g < nh; g += kThreads) {
    out[g * head_stride] = m_s[g];
    out[g * head_stride + 1] = l_s[g];
  }
  if (ns == 1) {
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int item = item0 + i * step;
      if (item < ni) {
        const int g = item / DP, d = (item % DP) * 2;
        out[g * head_stride + 2 + d] = acc[i][0];
        out[g * head_stride + 3 + d] = acc[i][1];
      }
    }
  } else {
    if (slice < ns) {
      red[2 * tid] = acc[0][0];
      red[2 * tid + 1] = acc[0][1];
    }
    __syncthreads();
    // red[2 * (s * ni + item) + e] holds slice s of dim 2 * (item % DP) + e.
    for (int o = tid; o < 2 * ni; o += kThreads) {
      float x = 0.f;
      for (int sl = 0; sl < ns; ++sl) x += red[2 * sl * ni + o];
      const int g = o / D, d = o % D;
      out[g * head_stride + 2 + d] = x;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ scratch, T* __restrict__ o, int rows,
                      int n_heads, int n_splits, long long o_sb) {
  constexpr int DL = (D + 31) / 32;  // dims per lane (the last may be partial)
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * n_heads + h
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* base = scratch + static_cast<long long>(row) * n_splits * (D + 2);
  float mx = kNeg;
  for (int s = 0; s < n_splits; ++s)
    if (base[s * (D + 2) + 1] > 0.f) mx = fmaxf(mx, base[s * (D + 2)]);
  float den = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* st = base + s * (D + 2);
    const float l = st[1];
    if (l > 0.f) {
      const float w = expf(st[0] - mx);
      den += w * l;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        if (D % 32 == 0 || lane + 32 * i < D) acc[i] += w * st[2 + lane + 32 * i];
    }
  }
  const float r = 1.f / fmaxf(den, 1e-30f);
  const int b = row / n_heads, h = row % n_heads;
  T* op = o + b * o_sb + static_cast<long long>(h) * D + lane;
#pragma unroll
  for (int i = 0; i < DL; ++i)
    if (D % 32 == 0 || lane + 32 * i < D) op[32 * i] = repro::from_f32<T>(acc[i] * r);
}

struct Args {
  const void *q, *k, *v, *lengths;
  void *o, *scratch;
  int b, kv, g, t, n_splits, split_len;
  long long st[6];  // q_b, k_b, k_t, v_b, v_t, o_b
  int window;
  float scale, softcap;
};

int head_groups(int g) { return (g + kGroup - 1) / kGroup; }

template <int D>
int launch_f32(const Args& a, cudaStream_t stream) {
  const int n_hg = head_groups(a.g);
  const int smem = Dec<float, D>::smem_bytes(min(a.g, kGroup));
  static int configured = 0;  // bytes the attribute was last raised to
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const int h = a.kv * a.g;
  const dim3 grid1(a.n_splits, a.kv * n_hg, a.b);
  decode_split_kernel<float, D><<<grid1, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const int*>(a.lengths),
      static_cast<float*>(a.scratch), a.t, h, a.g, n_hg, a.n_splits, a.split_len, a.st[0],
      a.st[1], a.st[2], a.st[3], a.st[4], a.window, a.scale, a.softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = a.b * h;
  decode_combine_kernel<float, D><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const float*>(a.scratch), static_cast<float*>(a.o), rows, h, a.n_splits,
      a.st[5]);
  return static_cast<int>(cudaGetLastError());
}

// A 4-D map (D, heads, T, B) over a bf16 cache whose heads lie D apart,
// boxes of (W, 1, 64, 1) with the swizzle of Ring<D> (none for D 80).
template <int D>
bool encode(CUtensorMap* map, const void* ptr, int heads, int rows, int batch,
            long long row_stride, long long batch_stride) {
  using R = Ring<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(row_stride) * 2,
                                 static_cast<cuuint64_t>(batch_stride) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(R::W), 1u, static_cast<cuuint32_t>(kBK), 1u};
  return repro::encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, ptr, dims, strides, box,
                           R::MASK ? 2 * R::W : 0);
}

template <int D, int NB>
int launch_cluster(const Args& a, cudaStream_t stream) {
  const int stages = min(Ring<D>::MAX_STAGES, max(2, a.split_len / kBK));
  const int smem = Ring<D>::smem(stages);
  const auto kernel = decode_cluster_kernel<D, NB>;
  static int configured = 0;  // bytes the attribute was last raised to
  if (smem > configured) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  if (repro::tensor_map_encoder() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  if ((a.st[0] | a.st[1] | a.st[2] | a.st[3] | a.st[4] | a.st[5]) % 8 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);  // TMA: strides of 16 bytes
  CUtensorMap km, vm;
  if (!encode<D>(&km, a.k, a.kv, a.t, a.b, a.st[2], a.st[1]) ||
      !encode<D>(&vm, a.v, a.kv, a.t, a.b, a.st[4], a.st[3]))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_hg = head_groups(a.g);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_splits, a.kv * n_hg, a.b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, km, vm, static_cast<const bf16*>(a.q), static_cast<const int*>(a.lengths),
      static_cast<bf16*>(a.o), a.t, a.g, n_hg, a.split_len, stages, a.st[0], a.st[5], a.window,
      a.scale, a.softcap);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool BF16>
int launch(const Args& a, int d, cudaStream_t stream) {
  if (a.b <= 0 || a.kv <= 0 || a.g <= 0 || a.t <= 0 || a.b > 65535 || a.n_splits <= 0 ||
      a.split_len <= 0 || a.split_len % kBK != 0 ||
      static_cast<long long>(a.n_splits) * a.split_len < a.t ||
      static_cast<long long>(a.kv) * head_groups(a.g) > 65535 ||
      (BF16 && a.n_splits > kMaxCluster))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!repro::aligned16(a.q) || !repro::aligned16(a.k) || !repro::aligned16(a.v) ||
      !repro::aligned16(a.o))
    return static_cast<int>(cudaErrorMisalignedAddress);
#define REPRO_CASE(D)                                                                      \
  case D:                                                                                  \
    return !BF16 ? launch_f32<D>(a, stream)                                                \
                 : a.g <= 8 ? launch_cluster<D, 1>(a, stream) : launch_cluster<D, 2>(a, stream);
  switch (d) {
    REPRO_CASE(32)
    REPRO_CASE(64)
    REPRO_CASE(80)
    REPRO_CASE(96)
    REPRO_CASE(128)
    REPRO_CASE(224)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_CASE
}

}  // namespace

// q (B,1,H,D) and o (B,1,H,D) with heads contiguous, k/v (B,T,K,D) with unit
// stride over D and heads D apart, lengths (B,) int32; strides (in
// elements) in the order q_b, k_b, k_t, v_b, v_t, o_b. The f32 entry also
// takes a scratch (B,H,splits,D+2) f32 contiguous; the bf16 entry ignores
// it, takes at most 16 splits and strides of whole 16 bytes (for TMA).
#define REPRO_DECODE_ENTRY(NAME, BF16)                                                      \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* lengths,     \
                      void* o, void* scratch, int b, int kv, int g, int t, int d,           \
                      int n_splits, int split_len, long long q_sb, long long k_sb,          \
                      long long k_st, long long v_sb, long long v_st, long long o_sb,       \
                      int window, float scale, float softcap, void* stream) {               \
    const Args a{q, k, v, lengths, o, scratch, b, kv, g, t, n_splits, split_len,            \
                 {q_sb, k_sb, k_st, v_sb, v_st, o_sb}, window, scale, softcap};             \
    return launch<BF16>(a, d, static_cast<cudaStream_t>(stream));                           \
  }

REPRO_DECODE_ENTRY(repro_decode_attention_f32, false)
REPRO_DECODE_ENTRY(repro_decode_attention_bf16, true)
