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
// owns one (b, h, tile of 64 queries) and loops over KV tiles inside the
// block (CUDA grids run in no order, so the sequential KV axis of the TPU
// grid becomes this loop). Query i sits at position i + q_offset. A KV tile
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
// bf16 (the served type): both products run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), FA2-style. Each of the 4
// warps owns 16 query rows and keeps its Q fragments in registers as the A
// operand for the whole KV loop. K and V tiles of 64 keys stay bf16 in
// shared memory, in a two-stage ring filled by cp.async while the previous
// tile is computed; rows are padded by 16 bytes so the 8 row addresses of
// each ldmatrix fall in distinct banks. S = Q.K^T takes K through ldmatrix;
// the online softmax (running m, l per row, base-2 exponent) runs on the
// accumulator fragments; P stays in registers as the A operand of P.V, with
// V through ldmatrix.trans, carried as two bf16 terms (hi = bf16(p), lo =
// bf16(p - hi)) through two products, so P keeps about 16 bits; l is summed
// from the f32 p. (P rounded once to bf16, as the reference model rounds
// its probabilities, moved tinyllama-1.1b's bf16 decode-against-prefill
// logits gap at full depth on an H100 from 0.083 to 0.104, past its 0.1
// limit; the second product doubles the mma of P.V.) The G query heads of
// one KV head run in G CTAs, which read the same K/V tiles (the second and
// later reads come from L2).
//
// f32: the tolerance (2e-5) rules out TF32 and bf16 products, so the f32
// kernel computes on the CUDA cores: TPR threads share a query row (TPR the
// least power of two that leaves at most 40 dims a thread), each keeping its
// dims of q and of the running acc in registers, and K/V tiles of 32 keys
// are staged as f32 with a padded layout.
#include "common.cuh"
#include "mma.cuh"

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
// bf16: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kBQ = 16 * kWarps;  // queries per CTA, 16 per warp
constexpr int kBK = 64;           // keys per KV tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Bf16Tile {
  static constexpr int RS = D + 8;  // padded row, elements (16-byte aligned)
  static constexpr int TILE = kBK * RS;
  static constexpr int SMEM = (kBQ * RS + 4 * TILE) * 2;  // Q + two stages of K and V
  static_assert(D % 16 == 0, "D must be a multiple of 16");
};

// Issue cp.async for rows r0 .. r0 + ROWS - 1 of a (rows, D) bf16 matrix
// with row stride ``stride`` into dst[ROWS][RS]; rows at or past ``n`` are
// zeroed.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int r0, int n) {
  constexpr int RS = Bf16Tile<D>::RS, PER_ROW = D / 8;
  for (int i = threadIdx.x; i < ROWS * PER_ROW; i += kWarps * 32) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * 8;
    const bool ok = r0 + r < n;
    const __nv_bfloat16* s = ok ? src + static_cast<long long>(r0 + r) * stride + c : src;
    repro::cp_async16(dst + r * RS + c, s, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_attention_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                            int s_len, int t_len, int n_heads, int n_kv, long long q_sb,
                            long long q_ss, long long k_sb, long long k_st, long long v_sb,
                            long long v_st, long long o_sb, long long o_ss, int causal,
                            int window, int q_offset, float scale, float softcap) {
  constexpr int RS = Bf16Tile<D>::RS, TILE = Bf16Tile<D>::TILE;
  constexpr int KD = D / 16;   // k-steps of Q.K^T
  constexpr int NB = kBK / 8;  // 8-key column blocks of S
  constexpr int ND = D / 8;    // 8-dim column blocks of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kBQ * RS;  // [stage][kBK][RS]
  __nv_bfloat16* vs = ks + 2 * TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, quad = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int kvh = h / (n_heads / n_kv);
  const __nv_bfloat16* qb = q + b * q_sb + static_cast<long long>(q0) * q_ss +
                            static_cast<long long>(h) * D;
  const __nv_bfloat16* kb = k + b * k_sb + static_cast<long long>(kvh) * D;
  const __nv_bfloat16* vb = v + b * v_sb + static_cast<long long>(kvh) * D;

  int lo, hi;
  kv_range(q0, kBQ, t_len, causal, window, q_offset, lo, hi);
  const int t_first = (lo / kBK) * kBK;
  const int n_tiles = hi > t_first ? (hi - t_first + kBK - 1) / kBK : 0;

  // The two query rows of this lane's accumulator fragments.
  const int row0 = warp * 16 + group;
  const int pos0 = q0 + row0 + q_offset, pos1 = pos0 + 8;

  uint32_t qf[KD][4];
  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if (n_tiles > 0) {
    load_rows<D, kBQ>(qs, qb, q_ss, 0, s_len - q0);
    load_rows<D, kBK>(ks, kb, k_st, t_first, t_len);
    load_rows<D, kBK>(vs, vb, v_st, t_first, t_len);
    repro::cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_first + it * kBK;
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      const int nx = (it + 1) & 1;
      load_rows<D, kBK>(ks + nx * TILE, kb, k_st, t0 + kBK, t_len);
      load_rows<D, kBK>(vs + nx * TILE, vb, v_st, t0 + kBK, t_len);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
      // Q fragments: tiles (rows 0-7 | 8-15) x (cols 0-7 | 8-15) of this warp.
      const __nv_bfloat16* qrow =
          qs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 8 * (lane >> 4);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) repro::ldmatrix_x4(qf[kk], qrow + kk * 16);
    }
    const __nv_bfloat16* kt = ks + st * TILE;
    const __nv_bfloat16* vt = vs + st * TILE;

    // S = Q.K^T for this warp's 16 rows and the tile's 64 keys.
    float sacc[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n) sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
    const __nv_bfloat16* krow = kt + ((lane & 7) + 8 * (lane >> 4)) * RS + 8 * ((lane >> 3) & 1);
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int n2 = 0; n2 < NB / 2; ++n2) {
        uint32_t kf[4];
        repro::ldmatrix_x4(kf, krow + n2 * 16 * RS + kk * 16);
        repro::mma_bf16_16816(sacc[2 * n2], qf[kk], kf[0], kf[1]);
        repro::mma_bf16_16816(sacc[2 * n2 + 1], qf[kk], kf[2], kf[3]);
      }
    }

    // Scale and cap, in base-2 units; mask where the tile crosses the
    // diagonal, the window's edge or T.
    const bool edge = t0 + kBK > t_len || (causal && t0 + kBK - 1 > q0 + q_offset) ||
                      (window > 0 && t0 <= q0 + kBQ - 1 + q_offset - window);
    float mt0 = -INFINITY, mt1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float s = cap(sacc[n][e] * scale, softcap) * kLog2e;
        if (edge) {
          const int kp = t0 + n * 8 + 2 * quad + (e & 1);
          const int qp = e < 2 ? pos0 : pos1;
          const bool ok = kp < t_len && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
          if (!ok) s = -INFINITY;
        }
        sacc[n][e] = s;
      }
      mt0 = fmaxf(mt0, fmaxf(sacc[n][0], sacc[n][1]));
      mt1 = fmaxf(mt1, fmaxf(sacc[n][2], sacc[n][3]));
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
    const float a0 = exp2f(m0 - ms0), a1 = exp2f(m1 - ms1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= a0;
      oacc[n][1] *= a0;
      oacc[n][2] *= a1;
      oacc[n][3] *= a1;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      sacc[n][0] = exp2f(sacc[n][0] - ms0);
      sacc[n][1] = exp2f(sacc[n][1] - ms0);
      sacc[n][2] = exp2f(sacc[n][2] - ms1);
      sacc[n][3] = exp2f(sacc[n][3] - ms1);
      l0 += sacc[n][0] + sacc[n][1];
      l1 += sacc[n][2] + sacc[n][3];
    }

    // O += P.V: P (16 x 16 keys) from two adjacent S blocks, as two bf16
    // terms (hi + lo) through two products on the same V fragments.
    const __nv_bfloat16* vrow = vt + ((lane & 7) + 8 * ((lane >> 3) & 1)) * RS + 8 * (lane >> 4);
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      uint32_t ph[4], pl[4];
      repro::split_bf16(sacc[2 * j][0], sacc[2 * j][1], ph[0], pl[0]);
      repro::split_bf16(sacc[2 * j][2], sacc[2 * j][3], ph[1], pl[1]);
      repro::split_bf16(sacc[2 * j + 1][0], sacc[2 * j + 1][1], ph[2], pl[2]);
      repro::split_bf16(sacc[2 * j + 1][2], sacc[2 * j + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int d2 = 0; d2 < D / 16; ++d2) {
        uint32_t vf[4];
        repro::ldmatrix_x4_trans(vf, vrow + j * 16 * RS + d2 * 16);
        repro::mma_bf16_16816(oacc[2 * d2], ph, vf[0], vf[1]);
        repro::mma_bf16_16816(oacc[2 * d2 + 1], ph, vf[2], vf[3]);
        repro::mma_bf16_16816(oacc[2 * d2], pl, vf[0], vf[1]);
        repro::mma_bf16_16816(oacc[2 * d2 + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float r0 = 1.f / fmaxf(l0, 1e-30f), r1 = 1.f / fmaxf(l1, 1e-30f);
  const int qa = q0 + row0, qb2 = qa + 8;
  __nv_bfloat16* oa = o + b * o_sb + static_cast<long long>(qa) * o_ss +
                      static_cast<long long>(h) * D + 2 * quad;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    if (qa < s_len)
      *reinterpret_cast<__nv_bfloat162*>(oa + n * 8) =
          __floats2bfloat162_rn(oacc[n][0] * r0, oacc[n][1] * r0);
    if (qb2 < s_len)
      *reinterpret_cast<__nv_bfloat162*>(oa + 8 * o_ss + n * 8) =
          __floats2bfloat162_rn(oacc[n][2] * r1, oacc[n][3] * r1);
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

template <int D>
int launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr int smem = Bf16Tile<D>::SMEM;
  static bool configured = false;
  if (smem > 48 * 1024 && !configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = true;
  }
  const dim3 grid((a.s + kBQ - 1) / kBQ, a.h, a.b), block(kWarps * 32);
  flash_attention_bf16_kernel<D><<<grid, block, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<__nv_bfloat16*>(a.o), a.s, a.t, a.h,
      a.kv, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.st[5], a.st[6], a.st[7], a.causal,
      a.window, a.q_offset, a.scale, a.softcap);
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
      a.h > 65535)
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
