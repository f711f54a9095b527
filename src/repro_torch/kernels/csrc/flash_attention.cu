// Causal and/or sliding-window flash attention (prefill), online softmax in
// f32, grouped-query heads read in place.
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
// owns one (b, h, 64-query tile) and loops over KV tiles of 32 keys inside
// the block (CUDA grids run in no order, so the sequential KV axis of the TPU
// grid becomes this loop). A tile wholly above the diagonal or before the
// window of the CTA's queries is never loaded; keys past T and queries past S
// are masked, so any S and T work. A query row with no visible key gives 0.
//
// Bound on the H100: at the serve shape (S = T = 512, D = 64, causal) bytes
// and operations are close, 5.6 us to move q, k, v and out once against
// 4.4 us for the 4*S*T*D/2 flops per head at the bf16 tensor-core rate; the
// operations grow as S*T and take over for longer prompts. This first
// version computes on the f32 CUDA cores: TPR threads share a query row
// (TPR the least power of two that leaves at most 40 dims a thread: 32 dims
// each at D = 32, 64 and 128, 40 at D = 80), each keeping its dims of q and
// of the running acc in registers, and the K and V tiles are staged in
// shared memory as f32 with a padded layout so the threads of a row read
// distinct banks. It is therefore far from either bound; mma/wgmma tiles are
// later work.
#include "common.cuh"

namespace {

using repro::kNeg;
using repro::to_f32;

constexpr int kBQ = 64;  // queries per CTA
constexpr int kBK = 32;  // keys per KV tile

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
  static_assert(D % TPR == 0 && DP % 8 == 0, "D must split into 16-byte vectors");
};

// Stage rows t0..t0+kBK-1 of one KV head as f32 into dst[key][part][PS];
// rows at or past tk are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst, const T* __restrict__ base,
                                          long long stride_t, int t0, int tk) {
  constexpr int V = repro::kVec16<T>;
  constexpr int PER_ROW = D / V;
  constexpr int kDP = Split<D>::DP, kPS = Split<D>::PS;
  constexpr int RS = Split<D>::TPR * kPS;
  for (int i = threadIdx.x; i < kBK * PER_ROW; i += blockDim.x) {
    const int j = i / PER_ROW;
    const int c = (i % PER_ROW) * V;
    float f[V];
    if (t0 + j < tk) {
      repro::load_f32<T, V>(f, base + static_cast<long long>(t0 + j) * stride_t + c);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) f[e] = 0.f;
    }
    float* d = dst + j * RS + (c / kDP) * kPS + (c % kDP);
#pragma unroll
    for (int e = 0; e < V; ++e) d[e] = f[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBQ * Split<D>::TPR)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int s_len, int t_len,
                       int n_heads, int n_kv, long long q_sb, long long q_ss, long long k_sb,
                       long long k_st, long long v_sb, long long v_st, long long o_sb,
                       long long o_ss, int causal, int window, float scale) {
  constexpr int TPR = Split<D>::TPR;  // threads per query row
  constexpr int kDP = Split<D>::DP, kPS = Split<D>::PS;
  constexpr int RS = TPR * kPS;
  __shared__ __align__(16) float ks[kBK * RS];
  __shared__ __align__(16) float vs[kBK * RS];

  const int row = threadIdx.x / TPR;
  const int part = threadIdx.x % TPR;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int qpos = q0 + row;
  const int kvh = h / (n_heads / n_kv);

  float qr[kDP];
  if (qpos < s_len) {
    const T* qp = q + b * q_sb + qpos * q_ss + static_cast<long long>(h) * D + part * kDP;
#pragma unroll
    for (int c = 0; c < kDP; c += repro::kVec16<T>) {
      float f[repro::kVec16<T>];
      repro::load_f32<T, repro::kVec16<T>>(f, qp + c);
#pragma unroll
      for (int e = 0; e < repro::kVec16<T>; ++e) qr[c + e] = f[e];
    }
  } else {
#pragma unroll
    for (int c = 0; c < kDP; ++c) qr[c] = 0.f;
  }

  float m = kNeg, l = 0.f;
  float acc[kDP];
#pragma unroll
  for (int c = 0; c < kDP; ++c) acc[c] = 0.f;

  // KV range any query of this tile can see.
  int lo = 0, hi = t_len;
  if (causal) hi = min(t_len, q0 + kBQ);
  if (window > 0) lo = max(0, q0 - window + 1);
  const T* kb = k + b * k_sb + static_cast<long long>(kvh) * D;
  const T* vb = v + b * v_sb + static_cast<long long>(kvh) * D;

  for (int t0 = (lo / kBK) * kBK; t0 < hi; t0 += kBK) {
    __syncthreads();  // the previous tile is no longer read
    load_tile<T, D>(ks, kb, k_st, t0, t_len);
    load_tile<T, D>(vs, vb, v_st, t0, t_len);
    __syncthreads();

    float sc[kBK];
    unsigned valid = 0u;
    float mt = kNeg;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float* kr = ks + j * RS + part * kPS;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < kDP; c += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(kr + c);
        dot += qr[c] * kv.x + qr[c + 1] * kv.y + qr[c + 2] * kv.z + qr[c + 3] * kv.w;
      }
#pragma unroll
      for (int off = 1; off < TPR; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      sc[j] = dot * scale;
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
      for (int j = 0; j < kBK; ++j) {
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

  if (qpos < s_len) {
    const float denom = fmaxf(l, 1e-30f);
    T* op = o + b * o_sb + qpos * o_ss + static_cast<long long>(h) * D + part * kDP;
    constexpr int V = repro::kVec16<T>;
#pragma unroll
    for (int c = 0; c < kDP; c += V) {
      repro::Vec<T, V> out;
#pragma unroll
      for (int e = 0; e < V; ++e) out.v[e] = repro::from_f32<T>(acc[c + e] / denom);
      *reinterpret_cast<repro::Vec<T, V>*>(op + c) = out;
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int b, int s, int t, int h,
             int kv, const long long* st, int causal, int window, float scale,
             cudaStream_t stream) {
  const dim3 grid((s + kBQ - 1) / kBQ, h, b), block(kBQ * Split<D>::TPR);
  flash_attention_kernel<T, D><<<grid, block, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, t, h, kv, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, int s, int t, int h,
           int kv, int d, const long long* st, int causal, int window, float scale,
           cudaStream_t stream) {
  if (b <= 0 || s <= 0 || t <= 0 || kv <= 0 || h % kv != 0 || b > 65535 || h > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!repro::aligned16(q) || !repro::aligned16(k) || !repro::aligned16(v) || !repro::aligned16(o))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (d) {
    case 32: return launch_d<T, 32>(q, k, v, o, b, s, t, h, kv, st, causal, window, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, o, b, s, t, h, kv, st, causal, window, scale, stream);
    case 80: return launch_d<T, 80>(q, k, v, o, b, s, t, h, kv, st, causal, window, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, o, b, s, t, h, kv, st, causal, window, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,S,H,D), k/v (B,T,K,D), o (B,S,H,D): unit stride over D, heads D apart;
// strides (in elements) in the order q_b, q_s, k_b, k_t, v_b, v_t, o_b, o_s.
#define REPRO_FLASH_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o, int b, int s,  \
                      int t, int h, int kv, int d, long long q_sb, long long q_ss,         \
                      long long k_sb, long long k_st, long long v_sb, long long v_st,      \
                      long long o_sb, long long o_ss, int causal, int window, float scale, \
                      void* stream) {                                                      \
    const long long st[8] = {q_sb, q_ss, k_sb, k_st, v_sb, v_st, o_sb, o_ss};              \
    return launch<T>(q, k, v, o, b, s, t, h, kv, d, st, causal, window, scale,             \
                     static_cast<cudaStream_t>(stream));                                   \
  }

REPRO_FLASH_ENTRY(repro_flash_attention_f32, float)
REPRO_FLASH_ENTRY(repro_flash_attention_bf16, __nv_bfloat16)
