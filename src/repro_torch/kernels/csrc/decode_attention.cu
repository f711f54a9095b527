// Flash decode: one query token for each head of a grouped-query group
// against a length-masked KV cache, online softmax in f32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_bkgd (_decode_kernel). That kernel takes q (BK,G,D) and
// k/v (BK,T,D), so its JAX wrapper (kernels/ops.py:flash_decode) transposes
// the whole KV cache on every decode step; it also needs T to be a multiple
// of its block, and gets the lengths by scalar prefetch.
//
// Here: q (B,1,H,D) and the cache k/v (B,T,K,D) are read where they lie. One
// CTA owns one (b, kv head) and runs one warp per query head of the group
// (G = H/K warps), so the K and V tiles it stages in shared memory serve all
// G heads. The CTA reads lengths[b] itself, stops at it (any T works), and
// writes zeros when it is 0, as the TPU kernel does.
//
// Bound on the H100: bytes. Each step reads lengths[b] * D * 2 elements of
// the cache per (b, kv head) and does 4 * G flops per cache element, about
// 16 flops a byte at G = 8 in bf16, far below the ridge point. With one CTA
// per (b, kv head) a decode batch of 4 with 4 KV heads fills 16 of the 132
// SMs, so this version is bound by the read rate one SM reaches, not by the
// card's; splitting the keys over CTAs with a combine pass is the next step.
#include "common.cuh"

namespace {

using repro::kNeg;
using repro::to_f32;

template <int D>
struct Tile {
  static constexpr int BK = D <= 64 ? 64 : 32;  // keys per tile
  static constexpr int KS = D + 1;              // padded K row: lanes hit distinct banks
  static constexpr int DL = (D + 31) / 32;      // output dims per lane (the last may be partial)
  static int smem_bytes(int g) {
    return static_cast<int>(sizeof(float)) * (BK * D + BK * KS + g * D + g * BK);
  }
};

template <typename T, int D>
__global__ void decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                                        const T* __restrict__ v,
                                        const int* __restrict__ lengths, T* __restrict__ o,
                                        int t_len, int g_heads, long long q_sb, long long k_sb,
                                        long long k_st, long long v_sb, long long v_st,
                                        long long o_sb, float scale) {
  constexpr int BK = Tile<D>::BK, KS = Tile<D>::KS, DL = Tile<D>::DL;
  constexpr int V = repro::kVec16<T>;
  constexpr int PER_ROW = D / V;
  extern __shared__ __align__(16) float smem[];
  float* vs = smem;           // [BK][D]
  float* ks = vs + BK * D;    // [BK][KS]
  float* qs = ks + BK * KS;    // [G][D]
  float* ps = qs + g_heads * D;  // [G][BK]

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int len = min(max(lengths[b], 0), t_len);

  const T* qb = q + b * q_sb + static_cast<long long>(kvh) * g_heads * D;
  for (int i = threadIdx.x; i < g_heads * D; i += blockDim.x) qs[i] = to_f32(qb[i]);
  const T* kb = k + b * k_sb + static_cast<long long>(kvh) * D;
  const T* vb = v + b * v_sb + static_cast<long long>(kvh) * D;

  float m = kNeg, l = 0.f;
  float acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int t0 = 0; t0 < len; t0 += BK) {
    __syncthreads();  // qs written / the previous tile no longer read
    for (int i = threadIdx.x; i < BK * PER_ROW; i += blockDim.x) {
      const int j = i / PER_ROW;
      const int c = (i % PER_ROW) * V;
      float fk[V], fv[V];
      if (t0 + j < len) {
        repro::load_f32<T, V>(fk, kb + static_cast<long long>(t0 + j) * k_st + c);
        repro::load_f32<T, V>(fv, vb + static_cast<long long>(t0 + j) * v_st + c);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; ++e) {
        ks[j * KS + c + e] = fk[e];
        vs[j * D + c + e] = fv[e];
      }
    }
    __syncthreads();

    // Scores of this warp's head against keys lane, lane + 32, ...
    const float* qg = qs + g * D;
    float sc[BK / 32];
    float mt = kNeg;
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) {
      const int j = lane + 32 * i;
      const float* kr = ks + j * KS;
      float dot = 0.f;
#pragma unroll 16
      for (int c = 0; c < D; ++c) dot += qg[c] * kr[c];
      sc[i] = dot * scale;
      if (t0 + j < len) mt = fmaxf(mt, sc[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
    // Key t0 < len is in this tile, so mt is a real score.
    const float mn = fmaxf(m, mt);
    const float alpha = expf(m - mn);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) {
      const int j = lane + 32 * i;
      const float p = t0 + j < len ? expf(sc[i] - mn) : 0.f;
      ps[g * BK + j] = p;
      psum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    __syncwarp();
    const int jn = min(BK, len - t0);
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
    for (int j = 0; j < jn; ++j) {
      const float p = ps[g * BK + j];
      const float* vr = vs + j * D + lane;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        if (D % 32 == 0 || lane + 32 * i < D) acc[i] += p * vr[32 * i];
    }
    m = mn;
  }

  const float denom = fmaxf(l, 1e-30f);
  T* op = o + b * o_sb + (static_cast<long long>(kvh) * g_heads + g) * D + lane;
#pragma unroll
  for (int i = 0; i < DL; ++i)
    if (D % 32 == 0 || lane + 32 * i < D) op[32 * i] = repro::from_f32<T>(acc[i] / denom);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* lengths, void* o, int b,
             int kv, int g, int t, const long long* st, float scale, cudaStream_t stream) {
  const int smem = Tile<D>::smem_bytes(g);
  static int configured = 0;  // bytes the attribute was last raised to
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const dim3 grid(kv, b), block(32 * g);
  decode_attention_kernel<T, D><<<grid, block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(o), t, g, st[0], st[1], st[2], st[3],
      st[4], st[5], scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* lengths, void* o, int b,
           int kv, int g, int t, int d, const long long* st, float scale, cudaStream_t stream) {
  if (b <= 0 || kv <= 0 || g <= 0 || g > 32 || t <= 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!repro::aligned16(k) || !repro::aligned16(v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (d) {
    case 32: return launch_d<T, 32>(q, k, v, lengths, o, b, kv, g, t, st, scale, stream);
    case 64: return launch_d<T, 64>(q, k, v, lengths, o, b, kv, g, t, st, scale, stream);
    case 80: return launch_d<T, 80>(q, k, v, lengths, o, b, kv, g, t, st, scale, stream);
    case 128: return launch_d<T, 128>(q, k, v, lengths, o, b, kv, g, t, st, scale, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,1,H,D) and o (B,1,H,D) with heads contiguous, k/v (B,T,K,D) with unit
// stride over D and heads D apart, lengths (B,) int32; strides (in elements)
// in the order q_b, k_b, k_t, v_b, v_t, o_b.
#define REPRO_DECODE_ENTRY(NAME, T)                                                        \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* lengths,    \
                      void* o, int b, int kv, int g, int t, int d, long long q_sb,         \
                      long long k_sb, long long k_st, long long v_sb, long long v_st,      \
                      long long o_sb, float scale, void* stream) {                         \
    const long long st[6] = {q_sb, k_sb, k_st, v_sb, v_st, o_sb};                          \
    return launch<T>(q, k, v, lengths, o, b, kv, g, t, d, st, scale,                       \
                     static_cast<cudaStream_t>(stream));                                   \
  }

REPRO_DECODE_ENTRY(repro_decode_attention_f32, float)
REPRO_DECODE_ENTRY(repro_decode_attention_bf16, __nv_bfloat16)
