// Mamba-2 decode step: one token's state update and readout, the state
// updated in place.
//
// For each batch row b and head h (state N x P, P contiguous), with x (P),
// dt and A scalars and the head's group's B and C (N), group h / (H / G):
//
//     h'[n, p] = exp(dt A) h[n, p] + (dt x[p]) B[n]
//     y[p]     = sum_n C[n] h'[n, p]
//
// in f32, y read from the f32 h' (not from the rounded state), h' written
// back over h and y written out, each rounded once to the state's dtype
// (bf16 or f32, the activations' too).
//
// Replaces no Pallas kernel: the TPU model runs this step as plain XLA
// operations. It was added because, in plain PyTorch on the H100, the step
// took four kernels a Mamba layer (the decay's multiply-add, the outer
// product dt B x^T and the readout, each over an f32 (B,H,N,P) tensor, and
// the store of the f32 state into the cache), about 0.7 GB of traffic a
// layer at Zamba2-7B's batch of 64, where one read and one write of the bf16
// state are 117 MB: those four led the device time of a served decode step.
//
// Bound on the H100: bytes. Each state element takes 4 flops against 4
// bytes moved (bf16 in and out), two orders of magnitude below the ridge
// point, so the kernel is as fast as it reads the state once and writes it
// once. Design: a tile is one (b, h) pair's N x P state, held by W warps of
// a 128-thread CTA (W = 1 to 4, chosen from N, P and the state's dtype so
// that each thread holds R = 16 vectors of 16 bytes, or the whole tile
// where one warp holds it in fewer: 4 tiles a CTA at bf16 N 64, Zamba2-7B's).
// P is 64 and N 64 or 128 in every published family; their small test
// variants take P 32 and N 16 or 32. A thread issues all R loads of its
// tile (streaming, as the state is not read again this step) before it
// uses any, while the CTA
// stages its tiles' B and C rows in shared memory, loaded once for the
// tile; then it forms h' in registers, stores each vector back where it
// read it and sums its part of y. The sum over N runs over the warp by
// shuffles and across a tile's warps through shared memory. x, B and C are
// read by their strides (views into the conv output, which need no copy);
// the CTA's tiles are consecutive heads of one batch row, so the grid is
// (H / tiles, B). Nothing f32 of the state's size touches device memory,
// and as the step writes the state where it lies, the caller stores
// nothing.
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kThreads = 128;
constexpr int kVecsPerThread = 16;

struct Strides {
  long long xb, xh, bb, bg, cb, cg, db, dh;
};

// Element i of a 16-byte vector of T as f32, and f32 values packed back.
template <typename T>
__device__ __forceinline__ float elem(const uint4& u, int i);
template <>
__device__ __forceinline__ float elem<float>(const uint4& u, int i) {
  return __uint_as_float((&u.x)[i]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int i) {
  const uint32_t w = (&u.x)[i / 2];
  return __uint_as_float(i & 1 ? w & 0xffff0000u : w << 16);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float* f);
template <>
__device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <>
__device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  return make_uint4(repro::pack_bf16(f[0], f[1]), repro::pack_bf16(f[2], f[3]),
                    repro::pack_bf16(f[4], f[5]), repro::pack_bf16(f[6], f[7]));
}

// Warps a tile takes so that a thread holds kVecsPerThread vectors (one
// warp for a smaller tile).
template <typename T, int N, int P>
constexpr int kWarpsPerTile =
    N * P / repro::kVec16<T> > 32 * kVecsPerThread
        ? N * P / repro::kVec16<T> / (32 * kVecsPerThread) : 1;

template <typename T, int N, int P>
__global__ void __launch_bounds__(kThreads)
ssm_step_kernel(T* state, const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm, const T* __restrict__ cm,
                T* __restrict__ y, int heads, int per_group, Strides s) {
  constexpr int V = repro::kVec16<T>;  // state elements a vector
  constexpr int W = kWarpsPerTile<T, N, P>;
  constexpr int TILES = kThreads / (32 * W);
  constexpr int CV = P / V;             // vectors a state row
  constexpr int RS = W * (32 / CV);     // rows the tile's threads cover at once
  constexpr int R = N / RS;             // vectors a thread holds
  static_assert(W >= 1 && W <= 4 && R >= 1 && R <= kVecsPerThread && RS * R == N,
                "tile shape");
  __shared__ float sb[TILES][N], sc[TILES][N];
  __shared__ float part[TILES][W][P];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = warp / W, tw = warp % W;
  const long long b = blockIdx.y;
  const int h0 = blockIdx.x * TILES;
  const int h = h0 + tile;
  const bool live = h < heads;  // no early return: the CTA meets at barriers
  const int hc = live ? h : heads - 1;
  const int col = lane % CV, row = tw * (32 / CV) + lane / CV;

  T* st = state + ((b * heads + hc) * N + row) * P + col * V;
  uint4 v[R];
#pragma unroll
  for (int k = 0; k < R; ++k)
    v[k] = live ? __ldcs(reinterpret_cast<const uint4*>(st + k * RS * P))
                : make_uint4(0u, 0u, 0u, 0u);

  for (int i = threadIdx.x; i < TILES * N; i += kThreads) {
    const int t = i / N, n = i % N;
    const long long g = min(h0 + t, heads - 1) / per_group;
    sb[t][n] = to_f32(bm[b * s.bb + g * s.bg + n]);
    sc[t][n] = to_f32(cm[b * s.cb + g * s.cg + n]);
  }
  const float d = dt[b * s.db + hc * s.dh];
  const float decay = expf(d * a[hc]);
  float xdt[V];
#pragma unroll
  for (int i = 0; i < V; ++i) xdt[i] = to_f32(x[b * s.xb + hc * s.xh + col * V + i]) * d;
  __syncthreads();

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const float bn = sb[tile][row + k * RS], cn = sc[tile][row + k * RS];
    float f[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      f[i] = fmaf(elem<T>(v[k], i), decay, bn * xdt[i]);
      acc[i] = fmaf(cn, f[i], acc[i]);
    }
    if (live) __stcs(reinterpret_cast<uint4*>(st + k * RS * P), pack<T>(f));
  }
#pragma unroll
  for (int off = CV; off < 32; off <<= 1)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], off);

  T* yt = y + (b * heads + hc) * P;
  if constexpr (W == 1) {
    if (live && lane < CV) {
#pragma unroll
      for (int i = 0; i < V; ++i) yt[col * V + i] = from_f32<T>(acc[i]);
    }
  } else {
    if (lane < CV) {
#pragma unroll
      for (int i = 0; i < V; ++i) part[tile][tw][col * V + i] = acc[i];
    }
    __syncthreads();
    if (live && tw == 0) {
#pragma unroll
      for (int p = lane; p < P; p += 32) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) sum += part[tile][w][p];
        yt[p] = from_f32<T>(sum);
      }
    }
  }
}

template <typename T, int N, int P>
int launch_np(void* state, const void* x, const void* dt, const void* a, const void* bm,
              const void* cm, void* y, int batch, int heads, int per_group, const Strides& s,
              cudaStream_t stream) {
  constexpr int tiles = kThreads / (32 * kWarpsPerTile<T, N, P>);
  const dim3 grid((heads + tiles - 1) / tiles, batch);
  ssm_step_kernel<T, N, P><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(state), static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const T*>(bm), static_cast<const T*>(cm),
      static_cast<T*>(y), heads, per_group, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int P>
int launch_p(void* state, const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, void* y, int batch, int heads, int per_group, int n,
             const Strides& s, cudaStream_t stream) {
  switch (n) {
    case 16:
      return launch_np<T, 16, P>(state, x, dt, a, bm, cm, y, batch, heads, per_group, s, stream);
    case 32:
      return launch_np<T, 32, P>(state, x, dt, a, bm, cm, y, batch, heads, per_group, s, stream);
    case 64:
      return launch_np<T, 64, P>(state, x, dt, a, bm, cm, y, batch, heads, per_group, s, stream);
    case 128:
      return launch_np<T, 128, P>(state, x, dt, a, bm, cm, y, batch, heads, per_group, s,
                                  stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(void* state, const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, void* y, int batch, int heads, int groups, int n, int p,
           const Strides& s, cudaStream_t stream) {
  if (batch <= 0 || heads <= 0 || groups <= 0 || heads % groups != 0 || batch > 65535 ||
      !repro::aligned16(state))
    return static_cast<int>(cudaErrorInvalidValue);
  const int per_group = heads / groups;
  if (p == 64)
    return launch_p<T, 64>(state, x, dt, a, bm, cm, y, batch, heads, per_group, n, s, stream);
  if (p == 32)
    return launch_p<T, 32>(state, x, dt, a, bm, cm, y, batch, heads, per_group, n, s, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// state (B,H,N,P) contiguous, updated in place; x (B,H,P), B and C (B,G,N)
// with unit stride in their last dim, their other strides given; y (B,H,P)
// contiguous; all five in the entry's dtype; dt (B,H) and A (H,) in f32 (A
// contiguous).
#define REPRO_SSM_STEP_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(void* state, const void* x, const void* dt, const void* a,      \
                      const void* bm, const void* cm, void* y, int batch, int heads,  \
                      int groups, int n, int p, long long x_sb, long long x_sh,       \
                      long long b_sb, long long b_sg, long long c_sb, long long c_sg, \
                      long long dt_sb, long long dt_sh, void* stream) {               \
    const Strides s{x_sb, x_sh, b_sb, b_sg, c_sb, c_sg, dt_sb, dt_sh};                \
    return launch<T>(state, x, dt, a, bm, cm, y, batch, heads, groups, n, p, s,       \
                     static_cast<cudaStream_t>(stream));                              \
  }

REPRO_SSM_STEP_ENTRY(repro_ssm_step_f32, float)
REPRO_SSM_STEP_ENTRY(repro_ssm_step_bf16, __nv_bfloat16)
