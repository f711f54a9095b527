// RMSNorm with a learned scale: out = x * rsqrt(mean(x^2) + eps) * w, in f32,
// written back in x's dtype.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py:rmsnorm_rows
// (_rmsnorm_kernel), which the JAX wrapper (kernels/ops.py:fused_rmsnorm)
// feeds in blocks of rows whose count must divide the number of rows.
//
// Bound on the H100: bytes. The work is about 4 flops per element against
// 2 * sizeof(x) bytes moved, two orders of magnitude below the card's ridge
// point, so the kernel is as fast as it reads x once and writes out once.
// Design (any row count, no divisor search): a row is spread over W warps of
// a 128-thread CTA (W = 1, 2 or 4; 4 / W rows a CTA), each thread holding
// VPL 16-byte vectors of the row in registers as raw 32-bit words (two bf16
// a register), VPL a template argument (up to 64 elements a thread, so rows
// up to d = 8192 on 4 warps). Every load of x and of w (also as vectors) is
// issued before the reduction, so a thread has all of them in flight at
// once, and x is read from device memory once: the sum of squares is reduced
// over the warp by shuffles and over the row's warps through shared memory,
// and the output is formed from the registers. W is the least that keeps a
// thread at 64 elements, and 4 where there are few rows (decode; 4 x 2048
// took 17 % less time on an H100 than on one warp), so that a row's loads
// spread over more SMs. Wider rows, and rows not in 16-byte vectors, take the second
// kernel: one warp per row, a loop over the row for the sum of squares and a
// second pass that reads the row again (from L1/L2).
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::Vec;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRegElems = 64;    // elements of x a thread holds in registers
constexpr int kFewRows = 256;    // at most this many rows: a row takes all 4 warps

// VEC elements of T as raw 32-bit words (8, 16 or 32 bytes, aligned as
// much), so that two bf16 stay packed in one register.
template <typename T, int VEC>
using Words = Vec<uint32_t, VEC * static_cast<int>(sizeof(T)) / 4>;

// Element i of such words as f32.
template <typename T>
__device__ __forceinline__ float elem(const uint32_t* u, int i);
template <>
__device__ __forceinline__ float elem<float>(const uint32_t* u, int i) {
  return __uint_as_float(u[i]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint32_t* u, int i) {
  return __uint_as_float(i & 1 ? u[i / 2] & 0xffff0000u : u[i / 2] << 16);
}

template <typename TX, typename TW, int VPL>
__global__ void __launch_bounds__(kThreads)
rmsnorm_regs_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                    int rows, int d, int warps_per_row, float eps) {
  constexpr int VEC = repro::kVec16<TX>;
  __shared__ float part[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t_row = 32 * warps_per_row;
  const int tid = threadIdx.x % t_row;
  const long long row = static_cast<long long>(blockIdx.x) * (kWarps / warps_per_row) +
                        threadIdx.x / t_row;
  const bool live = row < rows;  // no early return: the row's warps meet at a barrier
  const TX* xr = x + (live ? row : 0) * d;

  Words<TX, VEC> xv[VPL];
  Words<TW, VEC> wv[VPL];
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = (k * t_row + tid) * VEC;
    if (live && c < d) {
      xv[k] = *reinterpret_cast<const Words<TX, VEC>*>(xr + c);
      wv[k] = *reinterpret_cast<const Words<TW, VEC>*>(w + c);
    } else {
#pragma unroll
      for (auto& u : xv[k].v) u = 0u;
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < VPL; ++k)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float f = elem<TX>(xv[k].v, i);
      ss += f * f;
    }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  if (warps_per_row > 1) {
    if (lane == 0) part[warp] = ss;
    __syncthreads();
    const int first = warp / warps_per_row * warps_per_row;
    ss = 0.f;
    for (int i = 0; i < warps_per_row; ++i) ss += part[first + i];
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  TX* orow = out + (live ? row : 0) * d;
#pragma unroll
  for (int k = 0; k < VPL; ++k) {
    const int c = (k * t_row + tid) * VEC;
    if (live && c < d) {
      Vec<TX, VEC> o;
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        o.v[i] = from_f32<TX>((elem<TX>(xv[k].v, i) * r) * elem<TW>(wv[k].v, i));
      *reinterpret_cast<Vec<TX, VEC>*>(orow + c) = o;
    }
  }
}

// One warp per row, two passes over the row: rows wider than the register
// kernel takes (VEC = 16 bytes of x), or not in 16-byte vectors (VEC = 1).
template <typename TX, typename TW, int VEC>
__global__ void __launch_bounds__(kThreads)
rmsnorm_loop_kernel(const TX* __restrict__ x, const TW* __restrict__ w, TX* __restrict__ out,
                    int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * d;
  TX* orow = out + row * d;

  float ss = 0.f;
  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float f[VEC];
    repro::load_f32<TX, VEC>(f, xr + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i) ss += f[i] * f[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

  for (int c = lane * VEC; c < d; c += 32 * VEC) {
    float f[VEC], g[VEC];
    repro::load_f32<TX, VEC>(f, xr + c);
    repro::load_f32<TW, VEC>(g, w + c);
    Vec<TX, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<TX>((f[i] * r) * g[i]);
    *reinterpret_cast<Vec<TX, VEC>*>(orow + c) = o;
  }
}

// The register kernel with VPL = vpl, found by walking up from VPL.
template <typename TX, typename TW, int VPL>
int launch_regs(int vpl, int wpr, const TX* x, const TW* w, TX* out, int rows, int d,
                float eps, cudaStream_t stream) {
  if constexpr (VPL * repro::kVec16<TX> > kRegElems) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (vpl != VPL) return launch_regs<TX, TW, VPL + 1>(vpl, wpr, x, w, out, rows, d, eps, stream);
    const int rows_per_cta = kWarps / wpr;
    const dim3 grid((rows + rows_per_cta - 1) / rows_per_cta);
    rmsnorm_regs_kernel<TX, TW, VPL><<<grid, kThreads, 0, stream>>>(x, w, out, rows, d, wpr, eps);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int V = repro::kVec16<TX>;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  const dim3 grid((rows + kWarps - 1) / kWarps);
  const bool vec = d % V == 0 && repro::aligned16(x) && repro::aligned16(out) &&
                   reinterpret_cast<uintptr_t>(w) % (sizeof(TW) * V) == 0;
  if (!vec) {
    rmsnorm_loop_kernel<TX, TW, 1><<<grid, kThreads, 0, stream>>>(xp, wp, op, rows, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  const int vectors = d / V;
  int wpr = rows <= kFewRows ? kWarps : 1;  // warps per row
  while (wpr < kWarps && (vectors + 32 * wpr - 1) / (32 * wpr) * V > kRegElems) wpr *= 2;
  const int vpl = (vectors + 32 * wpr - 1) / (32 * wpr);
  if (vpl * V > kRegElems) {
    rmsnorm_loop_kernel<TX, TW, V><<<grid, kThreads, 0, stream>>>(xp, wp, op, rows, d, eps);
    return static_cast<int>(cudaGetLastError());
  }
  return launch_regs<TX, TW, 1>(vpl, wpr, xp, wp, op, rows, d, eps, stream);
}

}  // namespace

// x (rows, d) and out (rows, d) contiguous in the first dtype, w (d,) in the
// second; eps as in the model config.
#define REPRO_RMSNORM_ENTRY(NAME, TX, TW)                                          \
  extern "C" int NAME(const void* x, const void* w, void* out, int rows, int d, \
                      float eps, void* stream) {                                   \
    return launch<TX, TW>(x, w, out, rows, d, eps, static_cast<cudaStream_t>(stream)); \
  }

REPRO_RMSNORM_ENTRY(repro_rmsnorm_f32_f32, float, float)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_f32_bf16, float, __nv_bfloat16)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_bf16_f32, __nv_bfloat16, float)
REPRO_RMSNORM_ENTRY(repro_rmsnorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
