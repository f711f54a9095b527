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
// Design: one warp per row (any row count, no divisor search), lanes walking
// the row with 16-byte vector loads so that a warp reads 512 contiguous bytes
// per instruction, a warp-shuffle reduction of the sum of squares in f32, and
// a second pass over the row that hits L1 (a row of d = 2048 is 4 KiB in
// bf16). w is read in its own dtype and stays in L1/L2 across rows.
#include "common.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int kWarps = 4;  // rows per CTA

template <typename TX, typename TW, int VEC>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
               TX* __restrict__ out, int rows, int d, float eps) {
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
    float f[VEC];
    repro::load_f32<TX, VEC>(f, xr + c);
    repro::Vec<TX, VEC> o;
#pragma unroll
    for (int i = 0; i < VEC; ++i) o.v[i] = from_f32<TX>((f[i] * r) * to_f32(w[c + i]));
    *reinterpret_cast<repro::Vec<TX, VEC>*>(orow + c) = o;
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* out, int rows, int d, float eps,
           cudaStream_t stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((rows + kWarps - 1) / kWarps), block(kWarps * 32);
  constexpr int V = repro::kVec16<TX>;
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* op = static_cast<TX*>(out);
  if (d % V == 0 && repro::aligned16(x) && repro::aligned16(out)) {
    rmsnorm_kernel<TX, TW, V><<<grid, block, 0, stream>>>(xp, wp, op, rows, d, eps);
  } else {
    rmsnorm_kernel<TX, TW, 1><<<grid, block, 0, stream>>>(xp, wp, op, rows, d, eps);
  }
  return static_cast<int>(cudaGetLastError());
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
