// Helpers shared by the port's CUDA kernels: dtype conversion, 16-byte
// vector loads, bf16 packing and the two-term bf16 split of a product's
// operand, and the C error-string entry point every library exports.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Masked and initial scores of the online softmax, as in the TPU kernels.
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// N elements of T moved as one aligned load or store (16 bytes when
// N * sizeof(T) == 16).
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Elements of T in one 16-byte load.
template <typename T>
constexpr int kVec16 = 16 / static_cast<int>(sizeof(T));

// Load N contiguous elements of T (aligned to N * sizeof(T)) as f32.
template <typename T, int N>
__device__ __forceinline__ void load_f32(float (&dst)[N], const T* src) {
  const Vec<T, N> a = *reinterpret_cast<const Vec<T, N>*>(src);
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = to_f32(a.v[i]);
}

// Two floats rounded to bf16 in one register, ``lo`` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p0, p1 as two bf16 terms each, hi + lo, exact to about 16 bits: hi holds
// bf16(p0), bf16(p1) and lo the rounded remainders, both packed as above.
__device__ __forceinline__ void split_bf16(float p0, float p1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(p0, p1);
  lo = pack_bf16(p0 - __uint_as_float(hi << 16), p1 - __uint_as_float(hi & 0xffff0000u));
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
