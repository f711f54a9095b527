// Helpers shared by the port's CUDA kernels: dtype conversion, 16-byte
// vector loads and the C error-string entry point every library exports.
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

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace repro

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
