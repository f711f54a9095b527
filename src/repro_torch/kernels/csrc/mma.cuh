// Asynchronous copies and warp-level tensor-core tiles (sm_80 and later,
// built here for sm_90a): cp.async of 16 or 4 bytes with zero fill, ldmatrix of
// four 8x8 b16 tiles (plain and transposed) and mma.sync m16n8k16 on bf16
// with f32 accumulation. (The bf16 split of a product's operand,
// ``split_bf16``, is in common.cuh.)
//
// Fragment layouts (lane = 4 * group + quad, PTX ISA "Matrix fragments for
// mma.m16n8k16"), used by the kernels that include this header:
//   A (16 x 16, row-major), 4 registers of two bf16:
//     a0 (row group,     cols 2*quad, +1)   a1 (row group + 8, cols 2*quad, +1)
//     a2 (row group, cols 8 + 2*quad, +1)   a3 (row group + 8, cols 8 + 2*quad, +1)
//   B (16 x 8, k by n), 2 registers: b0 (k 2*quad, +1; n group),
//     b1 (k 8 + 2*quad, +1; n group)
//   C/D (16 x 8, f32): c0, c1 (row group, cols 2*quad, +1),
//     c2, c3 (row group + 8, cols 2*quad, +1)
// ldmatrix.x4: lanes 8i..8i+7 give the row addresses of tile i, and every
// lane receives register i from tile i: (row group, cols 2*quad, +1), or
// with .trans (rows 2*quad, +1; col group).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without passing through
// registers; when ``valid`` is false nothing is read and dst is zeroed.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// Copy 4 bytes (any 4-byte aligned address); zero-fills dst when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a * b on one 16 x 8 x 16 tile.
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace repro
