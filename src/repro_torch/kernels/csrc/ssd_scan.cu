// Mamba-2 SSD intra-chunk step in f32: the chunk-diagonal output
//   Y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
// and the chunk's state S = sum_j B_j^T (exp(cum_last - cum_j) xdt_j),
// for every (batch, chunk, head).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py: ssd_intra_chunk
// (_ssd_kernel). Its grid is (batch, chunk, head), one whole Q x Q chunk per
// step held in VMEM, and it needs contiguous per-head inputs, so the model
// would transpose xdt and cum first. The inter-chunk recurrence stays outside
// the kernel, as there.
//
// Here: xdt (B,NC,H,Q,P) and cum (B,NC,H,Q) are read through their strides
// (the model holds them as (B,NC,Q,H,.)), B and C (B,NC,Q,N) in their
// storage type (f32 or bf16). One CTA of 256 threads owns one (b, chunk,
// head) and one of two roles, picked by blockIdx.x:
//  * a tile of 64 output rows: it keeps C of those rows in shared memory and
//    walks the key tiles of 64 up to the diagonal, staging B, xdt and cum of
//    each; it forms the 64 x 64 scores C_i . B_j over N, scales them by
//    exp(cum_i - cum_j) where j <= i (the exponent is masked before exp, so
//    the upper triangle cannot overflow into inf * 0 = NaN), and adds the
//    product with xdt_j into a 64 x P accumulator in registers (4 rows by P/16
//    columns a thread);
//  * a tile of 64 state rows n: it walks all key tiles and accumulates
//    B_j[n] exp(cum_last - cum_j) xdt_j.
// Rows and keys past Q are masked, so any Q works. At the zamba2 serve shape
// (B 4, NC 2, H 80, Q 256) that is 4 * 2 * 80 * (4 + 1) = 3,200 CTAs.
//
// Bound on the H100: operations. At the zamba2 serve shape (P 64, N 64) the
// function moves about 95 MB (28 us at 3.35 TB/s) and needs about 4.1 GFLOP
// in f32 (61 us at 67 TFLOP/s); the 1e-4 tolerance rules out TF32 and bf16
// tensor cores. This first version computes on the CUDA cores, recomputes
// the scores C_i . B_j for every head (B and C are shared by the heads), and
// reads its operands from shared memory one scalar at a time, so it is far
// from that bound; sharing the scores across heads and tensor-core tiles are
// later work.
#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int kT = 64;          // rows of an output or state tile; keys of a key tile
constexpr int kThreads = 256;   // 16 x 16; a thread owns rows ty + 16r and columns tx + 16c
constexpr int kMaxN = 256;
constexpr int kLdM = kT + 1;    // padded row of the masked score tile

struct Strides {
  long long xdt[4];  // b, chunk, head, q (unit stride over P)
  long long cum[4];  // b, chunk, head, q
  long long bm[3];   // b, chunk, q (unit stride over N)
  long long cm[3];
  long long y[4];    // b, chunk, head, q (unit stride over P)
};

// B and C rows in shared memory are padded to an odd number of 32-bit
// words, so the 16 rows a warp reads at one n fall in distinct banks.
template <typename TB>
constexpr int kPadB = 4 / static_cast<int>(sizeof(TB));

template <typename TB, int P>
size_t smem_bytes(int n) {
  return sizeof(float) * (kT * P + kT * kLdM + kT) + sizeof(TB) * 2 * kT * (n + kPadB<TB>);
}

// Rows r0..r0+kT-1 of a (Q, N) matrix into dst[row][ld]; rows at or past q are zero.
template <typename TB>
__device__ __forceinline__ void load_rows(TB* __restrict__ dst, const TB* __restrict__ src,
                                          long long stride_q, int r0, int q, int n, int ld) {
  for (int i = threadIdx.x; i < kT * n; i += blockDim.x) {
    const int row = i / n, k = i % n;
    dst[row * ld + k] = r0 + row < q ? src[(r0 + row) * stride_q + k] : repro::from_f32<TB>(0.f);
  }
}

// Rows r0..r0+kT-1 of xdt (Q, P) into dst[row][P]; rows at or past q are zero.
template <int P>
__device__ __forceinline__ void load_x(float* __restrict__ dst, const float* __restrict__ src,
                                       long long stride_q, int r0, int q) {
  for (int i = threadIdx.x; i < kT * P; i += blockDim.x) {
    const int row = i / P, p = i % P;
    dst[i] = r0 + row < q ? src[(r0 + row) * stride_q + p] : 0.f;
  }
}

template <typename TB, int P>
__global__ void __launch_bounds__(kThreads)
ssd_intra_chunk_kernel(const float* __restrict__ xdt, const float* __restrict__ cum,
                       const TB* __restrict__ bm, const TB* __restrict__ cm,
                       float* __restrict__ y, float* __restrict__ st, int n_chunks, int q,
                       int n, int row_tiles, Strides s) {
  constexpr int PC = P / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  const int ldb = n + kPadB<TB>;
  float* xs = smem;                            // [kT][P]   xdt of the key tile
  float* ms = xs + kT * P;                     // [kT][kLdM] masked scores
  float* cs_j = ms + kT * kLdM;                // [kT]      cum (role 1) or weight (role 2)
  TB* cs = reinterpret_cast<TB*>(cs_j + kT);   // [kT][ldb] C of the output rows
  TB* bs = cs + kT * ldb;                      // [kT][ldb] B of the key tile

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int c = blockIdx.z % n_chunks;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const float* xh = xdt + b * s.xdt[0] + c * s.xdt[1] + h * s.xdt[2];
  const float* ch = cum + b * s.cum[0] + c * s.cum[1] + h * s.cum[2];
  const TB* bb = bm + b * s.bm[0] + c * s.bm[1];
  const TB* cb = cm + b * s.cm[0] + c * s.cm[1];

  float acc[4][PC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < PC; ++k) acc[r][k] = 0.f;

  if (tile < row_tiles) {
    // Role 1: output rows i0 .. i0 + 63.
    const int i0 = tile * kT;
    load_rows<TB>(cs, cb, s.cm[2], i0, q, n, ldb);
    float ci[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      ci[r] = i < q ? ch[i * s.cum[3]] : 0.f;
    }
    for (int j0 = 0; j0 <= i0; j0 += kT) {  // key tiles up to the diagonal one
      __syncthreads();  // the previous key tile is no longer read
      load_rows<TB>(bs, bb, s.bm[2], j0, q, n, ldb);
      load_x<P>(xs, xh, s.xdt[3], j0, q);
      if (threadIdx.x < kT) {
        const int j = j0 + threadIdx.x;
        cs_j[threadIdx.x] = j < q ? ch[j * s.cum[3]] : 0.f;
      }
      __syncthreads();

      float sc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) sc[r][k] = 0.f;
      for (int k = 0; k < n; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) a[r] = to_f32(cs[(ty + 16 * r) * ldb + k]);
#pragma unroll
        for (int u = 0; u < 4; ++u) bv[u] = to_f32(bs[(tx + 16 * u) * ldb + k]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) sc[r][u] = fmaf(a[r], bv[u], sc[r][u]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = j0 + tx + 16 * u;
          const bool ok = j <= i && i < q;
          const float e = expf(ok ? ci[r] - cs_j[tx + 16 * u] : 0.f);
          ms[(ty + 16 * r) * kLdM + tx + 16 * u] = ok ? sc[r][u] * e : 0.f;
        }
      }
      __syncthreads();

      for (int jj = 0; jj < kT; ++jj) {
        float mv[4], xv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = ms[(ty + 16 * r) * kLdM + jj];
#pragma unroll
        for (int k = 0; k < PC; ++k) xv[k] = xs[jj * P + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < PC; ++k) acc[r][k] = fmaf(mv[r], xv[k], acc[r][k]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i < q) {
        float* yr = y + b * s.y[0] + c * s.y[1] + h * s.y[2] + i * s.y[3];
#pragma unroll
        for (int k = 0; k < PC; ++k) yr[tx + 16 * k] = acc[r][k];
      }
    }
  } else {
    // Role 2: state rows n0 .. n0 + 63.
    const int n0 = (tile - row_tiles) * kT;
    const float last = ch[(q - 1) * s.cum[3]];
    for (int j0 = 0; j0 < q; j0 += kT) {
      __syncthreads();  // the previous key tile is no longer read
      load_rows<TB>(bs, bb, s.bm[2], j0, q, n, ldb);
      load_x<P>(xs, xh, s.xdt[3], j0, q);
      if (threadIdx.x < kT) {
        const int j = j0 + threadIdx.x;
        cs_j[threadIdx.x] = j < q ? expf(last - ch[j * s.cum[3]]) : 0.f;
      }
      __syncthreads();
      for (int jj = 0; jj < kT; ++jj) {
        const float w = cs_j[jj];
        float bv[4], xv[PC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int k = n0 + ty + 16 * r;
          bv[r] = k < n ? to_f32(bs[jj * ldb + k]) * w : 0.f;
        }
#pragma unroll
        for (int k = 0; k < PC; ++k) xv[k] = xs[jj * P + tx + 16 * k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int k = 0; k < PC; ++k) acc[r][k] = fmaf(bv[r], xv[k], acc[r][k]);
      }
    }
    const long long head = (static_cast<long long>(b) * n_chunks + c) * gridDim.y + h;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = n0 + ty + 16 * r;
      if (k < n) {
        float* sr = st + (head * n + k) * P;
#pragma unroll
        for (int u = 0; u < PC; ++u) sr[tx + 16 * u] = acc[r][u];
      }
    }
  }
}

template <typename TB, int P>
int launch_p(const void* xdt, const void* cum, const void* bm, const void* cm, void* y, void* st,
             int b, int nc, int h, int q, int n, const Strides& s, cudaStream_t stream) {
  const size_t smem = smem_bytes<TB, P>(n);
  static size_t configured = 0;  // bytes the attribute was last raised to
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_intra_chunk_kernel<TB, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const int row_tiles = (q + kT - 1) / kT;
  const int state_tiles = (n + kT - 1) / kT;
  const dim3 grid(row_tiles + state_tiles, h, b * nc);
  ssd_intra_chunk_kernel<TB, P><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(cum),
      static_cast<const TB*>(bm), static_cast<const TB*>(cm), static_cast<float*>(y),
      static_cast<float*>(st), nc, q, n, row_tiles, s);
  return static_cast<int>(cudaGetLastError());
}

template <typename TB>
int launch(const void* xdt, const void* cum, const void* bm, const void* cm, void* y, void* st,
           int b, int nc, int h, int q, int p, int n, const long long* strides,
           cudaStream_t stream) {
  if (b <= 0 || nc <= 0 || h <= 0 || q <= 0 || n <= 0 || n > kMaxN || h > 65535 ||
      static_cast<long long>(b) * nc > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s;
  for (int i = 0; i < 4; ++i) s.xdt[i] = strides[i];
  for (int i = 0; i < 4; ++i) s.cum[i] = strides[4 + i];
  for (int i = 0; i < 3; ++i) s.bm[i] = strides[8 + i];
  for (int i = 0; i < 3; ++i) s.cm[i] = strides[11 + i];
  for (int i = 0; i < 4; ++i) s.y[i] = strides[14 + i];
  switch (p) {
    case 32: return launch_p<TB, 32>(xdt, cum, bm, cm, y, st, b, nc, h, q, n, s, stream);
    case 64: return launch_p<TB, 64>(xdt, cum, bm, cm, y, st, b, nc, h, q, n, s, stream);
    case 128: return launch_p<TB, 128>(xdt, cum, bm, cm, y, st, b, nc, h, q, n, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// xdt (B,NC,H,Q,P) and cum (B,NC,H,Q) f32, B/C (B,NC,Q,N) of type T, y
// (B,NC,H,Q,P) f32 (unit stride over P), states (B,NC,H,N,P) f32 contiguous.
// strides: 18 element strides, in the order xdt b, c, h, q; cum b, c, h, q;
// B b, c, q; C b, c, q; y b, c, h, q.
#define REPRO_SSD_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* xdt, const void* cum, const void* bm, const void* cm,     \
                      void* y, void* st, int b, int nc, int h, int q, int p, int n,         \
                      const long long* strides, void* stream) {                             \
    return launch<T>(xdt, cum, bm, cm, y, st, b, nc, h, q, p, n, strides,                   \
                     static_cast<cudaStream_t>(stream));                                    \
  }

REPRO_SSD_ENTRY(repro_ssd_intra_chunk_f32, float)
REPRO_SSD_ENTRY(repro_ssd_intra_chunk_bf16, __nv_bfloat16)
