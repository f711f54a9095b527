// Mamba-2 SSD intra-chunk step: the chunk-diagonal output
//   Y[i] = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j
// and the chunk's state S = sum_j B_j^T (exp(cum_last - cum_j) xdt_j),
// for every (batch, chunk, head), accumulated in f32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py: ssd_intra_chunk
// (_ssd_kernel). Its grid is (batch, chunk, head), one whole Q x Q chunk per
// step held in VMEM, and it needs contiguous per-head inputs, so the model
// would transpose xdt and cum first. The inter-chunk recurrence stays outside
// the kernel, as there.
//
// Here: xdt (B,NC,H,Q,P) and cum (B,NC,H,Q) are read through their strides
// (the model holds them as (B,NC,Q,H,.)), B and C (B,NC,Q,N) in their
// storage type. One CTA owns one (b, chunk, head) and one tile of rows in
// one of two roles, picked by blockIdx.x (state tiles first, then output
// tiles from the last, which walks the most key tiles, to the first):
//  * output rows: it walks the key tiles of 64 up to its last row, forms
//    the scores C_i . B_j, scales them by exp(cum_i - cum_j) where j <= i
//    and i < Q (the exponent is masked before exp, so the upper triangle
//    cannot overflow into inf * 0 = NaN), and adds their product with xdt_j
//    into its rows' accumulator;
//  * state rows n0 .. n0 + 63: it walks all key tiles and accumulates
//    B_j[n] exp(cum_last - cum_j) xdt_j.
// Rows and keys past Q are masked, so any Q works.
//
// bf16 B and C (the served type): the products run on the tensor cores,
// mma.sync.m16n8k16 bf16 in, f32 accumulate, as in flash_attention.cu with
// C for Q, B for K and xdt for V. A CTA has 8 warps; an output tile is 128
// rows, 16 a warp, so each key tile staged and split serves 128 rows (at
// the zamba2 serve shape, B 4, NC 2, H 80, Q 256, N 64: 4 * 2 * 80 * (2 + 1)
// = 1,920 CTAs; on the H100, 4 warps with 64-row tiles measured 8 % slower
// and 2 to 8 heads grouped in one CTA 7 to 47 % slower). For each block of
// 16 keys up
// to its last row, a warp forms the scores C.B^T from shared memory through
// ldmatrix, exact up to summation order since B and C are bf16; applies the
// decay and the mask on the accumulator fragments, where each lane knows its
// (i, j), as exp2 of the exact difference times log2(e); and splits M into
// two bf16 terms, hi = bf16(M) and lo = bf16(M - hi), about 16 bits. xdt
// enters the same way, split once per key tile into padded shared memory and
// read with ldmatrix.trans: acc += Mh.Xh + Ml.Xh + Mh.Xl. The state takes
// B^T as an exact A operand (ldmatrix.trans of the B tile) against w.xdt
// split the same way, two products; its 8 warps own 16 state rows and half
// of P each. The 1e-4 tolerance is held at about 1e-5 on the card (about
// 1e-3 with M rounded once). Key tiles of B, cum and f32 xdt are fetched
// with cp.async one tile ahead while the current tile is computed (B and
// cum in a two-stage ring, xdt in one f32 buffer that is split into the
// bf16 tiles at the start of each step); rows are padded by 16 bytes so the
// 8 row addresses of each ldmatrix fall in distinct banks. The state is
// computed in CTAs of its own, not in the last output tile's: that keeps
// the work per CTA even and each role's registers low.
//
// f32 B and C (checks of the f32 model, no serve path): the products stay on
// the CUDA cores in f32, 64-row tiles, one scalar at a time from shared
// memory, 256 threads a CTA.
//
// Bound on the H100: bytes, for bf16. At the zamba2 serve shape (P 64, N 64)
// the function moves about 95 MB (28 us at 3.35 TB/s) against 4.1 GFLOP of
// products (4 us at the 989 TFLOP/s bf16 tensor-core rate, counting each
// product once and the scores once per chunk; the kernel does about 14
// GFLOP with the split terms and the scores per head). On the f32 CUDA
// cores the same 4.1 GFLOP would take 61 us at 67 TFLOP/s.
#include "common.cuh"
#include "mma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kT = 64;  // keys of a key tile; rows of a state tile and of an f32 output tile
constexpr int kMaxN = 256;

struct Strides {
  long long xdt[4];  // b, chunk, head, q (unit stride over P)
  long long cum[4];  // b, chunk, head, q
  long long bm[3];   // b, chunk, q (unit stride over N)
  long long cm[3];
  long long y[4];    // b, chunk, head, q (unit stride over P)
};

// ---------------------------------------------------------------------------
// bf16 B and C: tensor cores
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows of an output tile, 16 a warp
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the bf16 kernel for head dim P and state width n.
template <int P>
struct Bf16Smem {
  static constexpr int RSX = P + 8;  // padded row of the split xdt tiles, elements
  static size_t bytes(int n) {
    const int rsb = ((n + 15) & ~15) + 8;  // padded row of the B and C tiles
    return sizeof(float) * (kT * P + 2 * kT) +
           sizeof(bf16) * (2 * kT * RSX + (kRows + 2 * kT) * rsb);
  }
};

// Issue the copies of rows r0 .. r0 + ROWS - 1, columns col0 .. col0 + ncols - 1
// of a (Q, N) bf16 matrix into dst[row][rsb]; rows at or past q and columns at
// or past n are zeroed. ``vec``: 16-byte cp.async (n % 8 == 0, rows aligned),
// else one element at a time through registers.
template <int ROWS>
__device__ __forceinline__ void load_bc(bf16* dst, int rsb, const bf16* src, long long stride,
                                        int r0, int q, int col0, int ncols, int n, bool vec) {
  if (vec) {
    const int per_row = ncols / 8;
    for (int i = threadIdx.x; i < ROWS * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * 8;
      const bool ok = r0 + r < q && col0 + c < n;
      repro::cp_async16(dst + r * rsb + c, ok ? src + (r0 + r) * stride + col0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * ncols; i += kThreads) {
      const int r = i / ncols, c = i % ncols;
      const bool ok = r0 + r < q && col0 + c < n;
      dst[r * rsb + c] = ok ? src[(r0 + r) * stride + col0 + c] : __float2bfloat16(0.f);
    }
  }
}

// Issue the copies of key tile j0 of xdt (f32, into xf[kT][P]) and of cum
// (into cj[kT]); rows at or past q are zeroed. ``vec``: xdt rows 16-byte
// aligned.
template <int P>
__device__ __forceinline__ void load_key_tile(float* xf, float* cj, const float* xh,
                                              const float* ch, const Strides& s, int j0,
                                              int q, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < kT * P / 4; i += kThreads) {
      const int r = i / (P / 4), c = (i % (P / 4)) * 4;
      const bool ok = j0 + r < q;
      repro::cp_async16(xf + r * P + c, ok ? xh + (j0 + r) * s.xdt[3] + c : xh, ok);
    }
  } else {
    for (int i = threadIdx.x; i < kT * P; i += kThreads) {
      const int r = i / P, c = i % P;
      const bool ok = j0 + r < q;
      repro::cp_async4(xf + i, ok ? xh + (j0 + r) * s.xdt[3] + c : xh, ok);
    }
  }
  if (threadIdx.x < kT) {
    const int j = j0 + threadIdx.x;
    repro::cp_async4(cj + threadIdx.x, j < q ? ch + j * s.cum[3] : ch, j < q);
  }
}

// The f32 tile xf, each row r scaled by exp(last - cj[r]) where ``weighted``
// (0 past q), as two bf16 tiles hi + lo in [kT][P + 8].
template <int P>
__device__ __forceinline__ void split_tile(bf16* xhi, bf16* xlo, const float* xf,
                                           const float* cj, bool weighted, float last, int j0,
                                           int q) {
  constexpr int RSX = Bf16Smem<P>::RSX;
  for (int i = threadIdx.x; i < kT * P / 4; i += kThreads) {
    const int r = i / (P / 4), c = (i % (P / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(xf + r * P + c);
    if (weighted) {
      const float w = j0 + r < q ? expf(last - cj[r]) : 0.f;
      v.x *= w;
      v.y *= w;
      v.z *= w;
      v.w *= w;
    }
    uint32_t h0, l0, h1, l1;
    repro::split_bf16(v.x, v.y, h0, l0);
    repro::split_bf16(v.z, v.w, h1, l1);
    *reinterpret_cast<uint2*>(xhi + r * RSX + c) = make_uint2(h0, h1);
    *reinterpret_cast<uint2*>(xlo + r * RSX + c) = make_uint2(l0, l1);
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
ssd_bf16_kernel(const float* __restrict__ xdt, const float* __restrict__ cum,
                const bf16* __restrict__ bm, const bf16* __restrict__ cm, float* __restrict__ y,
                float* __restrict__ st, int n_chunks, int q, int n, int row_tiles,
                int state_tiles, int vec_x, int vec_bc, Strides s) {
  constexpr int RSX = Bf16Smem<P>::RSX;
  constexpr int NP = P / 8;  // 8-column blocks of a warp's 16 x P accumulator
  const int n16 = (n + 15) & ~15;
  const int rsb = n16 + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* xf = reinterpret_cast<float*>(smem_raw);  // [kT][P]   f32 xdt of the next key tile
  float* cj = xf + kT * P;                         // [2][kT]   cum of the key tile
  bf16* xhi = reinterpret_cast<bf16*>(cj + 2 * kT);  // [kT][RSX] split xdt (or w.xdt)
  bf16* xlo = xhi + kT * RSX;
  bf16* cs = xlo + kT * RSX;                       // [kRows][rsb] C of the output rows
  bf16* bs = cs + kRows * rsb;                     // [2][kT][rsb] B of the key tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = lane >> 2, quad = lane & 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int c = blockIdx.z % n_chunks;
  const float* xh = xdt + b * s.xdt[0] + c * s.xdt[1] + h * s.xdt[2];
  const float* ch = cum + b * s.cum[0] + c * s.cum[1] + h * s.cum[2];
  const bf16* bb = bm + b * s.bm[0] + c * s.bm[1];
  const bf16* cb = cm + b * s.cm[0] + c * s.cm[1];

  float acc[NP][4];
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k][0] = acc[k][1] = acc[k][2] = acc[k][3] = 0.f;
  // B-operand rows of the split xdt tiles for ldmatrix.trans (as V in flash
  // attention): tiles (keys 0-7 | 8-15) x (cols 0-7 | 8-15).
  const int xoff = ((lane & 7) + 8 * ((lane >> 3) & 1)) * RSX + 8 * (lane >> 4);

  // Both roles fetch the next key tile while computing the current one.
  if (static_cast<int>(blockIdx.x) < state_tiles) {
    // State rows n0 .. n0 + 63 by P columns: warp w owns rows
    // n0 + 16 (w % 4) .. + 15 and the (w / 4)-th slice of PW columns.
    constexpr int PW = P / (kWarps / 4);
    const int n0 = blockIdx.x * kT;
    const int nw = 16 * (warp % 4), pw = PW * (warp / 4);
    const int ncols = min(kT, n16 - n0);
    const int n_tiles = (q + kT - 1) / kT;
    const float last = ch[(q - 1) * s.cum[3]];
    load_bc<kT>(bs, rsb, bb, s.bm[2], 0, q, n0, ncols, n, vec_bc);
    load_key_tile<P>(xf, cj, xh, ch, s, 0, q, vec_x);
    repro::cp_async_commit();
    // A operand B^T (n by keys) from the stored [key][n] tile by
    // ldmatrix.trans: tiles (n 0-7 | 8-15) x (keys 0-7 | 8-15).
    const int aoff = ((lane & 7) + 8 * (lane >> 4)) * rsb + nw + 8 * ((lane >> 3) & 1);
    for (int it = 0; it < n_tiles; ++it) {
      const int j0 = it * kT, stg = it & 1;
      repro::cp_async_wait<0>();
      __syncthreads();  // tile it is in; the previous step's reads are done
      split_tile<P>(xhi, xlo, xf, cj + stg * kT, true, last, j0, q);
      __syncthreads();  // split tiles written; xf free
      if (it + 1 < n_tiles) {
        load_bc<kT>(bs + (stg ^ 1) * kT * rsb, rsb, bb, s.bm[2], j0 + kT, q, n0, ncols, n,
                    vec_bc);
        load_key_tile<P>(xf, cj + (stg ^ 1) * kT, xh, ch, s, j0 + kT, q, vec_x);
        repro::cp_async_commit();
      }
      if (nw < ncols) {
        const bf16* bt = bs + stg * kT * rsb;
#pragma unroll
        for (int jc = 0; jc < kT / 16; ++jc) {
          uint32_t af[4];
          repro::ldmatrix_x4_trans(af, bt + aoff + jc * 16 * rsb);
#pragma unroll
          for (int d2 = 0; d2 < PW / 16; ++d2) {
            uint32_t fh[4], fl[4];
            repro::ldmatrix_x4_trans(fh, xhi + xoff + jc * 16 * RSX + pw + d2 * 16);
            repro::ldmatrix_x4_trans(fl, xlo + xoff + jc * 16 * RSX + pw + d2 * 16);
            repro::mma_bf16_16816(acc[2 * d2], af, fh[0], fh[1]);
            repro::mma_bf16_16816(acc[2 * d2 + 1], af, fh[2], fh[3]);
            repro::mma_bf16_16816(acc[2 * d2], af, fl[0], fl[1]);
            repro::mma_bf16_16816(acc[2 * d2 + 1], af, fl[2], fl[3]);
          }
        }
      }
    }
    const long long head = (static_cast<long long>(b) * n_chunks + c) * gridDim.y + h;
    const int na = n0 + nw + group, nb = na + 8;
    float* sa = st + (head * n + na) * P + pw + 2 * quad;
#pragma unroll
    for (int k = 0; k < PW / 8; ++k) {
      if (na < n) *reinterpret_cast<float2*>(sa + k * 8) = make_float2(acc[k][0], acc[k][1]);
      if (nb < n) *reinterpret_cast<float2*>(sa + 8 * P + k * 8) = make_float2(acc[k][2], acc[k][3]);
    }
    return;
  }

  // Output rows i0 .. i0 + kRows - 1, the last tile first; warp w owns rows
  // i0 + 16w + group and + 8 of its accumulator fragments. Key tiles run to
  // the last row of the tile.
  const int tile = row_tiles - 1 - (static_cast<int>(blockIdx.x) - state_tiles);
  const int i0 = tile * kRows;
  const int n_tiles = (min(i0 + kRows, q) + kT - 1) / kT;
  load_bc<kRows>(cs, rsb, cb, s.cm[2], i0, q, 0, n16, n, vec_bc);
  load_bc<kT>(bs, rsb, bb, s.bm[2], 0, q, 0, n16, n, vec_bc);
  load_key_tile<P>(xf, cj, xh, ch, s, 0, q, vec_x);
  repro::cp_async_commit();
  const int ia = i0 + warp * 16 + group, ib = ia + 8;
  const float cia = ia < q ? ch[ia * s.cum[3]] : 0.f;
  const float cib = ib < q ? ch[ib * s.cum[3]] : 0.f;
  // A operand C (rows by n) by ldmatrix: tiles (rows 0-7 | 8-15) x (n 0-7 | 8-15);
  // B operand B^T (n by keys) from the stored [key][n] tile by ldmatrix:
  // tiles (keys 0-7 | 8-15) x (n 0-7 | 8-15), as K in flash attention.
  const bf16* crow = cs + (warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * rsb + 8 * (lane >> 4);
  const int boff = ((lane & 7) + 8 * (lane >> 4)) * rsb + 8 * ((lane >> 3) & 1);

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = it * kT, stg = it & 1;
    repro::cp_async_wait<0>();
    __syncthreads();  // tile it is in; the previous step's reads are done
    split_tile<P>(xhi, xlo, xf, nullptr, false, 0.f, j0, q);
    __syncthreads();  // split tiles written; xf free
    if (it + 1 < n_tiles) {
      load_bc<kT>(bs + (stg ^ 1) * kT * rsb, rsb, bb, s.bm[2], j0 + kT, q, 0, n16, n, vec_bc);
      load_key_tile<P>(xf, cj + (stg ^ 1) * kT, xh, ch, s, j0 + kT, q, vec_x);
      repro::cp_async_commit();
    }
    const bf16* bt = bs + stg * kT * rsb;
    const float* cjt = cj + stg * kT;
    // Key blocks of 16 up to the one that holds the warp's last row; none
    // where all its rows lie past q.
    const int first_row = i0 + 16 * warp, last_row = min(first_row + 15, q - 1);
    const int jc_end =
        last_row < max(j0, first_row) ? 0 : min(kT / 16, (last_row - j0) / 16 + 1);

    // Per block of 16 keys (up to jc_end): the scores C_i . B_j of the warp's
    // 16 rows, M = scores * exp(cum_i - cum_j) where j <= i < q, else 0 (the
    // exponent is masked first), and acc += M.xdt with M and xdt as hi + lo,
    // three products.
#pragma unroll
    for (int jc = 0; jc < kT / 16; ++jc) {
      if (jc < jc_end) {
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int kk = 0; kk < n16 / 16; ++kk) {
          uint32_t cf[4], bf[4];
          repro::ldmatrix_x4(cf, crow + kk * 16);
          repro::ldmatrix_x4(bf, bt + boff + jc * 16 * rsb + kk * 16);
          repro::mma_bf16_16816(sc[0], cf, bf[0], bf[1]);
          repro::mma_bf16_16816(sc[1], cf, bf[2], bf[3]);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 cjv = *reinterpret_cast<const float2*>(cjt + jc * 16 + hf * 8 + 2 * quad);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib;
            const int j = j0 + jc * 16 + hf * 8 + 2 * quad + (e & 1);
            const bool ok = j <= i && i < q;
            const float d = ok ? (e < 2 ? cia : cib) - ((e & 1) ? cjv.y : cjv.x) : 0.f;
            sc[hf][e] = ok ? sc[hf][e] * exp2f(d * kLog2e) : 0.f;
          }
        }
        uint32_t mh[4], ml[4];
        repro::split_bf16(sc[0][0], sc[0][1], mh[0], ml[0]);
        repro::split_bf16(sc[0][2], sc[0][3], mh[1], ml[1]);
        repro::split_bf16(sc[1][0], sc[1][1], mh[2], ml[2]);
        repro::split_bf16(sc[1][2], sc[1][3], mh[3], ml[3]);
#pragma unroll
        for (int d2 = 0; d2 < P / 16; ++d2) {
          uint32_t fh[4], fl[4];
          repro::ldmatrix_x4_trans(fh, xhi + xoff + jc * 16 * RSX + d2 * 16);
          repro::ldmatrix_x4_trans(fl, xlo + xoff + jc * 16 * RSX + d2 * 16);
          repro::mma_bf16_16816(acc[2 * d2], mh, fh[0], fh[1]);
          repro::mma_bf16_16816(acc[2 * d2 + 1], mh, fh[2], fh[3]);
          repro::mma_bf16_16816(acc[2 * d2], ml, fh[0], fh[1]);
          repro::mma_bf16_16816(acc[2 * d2 + 1], ml, fh[2], fh[3]);
          repro::mma_bf16_16816(acc[2 * d2], mh, fl[0], fl[1]);
          repro::mma_bf16_16816(acc[2 * d2 + 1], mh, fl[2], fl[3]);
        }
      }
    }
  }

  float* yb = y + b * s.y[0] + c * s.y[1] + h * s.y[2] + 2 * quad;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    if (ia < q)
      *reinterpret_cast<float2*>(yb + ia * s.y[3] + k * 8) = make_float2(acc[k][0], acc[k][1]);
    if (ib < q)
      *reinterpret_cast<float2*>(yb + ib * s.y[3] + k * 8) = make_float2(acc[k][2], acc[k][3]);
  }
}

// ---------------------------------------------------------------------------
// f32 B and C: CUDA cores
// ---------------------------------------------------------------------------

constexpr int kThreads32 = 256;  // 16 x 16; a thread owns rows ty + 16r and columns tx + 16c
constexpr int kLdM = kT + 1;     // padded row of the masked score tile

template <int P>
size_t smem_bytes_f32(int n) {
  // B and C rows padded to an odd number of words, so the 16 rows a warp
  // reads at one n fall in distinct banks.
  return sizeof(float) * (kT * P + kT * kLdM + kT + 2 * kT * (n + 1));
}

// Rows r0..r0+kT-1 of a (Q, N) matrix into dst[row][ld]; rows at or past q are zero.
__device__ __forceinline__ void load_rows_f32(float* __restrict__ dst,
                                              const float* __restrict__ src,
                                              long long stride_q, int r0, int q, int n, int ld) {
  for (int i = threadIdx.x; i < kT * n; i += blockDim.x) {
    const int row = i / n, k = i % n;
    dst[row * ld + k] = r0 + row < q ? src[(r0 + row) * stride_q + k] : 0.f;
  }
}

// Rows r0..r0+kT-1 of xdt (Q, P) into dst[row][P]; rows at or past q are zero.
template <int P>
__device__ __forceinline__ void load_x_f32(float* __restrict__ dst, const float* __restrict__ src,
                                           long long stride_q, int r0, int q) {
  for (int i = threadIdx.x; i < kT * P; i += blockDim.x) {
    const int row = i / P, p = i % P;
    dst[i] = r0 + row < q ? src[(r0 + row) * stride_q + p] : 0.f;
  }
}

template <int P>
__global__ void __launch_bounds__(kThreads32)
ssd_f32_kernel(const float* __restrict__ xdt, const float* __restrict__ cum,
               const float* __restrict__ bm, const float* __restrict__ cm,
               float* __restrict__ y, float* __restrict__ st, int n_chunks, int q, int n,
               int row_tiles, Strides s) {
  constexpr int PC = P / 16;  // output columns per thread
  extern __shared__ __align__(16) float smem[];
  const int ldb = n + 1;
  float* xs = smem;           // [kT][P]   xdt of the key tile
  float* ms = xs + kT * P;    // [kT][kLdM] masked scores
  float* cs_j = ms + kT * kLdM;  // [kT]   cum (role 1) or weight (role 2)
  float* cs = cs_j + kT;      // [kT][ldb] C of the output rows
  float* bs = cs + kT * ldb;  // [kT][ldb] B of the key tile

  const int tile = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks;
  const int c = blockIdx.z % n_chunks;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const float* xh = xdt + b * s.xdt[0] + c * s.xdt[1] + h * s.xdt[2];
  const float* ch = cum + b * s.cum[0] + c * s.cum[1] + h * s.cum[2];
  const float* bb = bm + b * s.bm[0] + c * s.bm[1];
  const float* cb = cm + b * s.cm[0] + c * s.cm[1];

  float acc[4][PC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int k = 0; k < PC; ++k) acc[r][k] = 0.f;

  if (tile < row_tiles) {
    // Role 1: output rows i0 .. i0 + 63.
    const int i0 = tile * kT;
    load_rows_f32(cs, cb, s.cm[2], i0, q, n, ldb);
    float ci[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      ci[r] = i < q ? ch[i * s.cum[3]] : 0.f;
    }
    for (int j0 = 0; j0 <= i0; j0 += kT) {  // key tiles up to the diagonal one
      __syncthreads();  // the previous key tile is no longer read
      load_rows_f32(bs, bb, s.bm[2], j0, q, n, ldb);
      load_x_f32<P>(xs, xh, s.xdt[3], j0, q);
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
        for (int r = 0; r < 4; ++r) a[r] = cs[(ty + 16 * r) * ldb + k];
#pragma unroll
        for (int u = 0; u < 4; ++u) bv[u] = bs[(tx + 16 * u) * ldb + k];
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
      load_rows_f32(bs, bb, s.bm[2], j0, q, n, ldb);
      load_x_f32<P>(xs, xh, s.xdt[3], j0, q);
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
          bv[r] = k < n ? bs[jj * ldb + k] * w : 0.f;
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

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Raise a kernel's dynamic shared memory limit to ``smem`` bytes where needed.
template <typename K>
int allow_smem(K kernel, size_t smem, size_t& configured) {
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  return 0;
}

template <int P>
int launch_p(bool bf16_bc, const void* xdt, const void* cum, const void* bm, const void* cm,
             void* y, void* st, int b, int nc, int h, int q, int n, const Strides& s,
             cudaStream_t stream) {
  const int state_tiles = (n + kT - 1) / kT;
  const float* xp = static_cast<const float*>(xdt);
  const float* cp = static_cast<const float*>(cum);
  if (bf16_bc) {
    static size_t configured = 0;  // bytes the attribute was last raised to
    const size_t smem = Bf16Smem<P>::bytes(n);
    if (const int err = allow_smem(ssd_bf16_kernel<P>, smem, configured)) return err;
    bool vec_x = repro::aligned16(xdt), vec_bc = n % 8 == 0 && repro::aligned16(bm) &&
                                                 repro::aligned16(cm);
    for (int i = 0; i < 4; ++i) vec_x = vec_x && s.xdt[i] % 4 == 0;
    for (int i = 0; i < 3; ++i) vec_bc = vec_bc && s.bm[i] % 8 == 0 && s.cm[i] % 8 == 0;
    const int row_tiles = (q + kRows - 1) / kRows;
    const dim3 grid(row_tiles + state_tiles, h, b * nc);
    ssd_bf16_kernel<P><<<grid, kThreads, smem, stream>>>(
        xp, cp, static_cast<const bf16*>(bm), static_cast<const bf16*>(cm),
        static_cast<float*>(y), static_cast<float*>(st), nc, q, n, row_tiles, state_tiles,
        vec_x, vec_bc, s);
  } else {
    static size_t configured = 0;
    const size_t smem = smem_bytes_f32<P>(n);
    if (const int err = allow_smem(ssd_f32_kernel<P>, smem, configured)) return err;
    const int row_tiles = (q + kT - 1) / kT;
    const dim3 grid(row_tiles + state_tiles, h, b * nc);
    ssd_f32_kernel<P><<<grid, kThreads32, smem, stream>>>(
        xp, cp, static_cast<const float*>(bm), static_cast<const float*>(cm),
        static_cast<float*>(y), static_cast<float*>(st), nc, q, n, row_tiles, s);
  }
  return static_cast<int>(cudaGetLastError());
}

int launch(bool bf16_bc, const void* xdt, const void* cum, const void* bm, const void* cm,
           void* y, void* st, int b, int nc, int h, int q, int p, int n,
           const long long* strides, cudaStream_t stream) {
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
    case 32: return launch_p<32>(bf16_bc, xdt, cum, bm, cm, y, st, b, nc, h, q, n, s, stream);
    case 64: return launch_p<64>(bf16_bc, xdt, cum, bm, cm, y, st, b, nc, h, q, n, s, stream);
    case 128: return launch_p<128>(bf16_bc, xdt, cum, bm, cm, y, st, b, nc, h, q, n, s, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// xdt (B,NC,H,Q,P) and cum (B,NC,H,Q) f32, B/C (B,NC,Q,N) of the entry's
// type, y (B,NC,H,Q,P) f32 (unit stride over P), states (B,NC,H,N,P) f32
// contiguous. strides: 18 element strides, in the order xdt b, c, h, q;
// cum b, c, h, q; B b, c, q; C b, c, q; y b, c, h, q.
#define REPRO_SSD_ENTRY(NAME, BF16)                                                         \
  extern "C" int NAME(const void* xdt, const void* cum, const void* bm, const void* cm,     \
                      void* y, void* st, int b, int nc, int h, int q, int p, int n,         \
                      const long long* strides, void* stream) {                             \
    return launch(BF16, xdt, cum, bm, cm, y, st, b, nc, h, q, p, n, strides,                \
                  static_cast<cudaStream_t>(stream));                                       \
  }

REPRO_SSD_ENTRY(repro_ssd_intra_chunk_f32, false)
REPRO_SSD_ENTRY(repro_ssd_intra_chunk_bf16, true)
