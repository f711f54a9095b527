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
// storage type. The exponent is masked to j <= i < Q before exp, so the
// upper triangle cannot overflow into inf * 0 = NaN; rows and keys past Q
// are masked, so any Q works.
//
// Bound on the H100: bytes, for bf16. At the zamba2 serve shape (B 4, NC 2,
// H 80, Q 256, P 64, N 64) the function moves about 95 MB (28 us at 3.35
// TB/s: xdt in and y out, f32, are 42 MB each) against 4.1 GFLOP of
// products (4 us at the 989 TFLOP/s bf16 tensor-core rate, counting each
// product once and the scores once per chunk; the kernel does about 16
// GFLOP with the split terms and the scores per head, so the tensor cores
// are not idle either). On the f32 CUDA cores the same 4.1 GFLOP would take
// 61 us at 67 TFLOP/s.
//
// bf16 B and C (the served type), for Hopper (sm_90a): the shape of K2
// (flash_attention.cu), with C for Q, B for K and xdt for V. A CTA owns 128
// rows of one (b, chunk, head): two consumer warpgroups of 64 rows and one
// warpgroup that feeds them. The last row tile's CTA, which walks every key
// tile anyway, also computes the chunk's state; grid x runs from it to the
// first.
//  - One producer thread loads the CTA's C rows once and, per key tile of
//    64, the f32 xdt tile (through the model's strided view, a 5-D tensor
//    map) and the B tile by TMA into a ring of three stages; B and C arrive
//    as boxes of 64 columns of N (N rounded up to 64, the rest zeros) with
//    the 128-byte swizzle. Each stage has a full barrier (the TMA bytes), a
//    ready barrier (the split) and an empty one (the consumers' warps).
//  - Three splitter warps turn each stage's f32 xdt into two bf16 tiles hi
//    + lo (and, in the state's CTA, w.xdt with w_j = exp(cum_last - cum_j)
//    into two more), written with TMA's swizzle so that wgmma reads them as
//    the transposed (MN-major) B operand, and copy the tile's cum (loaded a
//    tile ahead); they run up to three tiles ahead of the consumers, so the
//    split stalls no consumer at a barrier of the CTA.
//  - A consumer warpgroup forms S = C.B^T for its 64 rows against each key
//    tile up to its diagonal (wgmma m64n64k16, both operands K-major from
//    swizzled shared memory), exact up to summation order since B and C
//    are bf16; scales the accumulator fragments by exp2 of the masked
//    exponent (cum_i - cum_j) times log2(e) (no mask on a tile wholly below
//    the diagonal); splits M into hi = bf16(M) and lo = bf16(M - hi) in
//    registers; and adds Mh.Xh + Ml.Xh + Mh.Xl by wgmma with M from
//    registers (m64nPk16). The 1e-4 tolerance needs the split: M rounded
//    once misses it.
//  - The state: warpgroup w of the last CTA owns state rows 64w .. 64w + 63
//    (N up to 128) and adds B^T.Wh + B^T.Wl per key tile, A = B^T read from
//    the B tile through a transposed (MN-major) descriptor, B = the split
//    w.xdt tiles, in the commit group of the tile's M.X.
//  - y (f32) leaves from the accumulators as float2 stores, each warp's
//    store covering whole 32-byte sectors of its rows.
// What bounds it, measured on an H100 at zamba2's shape (the ABLATIONS of
// benchmarks/torch_kernel_variants.py, each dropping one part): the parts'
// times add up (M.X's products, the split, the decay, the y store, the
// scores, the state), so one CTA an SM (up to 232,016 bytes of shared
// memory, at N 128) runs them with little overlap. Software-pipelining the
// consumers as K2's, starting warpgroup 1 half a tile after warpgroup 0, a
// loop over several heads a CTA (the ring running into the next head) and
// pairing short with long row blocks in one CTA each measured slower. (The
// earlier mma.sync design measured 2 to 8 heads grouped in one CTA, the
// scores shared, 7 to 47 % slower; not tried on this one.)
//
// f32 B and C (checks of the f32 model, no serve path): the products stay on
// the CUDA cores in f32, 64-row tiles, one scalar at a time from shared
// memory, 256 threads a CTA.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kT = 64;  // keys of a key tile; rows of a consumer warpgroup and of an f32 tile
constexpr int kMaxN = 128;

struct Strides {
  long long xdt[4];  // b, chunk, head, q (unit stride over P)
  long long cum[4];  // b, chunk, head, q
  long long bm[3];   // b, chunk, q (unit stride over N)
  long long cm[3];
  long long y[4];    // b, chunk, head, q (unit stride over P)
};

// ---------------------------------------------------------------------------
// bf16 B and C: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kStages = 3;
constexpr int kThreads = 384;  // consumer warpgroups 0 and 1, then the feeder
constexpr int kSplitters = 96; // warps 9..11
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory for head dim P and nbox boxes of 64 columns of N, from a
// 1024-byte-aligned base: C [nbox][128 rows][128 B]; the stages, each the
// f32 xdt tile [64][P], the B tile [nbox][64][128 B] and the split tiles
// Xh, Xl, Wh, Wl [64][2P bytes]; the stages' cum and (state) weights
// [kStages][64] f32 each; then the barriers full, ready, empty [kStages]
// and c_full.
template <int P>
struct Smem {
  static constexpr int ROWP = 2 * P;                       // bytes of a split tile's row
  static constexpr uint32_t MASKP = P == 64 ? 7 : 3;       // its swizzle's lines (128 / 64 B)
  static constexpr int SPLIT = kT * ROWP;
  static constexpr int XRAW = kT * P * 4;
  static constexpr int BBOX = kT * 128, CBOX = 2 * kT * 128;
  int nbox, stage, c_bytes, bytes;
  __host__ __device__ explicit Smem(int n)
      : nbox((n + 63) / 64), stage(XRAW + nbox * BBOX + 4 * SPLIT), c_bytes(nbox * CBOX),
        bytes(1024 + c_bytes + kStages * stage + 2 * kStages * kT * 4 + 8 * (3 * kStages + 1)) {}
  // Offsets from the base.
  __host__ __device__ int xraw(int s) const { return c_bytes + s * stage; }
  __host__ __device__ int bt(int s) const { return xraw(s) + XRAW; }
  __host__ __device__ int split(int s, int k) const { return bt(s) + nbox * BBOX + k * SPLIT; }
  __host__ __device__ int cum(int s) const { return c_bytes + kStages * stage + s * kT * 4; }
  __host__ __device__ int weight(int s) const { return cum(kStages + s); }
  __host__ __device__ int bars() const { return cum(2 * kStages); }
};

template <int P>
__global__ void __launch_bounds__(kThreads, 1)
ssd_bf16_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap bmap,
                const __grid_constant__ CUtensorMap cmap, const float* __restrict__ cum,
                float* __restrict__ y, float* __restrict__ st, int n_chunks, int q, int n,
                int row_tiles, Strides s) {
  using S = Smem<P>;
  const S sm(n);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024u - (repro::smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t sbase = repro::smem_u32(base);
  const uint32_t bars = sbase + sm.bars();
  auto full = [&](int i) { return bars + 8 * (i % kStages); };
  auto ready = [&](int i) { return bars + 8 * (kStages + i % kStages); };
  auto empty = [&](int i) { return bars + 8 * (2 * kStages + i % kStages); };
  const uint32_t c_full = bars + 8 * 3 * kStages;

  const int rt = row_tiles - 1 - static_cast<int>(blockIdx.x);  // the last tile first
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_chunks, c = blockIdx.z % n_chunks;
  const bool state = rt == row_tiles - 1;
  const int n_tiles = (min(2 * kT * (rt + 1), q) + kT - 1) / kT;
  const float* ch = cum + b * s.cum[0] + c * s.cum[1] + h * s.cum[2];

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int warp = tid >> 5, lane = tid & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      repro::mbar_init(full(i), 1);
      repro::mbar_init(ready(i), kSplitters);
      repro::mbar_init(empty(i), 8);
    }
    repro::mbar_init(c_full, 1);
    repro::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    if (warp == 0) {
      // Producer: one thread issues every load: the CTA's C rows once (a
      // second block of 64 only where a row of it is below q), then per key
      // tile the f32 xdt tile and the B tile.
      if (lane == 0) {
        const int c_rows = 2 * kT * rt + kT < q ? 2 : 1;
        repro::mbar_arrive_expect_tx(c_full, sm.nbox * c_rows * S::BBOX);
        for (int k = 0; k < sm.nbox; ++k)
          for (int r = 0; r < c_rows; ++r)
            repro::tma_load_4d(sbase + k * S::CBOX + r * S::BBOX, &cmap, c_full, 64 * k,
                               2 * kT * rt + kT * r, c, b);
        for (int it = 0; it < n_tiles; ++it) {
          if (it >= kStages) repro::mbar_wait(empty(it), (it / kStages - 1) & 1);
          const int stg = it % kStages;
          repro::mbar_arrive_expect_tx(full(it), S::XRAW + sm.nbox * S::BBOX);
          repro::tma_load_5d(sbase + sm.xraw(stg), &xmap, full(it), 0, h, it * kT, c, b);
          for (int k = 0; k < sm.nbox; ++k)
            repro::tma_load_4d(sbase + sm.bt(stg) + k * S::BBOX, &bmap, full(it), 64 * k, it * kT,
                               c, b);
        }
      }
      return;
    }
    // Splitters: xdt (and w.xdt) of each landed tile as bf16 hi + lo, in the
    // swizzled layout of a transposed wgmma operand; the tile's cum, loaded
    // a tile ahead, and in the state's CTA the tile's weights w_j.
    const int sp = threadIdx.x - 288;
    const float last = state ? ch[(q - 1) * s.cum[3]] : 0.f;
    auto cum_at = [&](int it) {
      const int j = it * kT + sp;
      return sp < kT && j < q ? ch[j * s.cum[3]] : 0.f;
    };
    float cj_next = cum_at(0);
    for (int it = 0; it < n_tiles; ++it) {
      const int stg = it % kStages, j0 = it * kT;
      const float cj = cj_next;
      cj_next = cum_at(it + 1);
      repro::mbar_wait(full(it), (it / kStages) & 1);
      float* cs = reinterpret_cast<float*>(base + sm.cum(stg));
      float* ws = reinterpret_cast<float*>(base + sm.weight(stg));
      if (sp < kT) {
        cs[sp] = cj;
        if (state) ws[sp] = j0 + sp < q ? expf(last - cj) : 0.f;
      }
      if (state) asm volatile("bar.sync 1, 96;\n" ::: "memory");  // ws is whole
      const float* xf = reinterpret_cast<const float*>(base + sm.xraw(stg));
      for (int i = sp; i < kT * P / 4; i += kSplitters) {
        const int r = i / (P / 4), c4 = i % (P / 4) * 4;
        float4 v = *reinterpret_cast<const float4*>(xf + r * P + c4);
        const uint32_t off = repro::swizzle(r * S::ROWP + c4 * 2, S::MASKP);
        uint32_t h0, l0, h1, l1;
        repro::split_bf16(v.x, v.y, h0, l0);
        repro::split_bf16(v.z, v.w, h1, l1);
        *reinterpret_cast<uint2*>(base + sm.split(stg, 0) + off) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(base + sm.split(stg, 1) + off) = make_uint2(l0, l1);
        if (state) {
          const float w = ws[r];
          repro::split_bf16(v.x * w, v.y * w, h0, l0);
          repro::split_bf16(v.z * w, v.w * w, h1, l1);
          *reinterpret_cast<uint2*>(base + sm.split(stg, 2) + off) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(base + sm.split(stg, 3) + off) = make_uint2(l0, l1);
        }
      }
      repro::fence_proxy_async();
      repro::mbar_arrive(ready(it));
    }
    return;
  }

  // Consumers: warpgroup wg owns rows 64 rb .. 64 rb + 63; warp w of it the
  // rows of its accumulator fragments, ia and ib.
  const int rb = 2 * rt + wg;
  const bool rows = kT * rb < q;
  const int group = lane >> 2, quad = lane & 3;
  const int ia = kT * rb + 16 * warp + group, ib = ia + 8;
  const float cia = ia < q ? ch[ia * s.cum[3]] : 0.f;
  const float cib = ib < q ? ch[ib * s.cum[3]] : 0.f;
  const bool owns_state = state && kT * wg < n;
  const uint32_t c_tile = sbase + kT * wg * 128;
  float sacc[kT / 2], yacc[P / 2], sta[P / 2];
  uint32_t mh[kT / 16][4], ml[kT / 16][4];  // M of a tile, as hi + lo A fragments
#pragma unroll
  for (int i = 0; i < P / 2; ++i) yacc[i] = sta[i] = 0.f;
  if (rows) repro::mbar_wait(c_full, 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int stg = it % kStages, j0 = it * kT;
    repro::mbar_wait(ready(it), (it / kStages) & 1);
    const uint32_t bt = sbase + sm.bt(stg);
    if (rows && it <= rb) {
      // S = C.B^T for this warpgroup's 64 rows.
      repro::fence_regs(sacc);
      repro::wgmma_fence();
      for (int ks = 0; ks < 4 * sm.nbox; ++ks) {
        const int k = ks / 4, off = ks % 4 * 32;
        repro::wgmma_ss<kT>(sacc, repro::gmma_desc(c_tile + k * S::CBOX + off, 16, 1024, 1),
                            repro::gmma_desc(bt + k * S::BBOX + off, 16, 1024, 1), ks > 0);
      }
      repro::wgmma_commit();
      repro::wgmma_wait<0>();
      repro::fence_regs(sacc);
      // M = S * exp(cum_i - cum_j) where j <= i < q, else 0 (the exponent is
      // masked first); a tile wholly below the diagonal, of rows below q,
      // needs no mask. Then M as hi + lo fragments: slice j of keys 16j ..
      // 16j + 15 holds S blocks 2j and 2j + 1.
      const float* cs = reinterpret_cast<const float*>(base + sm.cum(stg));
      if (it < rb && kT * (rb + 1) <= q) {
#pragma unroll
        for (int nb = 0; nb < kT / 8; ++nb) {
          const float2 cj = *reinterpret_cast<const float2*>(cs + 8 * nb + 2 * quad);
          sacc[4 * nb] *= exp2f((cia - cj.x) * kLog2e);
          sacc[4 * nb + 1] *= exp2f((cia - cj.y) * kLog2e);
          sacc[4 * nb + 2] *= exp2f((cib - cj.x) * kLog2e);
          sacc[4 * nb + 3] *= exp2f((cib - cj.y) * kLog2e);
        }
      } else {
#pragma unroll
        for (int nb = 0; nb < kT / 8; ++nb) {
          const float2 cj = *reinterpret_cast<const float2*>(cs + 8 * nb + 2 * quad);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib, j = j0 + 8 * nb + 2 * quad + (e & 1);
            const bool ok = j <= i && i < q;
            const float d = ok ? (e < 2 ? cia : cib) - ((e & 1) ? cj.y : cj.x) : 0.f;
            sacc[4 * nb + e] = ok ? sacc[4 * nb + e] * exp2f(d * kLog2e) : 0.f;
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < kT / 8; ++nb) {
        const int ks = nb / 2, r = 2 * (nb % 2);
        repro::split_bf16(sacc[4 * nb], sacc[4 * nb + 1], mh[ks][r], ml[ks][r]);
        repro::split_bf16(sacc[4 * nb + 2], sacc[4 * nb + 3], mh[ks][r + 1], ml[ks][r + 1]);
      }
      // Y += Mh.Xh + Ml.Xh + Mh.Xl.
      repro::fence_regs(yacc);
      repro::fence_regs(mh);
      repro::fence_regs(ml);
      repro::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks) {
        const uint32_t row = ks * 16 * S::ROWP;
        const uint64_t xh = repro::gmma_desc(sbase + sm.split(stg, 0) + row, S::SPLIT,
                                             8 * S::ROWP, P == 64 ? 1 : 2);
        const uint64_t xl = repro::gmma_desc(sbase + sm.split(stg, 1) + row, S::SPLIT,
                                             8 * S::ROWP, P == 64 ? 1 : 2);
        repro::wgmma_rs_tb<P>(yacc, mh[ks], xh);
        repro::wgmma_rs_tb<P>(yacc, ml[ks], xh);
        repro::wgmma_rs_tb<P>(yacc, mh[ks], xl);
      }
    }
    if (owns_state) {
      // S += B^T.(w xdt) over the tile's keys, in M.X's group where there is
      // one: A = B^T (state rows 64 wg .. + 63, box wg of the B tile)
      // through a transposed descriptor.
      repro::fence_regs(sta);
      repro::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kT / 16; ++ks) {
        const uint64_t a = repro::gmma_desc(bt + wg * S::BBOX + ks * 16 * 128, S::BBOX, 1024, 1);
        const uint32_t row = ks * 16 * S::ROWP;
        repro::wgmma_ss_tt<P>(sta, a, repro::gmma_desc(sbase + sm.split(stg, 2) + row, S::SPLIT,
                                                      8 * S::ROWP, P == 64 ? 1 : 2));
        repro::wgmma_ss_tt<P>(sta, a, repro::gmma_desc(sbase + sm.split(stg, 3) + row, S::SPLIT,
                                                      8 * S::ROWP, P == 64 ? 1 : 2));
      }
    }
    repro::wgmma_commit();
    repro::wgmma_wait<0>();
    repro::fence_regs(yacc);
    repro::fence_regs(sta);
    repro::fence_regs(mh);
    repro::fence_regs(ml);
    __syncwarp();
    if (lane == 0) repro::mbar_arrive(empty(it));  // this warp is done with the stage
  }

  if (rows) {
    float* yb = y + b * s.y[0] + c * s.y[1] + h * s.y[2] + 2 * quad;
#pragma unroll
    for (int k = 0; k < P / 8; ++k) {
      if (ia < q)
        *reinterpret_cast<float2*>(yb + ia * s.y[3] + k * 8) = make_float2(yacc[4 * k], yacc[4 * k + 1]);
      if (ib < q)
        *reinterpret_cast<float2*>(yb + ib * s.y[3] + k * 8) =
            make_float2(yacc[4 * k + 2], yacc[4 * k + 3]);
    }
  }
  if (owns_state) {
    const long long head = (static_cast<long long>(b) * n_chunks + c) * gridDim.y + h;
    const int na = kT * wg + 16 * warp + group, nb = na + 8;
    float* sa = st + (head * n + na) * P + 2 * quad;
#pragma unroll
    for (int k = 0; k < P / 8; ++k) {
      if (na < n) *reinterpret_cast<float2*>(sa + k * 8) = make_float2(sta[4 * k], sta[4 * k + 1]);
      if (nb < n)
        *reinterpret_cast<float2*>(sa + 8 * P + k * 8) = make_float2(sta[4 * k + 2], sta[4 * k + 3]);
    }
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

// Tensor maps of the bf16 kernel: xdt (P, H, Q, NC, B) f32 in boxes of (P,
// 1, 64, 1, 1), unswizzled; B and C (N, Q, NC, B) in boxes of (64, 64, 1,
// 1) with the 128-byte swizzle.
bool encode_maps(CUtensorMap* xm, CUtensorMap* bmp, CUtensorMap* cmp, const void* xdt,
                 const void* bm, const void* cm, int b, int nc, int h, int q, int p, int n,
                 const Strides& s) {
  const cuuint64_t xdims[5] = {static_cast<cuuint64_t>(p), static_cast<cuuint64_t>(h),
                               static_cast<cuuint64_t>(q), static_cast<cuuint64_t>(nc),
                               static_cast<cuuint64_t>(b)};
  const cuuint64_t xstrides[4] = {static_cast<cuuint64_t>(s.xdt[2]) * 4,
                                  static_cast<cuuint64_t>(s.xdt[3]) * 4,
                                  static_cast<cuuint64_t>(s.xdt[1]) * 4,
                                  static_cast<cuuint64_t>(s.xdt[0]) * 4};
  const cuuint32_t xbox[5] = {static_cast<cuuint32_t>(p), 1u, static_cast<cuuint32_t>(kT), 1u, 1u};
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(n), static_cast<cuuint64_t>(q),
                              static_cast<cuuint64_t>(nc), static_cast<cuuint64_t>(b)};
  const cuuint64_t bstrides[3] = {static_cast<cuuint64_t>(s.bm[2]) * 2,
                                  static_cast<cuuint64_t>(s.bm[1]) * 2,
                                  static_cast<cuuint64_t>(s.bm[0]) * 2};
  const cuuint64_t cstrides[3] = {static_cast<cuuint64_t>(s.cm[2]) * 2,
                                  static_cast<cuuint64_t>(s.cm[1]) * 2,
                                  static_cast<cuuint64_t>(s.cm[0]) * 2};
  const cuuint32_t bbox[4] = {64u, static_cast<cuuint32_t>(kT), 1u, 1u};
  const cuuint32_t cbox[4] = {64u, static_cast<cuuint32_t>(kT), 1u, 1u};
  return repro::encode_map(xm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 5, xdt, xdims, xstrides, xbox, 0) &&
         repro::encode_map(bmp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, bm, dims, bstrides, bbox,
                           128) &&
         repro::encode_map(cmp, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, cm, dims, cstrides, cbox,
                           128);
}

template <int P>
int launch_bf16(const void* xdt, const void* cum, const void* bm, const void* cm, void* y,
                void* st, int b, int nc, int h, int q, int n, const Strides& s,
                cudaStream_t stream) {
  static size_t configured = 0;  // bytes the attribute was last raised to
  const size_t smem = Smem<P>(n).bytes;
  if (const int err = allow_smem(ssd_bf16_kernel<P>, smem, configured)) return err;
  if (repro::tensor_map_encoder() == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  bool tma = repro::aligned16(xdt) && repro::aligned16(bm) && repro::aligned16(cm);
  for (int i = 0; i < 4; ++i) tma = tma && s.xdt[i] % 4 == 0;
  for (int i = 0; i < 3; ++i) tma = tma && s.bm[i] % 8 == 0 && s.cm[i] % 8 == 0;
  if (!tma) return static_cast<int>(cudaErrorMisalignedAddress);  // TMA: 16-byte units
  CUtensorMap xm, bmp, cmp;
  if (!encode_maps(&xm, &bmp, &cmp, xdt, bm, cm, b, nc, h, q, P, n, s))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (q + 2 * kT - 1) / (2 * kT);
  const dim3 grid(row_tiles, h, b * nc);
  ssd_bf16_kernel<P><<<grid, kThreads, smem, stream>>>(
      xm, bmp, cmp, static_cast<const float*>(cum), static_cast<float*>(y),
      static_cast<float*>(st), nc, q, n, row_tiles, s);
  return static_cast<int>(cudaGetLastError());
}

template <int P>
int launch_f32(const void* xdt, const void* cum, const void* bm, const void* cm, void* y,
               void* st, int b, int nc, int h, int q, int n, const Strides& s,
               cudaStream_t stream) {
  static size_t configured = 0;
  const size_t smem = smem_bytes_f32<P>(n);
  if (const int err = allow_smem(ssd_f32_kernel<P>, smem, configured)) return err;
  const int row_tiles = (q + kT - 1) / kT;
  const dim3 grid(row_tiles + (n + kT - 1) / kT, h, b * nc);
  ssd_f32_kernel<P><<<grid, kThreads32, smem, stream>>>(
      static_cast<const float*>(xdt), static_cast<const float*>(cum),
      static_cast<const float*>(bm), static_cast<const float*>(cm), static_cast<float*>(y),
      static_cast<float*>(st), nc, q, n, row_tiles, s);
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
#define REPRO_CASE(P)                                                                   \
  case P:                                                                               \
    return bf16_bc ? launch_bf16<P>(xdt, cum, bm, cm, y, st, b, nc, h, q, n, s, stream) \
                   : launch_f32<P>(xdt, cum, bm, cm, y, st, b, nc, h, q, n, s, stream);
  switch (p) {
    REPRO_CASE(32)
    REPRO_CASE(64)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_CASE
}

}  // namespace

// xdt (B,NC,H,Q,P) and cum (B,NC,H,Q) f32, B/C (B,NC,Q,N) of the entry's
// type, y (B,NC,H,Q,P) f32 (unit stride over P), states (B,NC,H,N,P) f32
// contiguous; P 32 or 64, N up to 128. strides: 18 element strides, in the
// order xdt b, c, h, q; cum b, c, h, q; B b, c, q; C b, c, q; y b, c, h, q.
// For bf16 B/C, xdt, B and C must start on 16 bytes and their strides be
// whole 16 bytes (TMA).
#define REPRO_SSD_ENTRY(NAME, BF16)                                                         \
  extern "C" int NAME(const void* xdt, const void* cum, const void* bm, const void* cm,     \
                      void* y, void* st, int b, int nc, int h, int q, int p, int n,         \
                      const long long* strides, void* stream) {                             \
    return launch(BF16, xdt, cum, bm, cm, y, st, b, nc, h, q, p, n, strides,                \
                  static_cast<cudaStream_t>(stream));                                       \
  }

REPRO_SSD_ENTRY(repro_ssd_intra_chunk_f32, false)
REPRO_SSD_ENTRY(repro_ssd_intra_chunk_bf16, true)
