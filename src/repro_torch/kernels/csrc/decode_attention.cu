// Flash decode: one query token for each head of a grouped-query group
// against a length-masked KV cache, split over the keys (flash-decoding) and
// merged by a second pass; online softmax in f32, optional sliding window
// and logit softcap.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:
// decode_attention_bkgd (_decode_kernel). That kernel takes q (BK,G,D) and
// k/v (BK,T,D), so its JAX wrapper (kernels/ops.py:flash_decode) transposes
// the whole KV cache on every decode step; it also needs T to be a multiple
// of its block, and gets the lengths by scalar prefetch. Its grid walks the
// KV blocks of one (b, kv head) in order on one core.
//
// Bound on the H100: bytes. A step reads the cache rows below each row's
// length once and does 4 * G flops per cache element: 16 flops a byte at
// G = 8 in bf16 and 4 at G = 1, far below the ridge point, so both types
// compute on the CUDA cores. What limits a decode step is how many bytes
// are in flight: at batch 4 there are only B*K = 16 (tinyllama) or 128
// (zamba2) (b, kv head) pairs, so one CTA per pair leaves the card idle.
//
// Pass 1 (decode_split_kernel): one 128-thread CTA per (split, kv head and
// head group, b). The wrapper cuts the cache capacity T into splits of a
// multiple of 64 keys, their count chosen from T and the CTA count, never
// from the lengths (which live on the device). Each CTA reads lengths[b]
// itself, intersects its split with the visible keys [max(0, len - window),
// len), and walks that range in tiles of 64 keys held in a two-stage shared
// ring of the storage type, filled by 16-byte cp.async (keys outside the
// range are zero-filled, never read). Per tile: one thread per (head, key)
// takes the dot product from shared memory with 16-byte reads (rows padded
// by 16 bytes, so the 8 lanes of each read phase hit distinct banks), one
// warp per head updates its running max and sum, then the threads share the
// P.V product over (head, dim pair) and, where that leaves threads over,
// over slices of the tile's keys. The CTA writes (m, l, acc[D]) in f32 to a
// scratch row; a split with no visible key writes m = -1e30, l = 0 and loads
// nothing. Up to 32 query heads share one CTA and its K/V tiles; a larger
// group runs in head groups of 32, each its own CTA.
//
// Pass 2 (decode_combine_kernel), on the same stream: one warp per (b, query
// head) merges the splits' states, out = sum_s e^(m_s - M) acc_s /
// max(sum_s e^(m_s - M) l_s, 1e-30), M the largest m of a split with l > 0.
// A row of length 0 has no such split and gives zeros, as the TPU kernel
// does.
#include "common.cuh"
#include "mma.cuh"

namespace {

using repro::kNeg;
using repro::to_f32;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBK = 64;     // keys per tile
constexpr int kGroup = 32;  // query heads per CTA at most

template <typename T, int D>
struct Dec {
  static constexpr int V = repro::kVec16<T>;  // elements per 16-byte vector
  static constexpr int RS = D + V;            // padded row, elements
  static constexpr int TILE = kBK * RS;
  // Output (head, dim pair) items a thread holds at most: kGroup heads.
  static constexpr int IPT = (kGroup * D / 2 + kThreads - 1) / kThreads;
  static_assert(D % V == 0 && D % 2 == 0, "D must split into 16-byte vectors");
  // Bytes of shared memory for nh heads: two stages of K and V, then the
  // f32 queries, scores, per-head m, l, alpha and the slice partials.
  static int smem_bytes(int nh) {
    return static_cast<int>(4 * TILE * sizeof(T) +
                            sizeof(float) * (nh * D + nh * kBK + 3 * nh + 2 * kThreads));
  }
};

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int t0,
                                          int vlo, int vhi) {
  constexpr int V = Dec<T, D>::V, RS = Dec<T, D>::RS, PER_ROW = D / V;
  for (int i = threadIdx.x; i < kBK * PER_ROW; i += kThreads) {
    const int j = i / PER_ROW, c = (i % PER_ROW) * V;
    const int kp = t0 + j;
    const bool ok = kp >= vlo && kp < vhi;
    const T* s = ok ? src + static_cast<long long>(kp) * stride + c : src;
    repro::cp_async16(dst + j * RS + c, s, ok);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths, float* __restrict__ scratch, int t_len,
                    int n_heads, int g_heads, int n_hg, int n_splits, int split_len,
                    long long q_sb, long long k_sb, long long k_st, long long v_sb,
                    long long v_st, int window, float scale, float softcap) {
  constexpr int RS = Dec<T, D>::RS, TILE = Dec<T, D>::TILE, V = Dec<T, D>::V;
  constexpr int IPT = Dec<T, D>::IPT;
  constexpr int DP = D / 2;  // dim pairs
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);  // [stage][kBK][RS]
  T* vs = ks + 2 * TILE;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_hg, hg = blockIdx.y % n_hg;
  const int b = blockIdx.z;
  const int nh = min(kGroup, g_heads - hg * kGroup);  // heads of this CTA
  const int h0 = kvh * g_heads + hg * kGroup;         // its first query head
  float* qs = reinterpret_cast<float*>(vs + 2 * TILE);  // [nh][D]
  float* ss = qs + nh * D;                              // [nh][kBK] scores, then p
  float* m_s = ss + nh * kBK;
  float* l_s = m_s + nh;
  float* a_s = l_s + nh;
  float* red = a_s + nh;  // [2 * kThreads] slice partials

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), t_len);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int s0 = split * split_len;
  const int vlo = max(s0, lo), vhi = min(min(s0 + split_len, t_len), len);
  // Scratch row of (b, head h0 + g, split): m, l, acc[D].
  float* out = scratch + ((static_cast<long long>(b) * n_heads + h0) * n_splits + split) * (D + 2);
  const long long head_stride = static_cast<long long>(n_splits) * (D + 2);

  if (vlo >= vhi) {
    for (int g = tid; g < nh; g += kThreads) {
      out[g * head_stride] = kNeg;
      out[g * head_stride + 1] = 0.f;
    }
    return;
  }

  const T* kb = k + b * k_sb + static_cast<long long>(kvh) * D;
  const T* vb = v + b * v_sb + static_cast<long long>(kvh) * D;
  const int first = (vlo - s0) / kBK, last = (vhi - 1 - s0) / kBK;
  load_tile<T, D>(ks, kb, k_st, s0 + first * kBK, vlo, vhi);
  load_tile<T, D>(vs, vb, v_st, s0 + first * kBK, vlo, vhi);
  repro::cp_async_commit();

  const T* qb = q + b * q_sb + static_cast<long long>(h0) * D;
  for (int i = tid; i < nh * D; i += kThreads) qs[i] = to_f32(qb[i]);
  for (int g = tid; g < nh; g += kThreads) {
    m_s[g] = kNeg;
    l_s[g] = 0.f;
  }

  // P.V work split: ni (head, dim pair) items; with fewer items than
  // threads, ns slices of the keys each take every ns-th key.
  const int ni = nh * DP;
  const int ns = ni >= kThreads ? 1 : kThreads / ni;
  const int slice = ns == 1 ? 0 : tid / ni;
  const int item0 = ns == 1 ? tid : tid % ni;
  const int step = ns == 1 ? kThreads : ni;
  float acc[IPT][2];
#pragma unroll
  for (int i = 0; i < IPT; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int it = first; it <= last; ++it) {
    const int t0 = s0 + it * kBK;
    const int st = (it - first) & 1;
    if (it < last) {
      load_tile<T, D>(ks + (st ^ 1) * TILE, kb, k_st, t0 + kBK, vlo, vhi);
      load_tile<T, D>(vs + (st ^ 1) * TILE, vb, v_st, t0 + kBK, vlo, vhi);
      repro::cp_async_commit();
      repro::cp_async_wait<1>();
    } else {
      repro::cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = ks + st * TILE;
    const T* vt = vs + st * TILE;

    // Scores: thread per (head, key); a warp's lanes share the head.
    for (int p = tid; p < nh * kBK; p += kThreads) {
      const int g = p / kBK, j = p % kBK, kp = t0 + j;
      float s = kNeg;
      if (kp >= vlo && kp < vhi) {
        const float* qg = qs + g * D;
        const T* kr = kt + j * RS;
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < D; c += V) {
          float f[V];
          repro::load_f32<T, V>(f, kr + c);
#pragma unroll
          for (int e = 0; e < V; ++e) dot += qg[c + e] * f[e];
        }
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      ss[p] = s;
    }
    __syncthreads();

    // Online softmax: warp per head. Every tile holds a visible key.
    for (int g = warp; g < nh; g += kWarps) {
      float sv[kBK / 32];
      float mt = kNeg;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const int j = lane + 32 * i, kp = t0 + j;
        sv[i] = ss[g * kBK + j];
        if (kp >= vlo && kp < vhi) mt = fmaxf(mt, sv[i]);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float mo = m_s[g];
      const float mn = fmaxf(mo, mt);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 32; ++i) {
        const int j = lane + 32 * i, kp = t0 + j;
        const float p = kp >= vlo && kp < vhi ? expf(sv[i] - mn) : 0.f;
        ss[g * kBK + j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float alpha = expf(mo - mn);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + psum;
        m_s[g] = mn;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V over this thread's items and key slice.
    if (slice < ns) {
#pragma unroll
      for (int i = 0; i < IPT; ++i) {
        const int item = item0 + i * step;
        if (item < ni) {
          const int g = item / DP, d = (item % DP) * 2;
          const float alpha = a_s[g];
          float x = acc[i][0] * alpha, y = acc[i][1] * alpha;
          const float* pg = ss + g * kBK;
          const T* vc = vt + d;
          for (int j = slice; j < kBK; j += ns) {
            const float p = pg[j];
            x += p * to_f32(vc[j * RS]);
            y += p * to_f32(vc[j * RS + 1]);
          }
          acc[i][0] = x;
          acc[i][1] = y;
        }
      }
    }
    __syncthreads();  // this stage is reloaded two tiles on
  }

  // Write m, l and the slices' summed acc.
  for (int g = tid; g < nh; g += kThreads) {
    out[g * head_stride] = m_s[g];
    out[g * head_stride + 1] = l_s[g];
  }
  if (ns == 1) {
#pragma unroll
    for (int i = 0; i < IPT; ++i) {
      const int item = item0 + i * step;
      if (item < ni) {
        const int g = item / DP, d = (item % DP) * 2;
        out[g * head_stride + 2 + d] = acc[i][0];
        out[g * head_stride + 3 + d] = acc[i][1];
      }
    }
  } else {
    if (slice < ns) {
      red[2 * tid] = acc[0][0];
      red[2 * tid + 1] = acc[0][1];
    }
    __syncthreads();
    // red[2 * (s * ni + item) + e] holds slice s of dim 2 * (item % DP) + e.
    for (int o = tid; o < 2 * ni; o += kThreads) {
      float x = 0.f;
      for (int sl = 0; sl < ns; ++sl) x += red[2 * sl * ni + o];
      const int g = o / D, d = o % D;
      out[g * head_stride + 2 + d] = x;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_combine_kernel(const float* __restrict__ scratch, T* __restrict__ o, int rows,
                      int n_heads, int n_splits, long long o_sb) {
  constexpr int DL = (D + 31) / 32;  // dims per lane (the last may be partial)
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);  // b * n_heads + h
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* base = scratch + static_cast<long long>(row) * n_splits * (D + 2);
  float mx = kNeg;
  for (int s = 0; s < n_splits; ++s)
    if (base[s * (D + 2) + 1] > 0.f) mx = fmaxf(mx, base[s * (D + 2)]);
  float den = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* st = base + s * (D + 2);
    const float l = st[1];
    if (l > 0.f) {
      const float w = expf(st[0] - mx);
      den += w * l;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        if (D % 32 == 0 || lane + 32 * i < D) acc[i] += w * st[2 + lane + 32 * i];
    }
  }
  const float r = 1.f / fmaxf(den, 1e-30f);
  const int b = row / n_heads, h = row % n_heads;
  T* op = o + b * o_sb + static_cast<long long>(h) * D + lane;
#pragma unroll
  for (int i = 0; i < DL; ++i)
    if (D % 32 == 0 || lane + 32 * i < D) op[32 * i] = repro::from_f32<T>(acc[i] * r);
}

struct Args {
  const void *q, *k, *v, *lengths;
  void *o, *scratch;
  int b, kv, g, t, n_splits, split_len;
  long long st[6];  // q_b, k_b, k_t, v_b, v_t, o_b
  int window;
  float scale, softcap;
};

template <typename T, int D>
int launch_d(const Args& a, cudaStream_t stream) {
  const int n_hg = (a.g + kGroup - 1) / kGroup;
  const int smem = Dec<T, D>::smem_bytes(min(a.g, kGroup));
  static int configured = 0;  // bytes the attribute was last raised to
  if (smem > 48 * 1024 && smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_split_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured = smem;
  }
  const int h = a.kv * a.g;
  const dim3 grid1(a.n_splits, a.kv * n_hg, a.b);
  decode_split_kernel<T, D><<<grid1, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.lengths), static_cast<float*>(a.scratch), a.t, h, a.g, n_hg,
      a.n_splits, a.split_len, a.st[0], a.st[1], a.st[2], a.st[3], a.st[4], a.window, a.scale,
      a.softcap);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = a.b * h;
  decode_combine_kernel<T, D><<<(rows + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      static_cast<const float*>(a.scratch), static_cast<T*>(a.o), rows, h, a.n_splits, a.st[5]);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const Args& a, int d, cudaStream_t stream) {
  if (a.b <= 0 || a.kv <= 0 || a.g <= 0 || a.t <= 0 || a.b > 65535 || a.n_splits <= 0 ||
      a.split_len <= 0 || a.split_len % kBK != 0 ||
      static_cast<long long>(a.n_splits) * a.split_len < a.t ||
      static_cast<long long>(a.kv) * ((a.g + kGroup - 1) / kGroup) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!repro::aligned16(a.k) || !repro::aligned16(a.v))
    return static_cast<int>(cudaErrorMisalignedAddress);
  switch (d) {
    case 32: return launch_d<T, 32>(a, stream);
    case 64: return launch_d<T, 64>(a, stream);
    case 80: return launch_d<T, 80>(a, stream);
    case 96: return launch_d<T, 96>(a, stream);
    case 128: return launch_d<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (B,1,H,D) and o (B,1,H,D) with heads contiguous, k/v (B,T,K,D) with unit
// stride over D and heads D apart, lengths (B,) int32, scratch (B,H,splits,
// D+2) f32 contiguous; strides (in elements) in the order q_b, k_b, k_t,
// v_b, v_t, o_b.
#define REPRO_DECODE_ENTRY(NAME, T)                                                         \
  extern "C" int NAME(const void* q, const void* k, const void* v, const void* lengths,     \
                      void* o, void* scratch, int b, int kv, int g, int t, int d,           \
                      int n_splits, int split_len, long long q_sb, long long k_sb,          \
                      long long k_st, long long v_sb, long long v_st, long long o_sb,       \
                      int window, float scale, float softcap, void* stream) {               \
    const Args a{q, k, v, lengths, o, scratch, b, kv, g, t, n_splits, split_len,            \
                 {q_sb, k_sb, k_st, v_sb, v_st, o_sb}, window, scale, softcap};             \
    return launch<T>(a, d, static_cast<cudaStream_t>(stream));                              \
  }

REPRO_DECODE_ENTRY(repro_decode_attention_f32, float)
REPRO_DECODE_ENTRY(repro_decode_attention_bf16, __nv_bfloat16)
