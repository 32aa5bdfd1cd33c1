// The pieces shared by the two longitude-DFT kernels (dft_analysis.cu,
// dft_synthesis.cu).
//
// fp32 operands ("float32", "tensorfloat"): `fold_rows`, the even/odd fold
// of the real DFT on the CUDA cores, true fp32 FMA (no TF32: "float32"
// means fp32).  The DFT matrices are symmetric in longitude: C[W-w] = C[w],
// S[W-w] = -S[w] (analysis), Ci[:, W-w] = Ci[:, w], Si[:, W-w] = -Si[:, w]
// (synthesis).  So over the kh = W/2 + 1 longitudes 0 <= w <= W/2
//   analysis:  u_w = x_w + x_{W-w}, v_w = x_w - x_{W-w} (u = x_w alone at
//              w = 0 and w = W/2), re = C_h^T u, im = -S_h^T v;
//   synthesis: P_w = Ci_h^T re, Q_w = Si_h^T im, x_w = P_w - Q_w,
//              x_{W-w} = P_w + Q_w;
// two products of half the size instead of one: half the multiply-adds.
// Both are the same block GEMM: a block owns one latitude row, 64 channels
// and up to FOLD_GROUP 128-wide output tiles (modes, or half longitudes),
// walked in turn, and computes the two products side by side: half its
// warps the "u" product, half the "v" product (analysis: u, v; synthesis:
// re, im) against the two halves of the prepared operand's 256-column tile.  K-slabs of FOLD_K run
// double-buffered through shared memory: the operand by 16-byte cp.async,
// the u / v slabs through registers (16-byte vectors where C allows), where
// the analysis folds x_w with its mirror x_{W-w}.
//
// bf16 operands: the dense products on wgmma (dft_analysis.cu,
// dft_synthesis.cu) share the staging of a raw (64, <= 128)-element slab of
// x or hm into the MN-major, 128-byte-swizzled bf16 B operand and the
// epilogue of a 64 x 128 accumulator fragment.

#pragma once

#include <climits>
#include <cstring>

#include "tile_common.cuh"

namespace {

// tiles that shape the prepared operands (the wrappers check them)
constexpr int FOLD_K = 16;       // fp32 K-slab; the fold operand's row multiple
constexpr int FOLD_TILE = 128;   // modes or half longitudes per fp32 block
constexpr int BF16_K = 64;       // bf16 K-slab (TMA box depth)
constexpr int BF16_TILE = 256;   // rows of the bf16 operand per block (modes) or chunk (K)

inline int dft_tile(int i) {
  const int t[4] = {FOLD_K, FOLD_TILE, BF16_K, BF16_TILE};
  return i >= 0 && i < 4 ? t[i] : -1;
}

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC values of IN_T at p as fp32 (VEC > 1: one 16-byte vector)
template <int VEC, typename IN_T>
__device__ __forceinline__ void load_vec(const IN_T* p, float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(*p);
  } else {
    static_assert(VEC * sizeof(IN_T) == 16, "16-byte vectors");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const IN_T* vals = reinterpret_cast<const IN_T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f32(vals[j]);
  }
}

// ---------------------------------------------------------------------------
// fp32: the folded block GEMM

#ifndef FOLD_MINB_OVERRIDE
#define FOLD_MINB_OVERRIDE 2
#endif
#ifndef FOLD_GROUP_OVERRIDE
#define FOLD_GROUP_OVERRIDE 3
#endif
constexpr int FOLD_GROUP = FOLD_GROUP_OVERRIDE;  // output tiles per block
constexpr int FOLD_BN = 64;        // channels per block
constexpr int FOLD_THREADS = 256;  // a thread owns 8 rows of one product x 8 channels
constexpr int FOLD_LDA = 2 * FOLD_TILE;

struct FoldArgs {
  const float* at;  // prepared (k_pad, tiles * 256)
  const void* b;    // analysis x (rows, w, c); synthesis hm (rows, 2m, c)
  void* out;        // analysis (rows, 2m, c) fp32; synthesis (rows, w, c); rows of ldo
  long long rows, ldo;
  int w, m, c, kh;  // longitudes, modes, channels, w / 2 + 1
  int k_dim, k_pad; // K of the products: kh (analysis) or m (synthesis)
  int tiles, c_tiles;
  // synthesis with AFF: out = aff_a * (Mt @ hm) + aff_b per (sample,
  // channel), (samples, c) each, a sample aff_rows rows
  const float* aff_a;
  const float* aff_b;
  long long aff_rows;
};

// One thread's share of the u and v K-slabs (FOLD_K x FOLD_BN each): the
// values loaded (analysis: x_k and its mirror x_{W-k}; synthesis: re_k and
// im_k) stay in registers while the current slab is multiplied, and are
// folded (analysis) as they go to shared memory; zeros past the edges
template <bool ANALYSIS, int VEC, typename IN_T>
struct FoldSlab {
  static constexpr int VPR = FOLD_BN / VEC;
  static constexpr int TOTAL = FOLD_K * VPR;
  static constexpr int N = (TOTAL + FOLD_THREADS - 1) / FOLD_THREADS;
  float p[N][VEC], q[N][VEC];
  bool paired[N];  // analysis: k has a mirror (not k = 0, not k = W/2)

  __device__ __forceinline__ void load(const FoldArgs& a, const IN_T* brow, int k0, int c0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * FOLD_THREADS;
      const int k = k0 + e / VPR, cc = c0 + (e % VPR) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) p[i][j] = q[i][j] = 0.f;
      paired[i] = false;
      if (e >= TOTAL || k >= a.k_dim || cc >= a.c) continue;
      load_vec<VEC>(brow + (long long)k * a.c + cc, p[i]);
      if constexpr (ANALYSIS) {
        const int mirror = a.w - k;
        paired[i] = k > 0 && mirror != k;
        if (paired[i]) load_vec<VEC>(brow + (long long)mirror * a.c + cc, q[i]);
      } else {
        load_vec<VEC>(brow + (long long)(a.m + k) * a.c + cc, q[i]);
      }
    }
  }

  __device__ __forceinline__ void store(float* us, float* vs) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * FOLD_THREADS;
      if (TOTAL % FOLD_THREADS != 0 && e >= TOTAL) break;
      const int off = (e / VPR) * FOLD_BN + (e % VPR) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        if constexpr (ANALYSIS) {  // u = x_k + x_{W-k}, v = x_k - x_{W-k}; u = x_k alone
          us[off + j] = paired[i] ? p[i][j] + q[i][j] : p[i][j];
          vs[off + j] = paired[i] ? p[i][j] - q[i][j] : 0.f;
        } else {
          us[off + j] = p[i][j];
          vs[off + j] = q[i][j];
        }
      }
    }
  }
};

// operand rows [k0, k0 + FOLD_K), columns [col0, col0 + 256) into as[k][.]
// as 16-byte cp.async copies (the operand is padded: no masks); commits
__device__ __forceinline__ void fold_stage_at(const FoldArgs& a, int k0, int col0, float* as) {
  constexpr int CPR = FOLD_LDA / 4;  // copies per row
  static_assert(FOLD_K * CPR % FOLD_THREADS == 0, "slab split");
  const int ld = a.tiles * FOLD_LDA;
#pragma unroll
  for (int j = 0; j < FOLD_K * CPR / FOLD_THREADS; ++j) {
    const int i = threadIdx.x + j * FOLD_THREADS;
    const int k = i / CPR, q = (i % CPR) * 4;
    cp_async16(as + k * FOLD_LDA + q, a.at + (long long)(k0 + k) * ld + col0 + q, 16);
  }
  cp_async_commit();
}

// The block's 256 threads split the two products: warps 0-3 accumulate the
// first (the operand's first 128 columns against u: re, or P), warps 4-7
// the second (its next 128 against v: im, or Q).  In each half, thread (tm,
// tc) = ((threadIdx % 128) / 8, threadIdx % 8) owns rows {4 tm + i, 64 + 4
// tm + i} (i < 4; acc[i], acc[4 + i]) and the channel quads 4 tc and 32 + 4
// tc (acc[.][0..3], acc[.][4..7]).  Per K-step a warp reads two float4 of
// the operand (4 addresses, broadcast) and two of its slab (128 contiguous
// bytes each): one shared-memory wavefront each, for 64 FMA; each store
// instruction of a warp writes four whole 128-byte row segments.
struct FoldThread {
  int half, tm, tc;
  __device__ __forceinline__ FoldThread() {
    half = threadIdx.x / 128;
    tm = (threadIdx.x % 128) / 8;
    tc = threadIdx.x % 8;
  }
  __device__ __forceinline__ int row(int i) const {  // row of acc[i] in the 128-row tile
    return i < 4 ? 4 * tm + i : 64 + 4 * tm + i - 4;
  }
  __device__ __forceinline__ int channel(int j) const {  // channel of acc[.][j] in the tile
    return j < 4 ? 4 * tc + j : 32 + 4 * tc + j - 4;
  }
};

__device__ __forceinline__ void fold_fma_slab(float (&acc)[8][8], const float* as, const float* bs,
                                              const FoldThread& th) {
  const float* a_col = as + th.half * FOLD_TILE + 4 * th.tm;
  const float* b_col = bs + 4 * th.tc;
#pragma unroll
  for (int k = 0; k < FOLD_K; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(a_col + k * FOLD_LDA);
    const float4 a1 = *reinterpret_cast<const float4*>(a_col + k * FOLD_LDA + 64);
    const float4 b0 = *reinterpret_cast<const float4*>(b_col + k * FOLD_BN);
    const float4 b1 = *reinterpret_cast<const float4*>(b_col + k * FOLD_BN + 32);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// A thread's 8 values of one row (channels c0 + th.channel(j)) as OUT_T
// into the output row `dst` (the tile's channel 0): two vectors of 4 (16
// bytes fp32, 8 bf16) when VEC (c % 8 == 0), else one at a time below c
template <bool VEC, typename OUT_T>
__device__ __forceinline__ void store_row8(OUT_T* dst, const float* v, const FoldThread& th,
                                           int c0, int c) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ch = c0 + th.channel(4 * h);
    if constexpr (VEC) {
      if (ch >= c) continue;
      alignas(16) OUT_T packed[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) packed[j] = from_f32<OUT_T>(v[4 * h + j]);
      if constexpr (sizeof(OUT_T) == 4)
        *reinterpret_cast<uint4*>(dst + ch) = *reinterpret_cast<const uint4*>(packed);
      else
        *reinterpret_cast<uint2*>(dst + ch) = *reinterpret_cast<const uint2*>(packed);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (ch + j < c) dst[ch + j] = from_f32<OUT_T>(v[4 * h + j]);
    }
  }
}

// A block owns one latitude row, 64 channels and FOLD_GROUP consecutive
// output tiles, which it walks in one double-buffered stream of K-slabs:
// the next tile's first slab is in flight while a tile ends
template <bool ANALYSIS, int VEC, typename IN_T, typename OUT_T, bool AFF>
__global__ void __launch_bounds__(FOLD_THREADS, FOLD_MINB_OVERRIDE) fold_rows(FoldArgs a) {
  __shared__ __align__(16) float as[2][FOLD_K * FOLD_LDA];
  __shared__ __align__(16) float us[2][FOLD_K * FOLD_BN];
  __shared__ __align__(16) float vs[2][FOLD_K * FOLD_BN];
  // (row, tile group, channel tile): channel tiles fastest, so the blocks
  // of one row run side by side and share its reads in L2
  const long long bid = blockIdx.x;
  const int c0 = (int)(bid % a.c_tiles) * FOLD_BN;
  const long long rest = bid / a.c_tiles;
  const int groups = (a.tiles + FOLD_GROUP - 1) / FOLD_GROUP;
  const int t_begin = (int)(rest % groups) * FOLD_GROUP;
  const int t_end = min(a.tiles, t_begin + FOLD_GROUP);
  const long long r = rest / groups;
  const FoldThread th;
  const long long b_rows = ANALYSIS ? a.w : 2LL * a.m;
  const IN_T* brow = reinterpret_cast<const IN_T*>(a.b) + r * b_rows * a.c;
  OUT_T* out =
      reinterpret_cast<OUT_T*>(a.out) + r * (ANALYSIS ? 2LL * a.m : (long long)a.w) * a.ldo;

  FoldSlab<ANALYSIS, VEC, IN_T> slab;
  const int n_slabs = a.k_pad / FOLD_K;
  fold_stage_at(a, 0, t_begin * FOLD_LDA, as[0]);
  slab.load(a, brow, 0, c0);
  slab.store(us[0], vs[0]);
  cp_async_wait<0>();
  __syncthreads();
  int cur = 0;
  for (int t = t_begin; t < t_end; ++t) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int s = 0; s < n_slabs; ++s, cur ^= 1) {
      const bool last = s + 1 == n_slabs;
      const int tn = last ? t + 1 : t, kn = last ? 0 : (s + 1) * FOLD_K;
      const bool next = tn < t_end;
      // the other buffers were last read before the previous barrier
      if (next) {
        fold_stage_at(a, kn, tn * FOLD_LDA, as[cur ^ 1]);
        slab.load(a, brow, kn, c0);
      }
      fold_fma_slab(acc, as[cur], th.half ? vs[cur] : us[cur], th);
      if (next) {
        slab.store(us[cur ^ 1], vs[cur ^ 1]);
        cp_async_wait<0>();
      }
      __syncthreads();
    }
    // tile t is done; the next tile's first slab is in buffer cur, and the
    // operand buffer cur ^ 1 is free until the next iteration's prefetch
    if constexpr (ANALYSIS) {
      // re of mode q, and im at M + q
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = t * FOLD_TILE + th.row(i);
        if (q < a.m)
          store_row8<VEC != 1>(out + (long long)(th.half * a.m + q) * a.ldo, acc[i], th, c0,
                               a.c);
      }
    } else {
      // x_q = P - Q and x_{W-q} = P + Q: the second half hands Q over
      // through the free operand buffer, 64 rows at a time
      float* qs = as[cur ^ 1];  // 64 rows x 64 channels
      float sa[8], sb[8];  // AFF: the affine of the thread's channels
      if constexpr (AFF) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ch = c0 + th.channel(j);
          const long long e = r / a.aff_rows * a.c + ch;
          sa[j] = ch < a.c ? __ldg(a.aff_a + e) : 1.f;
          sb[j] = ch < a.c ? __ldg(a.aff_b + e) : 0.f;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (th.half) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float* d = qs + (4 * th.tm + i) * FOLD_BN;
            *reinterpret_cast<float4*>(d + th.channel(0)) = make_float4(
                acc[4 * h + i][0], acc[4 * h + i][1], acc[4 * h + i][2], acc[4 * h + i][3]);
            *reinterpret_cast<float4*>(d + th.channel(4)) = make_float4(
                acc[4 * h + i][4], acc[4 * h + i][5], acc[4 * h + i][6], acc[4 * h + i][7]);
          }
        }
        __syncthreads();
        if (!th.half) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int q = t * FOLD_TILE + th.row(4 * h + i);  // half longitude
            if (q >= a.kh) continue;
            const float* qrow = qs + (4 * th.tm + i) * FOLD_BN;
            float lo[8], hi[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float qv = qrow[th.channel(j)];
              lo[j] = acc[4 * h + i][j] - qv;
              hi[j] = acc[4 * h + i][j] + qv;
              if constexpr (AFF) {
                lo[j] = fmaf(sa[j], lo[j], sb[j]);
                hi[j] = fmaf(sa[j], hi[j], sb[j]);
              }
            }
            store_row8<VEC != 1>(out + (long long)q * a.ldo, lo, th, c0, a.c);
            if (q > 0 && a.w - q != q)
              store_row8<VEC != 1>(out + (long long)(a.w - q) * a.ldo, hi, th, c0, a.c);
          }
        }
        __syncthreads();
      }
    }
  }
}

// Launches fold_rows over `rows` rows of `w` longitudes, `m` modes and `c`
// channels: the analysis reads in (rows, w, c) and writes out (rows, 2m,
// c) fp32, the synthesis reads in (rows, 2m, c) and writes out (rows, w,
// c), out's rows ldo apart (0: c); `at` is the prepared operand (at_rows x
// at_cols).  With AFF the synthesis applies aff_a, aff_b ((samples, c)
// each, a sample aff_rows rows) to its output.  16-byte vectors of the
// input and the output where all their rows start 16-byte aligned and
// every 8-channel group is whole.  Returns a CUDA error code.
template <bool ANALYSIS, typename IN_T, typename OUT_T, bool AFF = false>
int fold_launch(const void* at, const void* in, void* out, long long rows, int w, int m, int c,
                int at_rows, int at_cols, cudaStream_t stream, long long ldo = 0,
                const float* aff_a = nullptr, const float* aff_b = nullptr,
                long long aff_rows = 1) {
  FoldArgs a{};
  a.at = reinterpret_cast<const float*>(at);
  a.b = in;
  a.out = out;
  a.rows = rows;
  a.ldo = ldo ? ldo : c;
  a.aff_a = aff_a;
  a.aff_b = aff_b;
  a.aff_rows = aff_rows;
  a.w = w;
  a.m = m;
  a.c = c;
  a.kh = w / 2 + 1;
  a.k_dim = ANALYSIS ? a.kh : m;
  a.k_pad = at_rows;
  a.tiles = ((ANALYSIS ? m : a.kh) + FOLD_TILE - 1) / FOLD_TILE;
  const int want_pad = (a.k_dim + FOLD_K - 1) / FOLD_K * FOLD_K;
  if (a.rows < 1 || a.w < 2 || a.m < 1 || a.c < 1 || a.k_pad != want_pad ||
      at_cols != a.tiles * 2 * FOLD_TILE || a.ldo < a.c ||
      (AFF && (ANALYSIS || !aff_a || !aff_b || aff_rows < 1)))
    return (int)cudaErrorInvalidValue;
  a.c_tiles = (a.c + FOLD_BN - 1) / FOLD_BN;
  const long long blocks = a.rows * ((a.tiles + FOLD_GROUP - 1) / FOLD_GROUP) * a.c_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const bool vec = a.c % 8 == 0 && a.ldo % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(a.b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  constexpr int V = 16 / sizeof(IN_T);
  if (vec)
    fold_rows<ANALYSIS, V, IN_T, OUT_T, AFF><<<(unsigned)blocks, FOLD_THREADS, 0, stream>>>(a);
  else
    fold_rows<ANALYSIS, 1, IN_T, OUT_T, AFF><<<(unsigned)blocks, FOLD_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: wgmma pieces shared by both kernels

constexpr int WG_CONSUMERS = 256;  // two consumer warpgroups
constexpr int WG_THREADS = WG_CONSUMERS + 32;  // and one producer warp
constexpr int WG_BN = 128;         // channels per block (two 64-channel swizzle chunks)
constexpr int RAW_BYTES_MAX = BF16_K * WG_BN * 4;  // one raw fp32 slab

// How a raw slab of x or hm, (rows, k_total, c), reaches the consumers: the
// producer moves it into shared memory as a 3-D TMA box of (64, 128)
// elements at channel c0 (rows of c * elt bytes, a multiple of 16), or as a
// 1-D bulk copy of the slab's contiguous run (the block owns all c <= 128
// channels; k_total * c * elt a multiple of 16); otherwise (RAW_GLOBAL) the
// consumers read the contiguous run from device memory as they convert it.
enum RawMode { RAW_TMA = 0, RAW_BULK = 1, RAW_GLOBAL = 2 };

struct RawSource {
  const void* base;  // (rows, k_total, c)
  int k_total, c, mode;
};

// The raw slab of k rows [k0, k0 + 64) of latitude row r (channels [c0,
// c0 + 128), or all of them): the producer's lane 0 announces raw_tx_bytes
// on the stage's barrier (with whatever else the stage holds) and calls
// raw_fetch; the consumers read it from raw_slab.
template <typename IN_T>
__device__ __forceinline__ const IN_T* raw_first(const RawSource& src, long long r, int k0) {
  return reinterpret_cast<const IN_T*>(src.base) + (r * src.k_total + k0) * src.c;
}

template <typename IN_T>
__device__ __forceinline__ const void* raw_slab(const RawSource& src, const void* stage,
                                                long long r, int k0) {
  return src.mode == RAW_GLOBAL ? static_cast<const void*>(raw_first<IN_T>(src, r, k0)) : stage;
}

template <typename IN_T>
__device__ __forceinline__ uint32_t raw_tx_bytes(const RawSource& src, int k0) {
  if (src.mode == RAW_TMA) return BF16_K * WG_BN * sizeof(IN_T);
  if (src.mode == RAW_BULK) return min(BF16_K, src.k_total - k0) * src.c * sizeof(IN_T);
  return 0;
}

template <typename IN_T>
__device__ __forceinline__ void raw_fetch(const RawSource& src, const CUtensorMap* map,
                                          void* dst, uint64_t* bar, long long r, int k0,
                                          int c0) {
  if (src.mode == RAW_TMA)
    tma_load_3d(dst, map, bar, c0, k0, (int)r);
  else if (src.mode == RAW_BULK)
    bulk_load(dst, raw_first<IN_T>(src, r, k0), raw_tx_bytes<IN_T>(src, k0), bar);
}

// Consumers: a raw slab, in shared memory or (RAW_GLOBAL) device memory
// (row pitch `pitch` elements: 128 for RAW_TMA, whose box holds zeros past
// the edges, else c; kv valid rows, nv valid channels)
// into k rows [k_row0, k_row0 + 64) of an MN-major 128-byte-swizzled bf16
// operand of two 64-channel chunks `chunk_bytes` apart, zeros past the
// edges; thread `tid` of `n_threads` takes every n_threads-th (row, 8
// channels) unit.  The caller fences (fence_proxy_async) and syncs before
// a wgmma reads it.
template <typename IN_T>
__device__ __forceinline__ void stage_b(const void* raw, int pitch, int kv, int nv,
                                        char* bsm, int chunk_bytes, int k_row0, int tid,
                                        int n_threads, bool dense) {
  const IN_T* src = reinterpret_cast<const IN_T*>(raw);
  for (int e = tid; e < BF16_K * 16; e += n_threads) {
    const int k = e / 16, g = e % 16;  // row, 8-channel group
    float v[8];
    if (dense) {  // whole rows of 128 in 16-byte vectors (pitch 128)
      if constexpr (sizeof(IN_T) == 4) {
        load_vec<4>(src + k * pitch + 8 * g, *reinterpret_cast<float(*)[4]>(v));
        load_vec<4>(src + k * pitch + 8 * g + 4, *reinterpret_cast<float(*)[4]>(v + 4));
      } else {
        load_vec<8>(src + k * pitch + 8 * g, v);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = 8 * g + j;
        v[j] = (k < kv && n < nv) ? to_f32(src[k * pitch + n]) : 0.f;
      }
    }
    alignas(16) __nv_bfloat16 packed[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) packed[j] = __float2bfloat16_rn(v[j]);
    const int row = k_row0 + k;
    char* dst = bsm + (g / 8) * chunk_bytes + row * 128 + (((g % 8) ^ (row & 7)) * 16);
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
  }
}

// Epilogue of a warpgroup's 64 x 128 accumulator fragment: row i of the
// fragment to out[(row0 + i) * c + c0 + j] for i < n_rows and c0 + j < c;
// `add` adds to what out holds.  With `vec` (c % 4 == 0, 16-byte aligned
// out) lane pairs trade halves so that each thread writes 4 consecutive
// channels as one vector (16 bytes fp32, 8 bf16).
template <typename OUT_T>
__device__ __forceinline__ void store_fragment(const float (&d)[64], OUT_T* out, long long row0,
                                               int n_rows, int c0, int c, bool vec, bool add) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;
  const bool odd = lane & 1;
#pragma unroll
  for (int q = 0; q < 16; ++q) {
    const float* dq = d + 4 * q;
    if (vec) {
      // even lanes: row r0, channels 4 (lane % 4 / 2) .. + 4 of the 8; odd
      // lanes: row r0 + 8, the same channels
      const float s0 = odd ? dq[0] : dq[2], s1 = odd ? dq[1] : dq[3];
      const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      float v[4] = {dq[0], dq[1], g0, g1};
      if (odd) {
        v[0] = g0; v[1] = g1; v[2] = dq[2]; v[3] = dq[3];
      }
      const int row = r0 + (odd ? 8 : 0);
      const int col = c0 + 8 * q + 4 * ((lane % 4) / 2);
      if (row >= n_rows || col >= c) continue;
      OUT_T* p = out + (row0 + row) * c + col;
      if (add) {
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] += to_f32(p[j]);
      }
      if constexpr (sizeof(OUT_T) == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        alignas(8) OUT_T packed[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) packed[j] = from_f32<OUT_T>(v[j]);
        *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(packed);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e / 2);
        const int col = c0 + 8 * q + 2 * (lane % 4) + (e % 2);
        if (row >= n_rows || col >= c) continue;
        OUT_T* p = out + (row0 + row) * c + col;
        *p = from_f32<OUT_T>(dq[e] + (add ? to_f32(*p) : 0.f));
      }
    }
  }
}

// The raw-slab mode for an input of c channels of `elt` bytes, k_total rows
// per latitude row, and its 3-D tensor map when RAW_TMA
template <typename IN_T>
int raw_source(RawSource* src, CUtensorMap* map, const void* base, long long rows,
               int k_total, int c) {
  constexpr int elt = sizeof(IN_T);
  src->base = base;
  src->k_total = k_total;
  src->c = c;
  if (reinterpret_cast<uintptr_t>(base) % 16) return (int)cudaErrorMisalignedAddress;
  if (c * elt % 16 == 0) {
    src->mode = RAW_TMA;
    const uint64_t dims[3] = {(uint64_t)c, (uint64_t)k_total, (uint64_t)rows};
    const uint64_t strides[2] = {(uint64_t)c * elt, (uint64_t)k_total * c * elt};
    const uint32_t box[3] = {WG_BN, BF16_K, 1};
    return make_tensor_map(map, elt == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                           3, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (c > WG_BN) return (int)cudaErrorInvalidValue;
  src->mode = (long long)k_total * c * elt % 16 == 0 ? RAW_BULK : RAW_GLOBAL;
  return 0;
}

// ---------------------------------------------------------------------------
// bf16: the dense forward DFT on wgmma (dft_analysis.cu; grid_encoder_spectral.cu
// runs it on its bf16 encoder output, with a bf16 f)
//
// f[r] = at @ x[r] for every latitude row r: at the prepared bf16 operand
// (2M padded to BF16_TILE, W padded to BF16_K), x raw fp32 or bf16, f in
// OUT_T.  A block owns one row and 128 channels and holds all 2M <= 256
// modes: two consumer warpgroups of two m64n128 accumulators each.  A
// producer warp keeps a ring of stages in flight by TMA (STAGES_OPT of them;
// 0 fills 192 KB): the operand tile (256 modes x 64 longitudes, K-major)
// and the raw x slab; the consumers convert the slab to the MN-major
// swizzled B operand, then run 4 K-steps of wgmma.

struct WgAnalysisArgs {
  RawSource x;  // (rows, w, c)
  void* out;    // (rows, two_m, c) of OUT_T
  long long rows;
  int w, two_m, c, m_tiles, c_tiles, n_k;
  int vec;  // 16-byte output vectors
  // null, or (rows / scale_rows, c): out[r] is scaled per channel by row r /
  // scale_rows of it (the tail's backward: dhm = a[b] * Mt^T dxa)
  const float* scale;
  long long scale_rows;
};

template <typename IN_T, int STAGES_OPT>
struct AnalysisSmem {
  static constexpr int A_BYTES = BF16_TILE * BF16_K * 2;  // 4 boxes of 64 modes x 64 longitudes
  static constexpr int SLOT = A_BYTES + BF16_K * WG_BN * (int)sizeof(IN_T);
  static constexpr int STAGES = STAGES_OPT ? STAGES_OPT : 192 * 1024 / SLOT;
  static constexpr int B_BYTES = BF16_K * WG_BN * 2;  // one converted B operand
  static constexpr int BYTES = 1024 + STAGES * SLOT + 2 * B_BYTES + 2 * STAGES * 8;
};

// two consumer warpgroups and a producer warpgroup, of which one warp
// works: 384 threads, so that setmaxnreg can give the consumers 232
// registers (their 128 accumulators) and the producer 40
constexpr int ANALYSIS_THREADS = WG_CONSUMERS + 128;

// DIRECT (bf16 x, grid_encoder_spectral.cu): x_map is a 128-byte-swizzled
// map of 64 x 64 boxes, which TMA writes as the MN-major B operand itself:
// no conversion, and one stage's wgmmas stay in flight.
template <typename IN_T, typename OUT_T, int STAGES_OPT, bool DIRECT = false>
__global__ void __launch_bounds__(ANALYSIS_THREADS, 1)
    analysis_wgmma(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap x_map, WgAnalysisArgs a) {
  using S = AnalysisSmem<IN_T, STAGES_OPT>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  char* bbuf = smem + S::STAGES * S::SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(bbuf + 2 * S::B_BYTES);
  uint64_t* empty = full + S::STAGES;
  // (row, mode tile, channel tile), channel tiles fastest
  const long long bid = blockIdx.x;
  const int c0 = (int)(bid % a.c_tiles) * WG_BN;
  const long long rest = bid / a.c_tiles;
  const int mt = (int)(rest % a.m_tiles);
  const long long r = rest / a.m_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= WG_CONSUMERS / 32) {  // the producer warpgroup
    reg_dealloc<40>();
    if (warp > WG_CONSUMERS / 32) return;
    for (int s = 0; s < a.n_k; ++s) {
      const int slot = s % S::STAGES;
      char* sb = smem + slot * S::SLOT;
      if (s >= S::STAGES) mbar_wait(empty + slot, (s / S::STAGES - 1) & 1);
      const int k0 = s * BF16_K;
      if (lane == 0) {
        // DIRECT: the boxes that start below c (the rest of B is not stored)
        const int boxes = c0 + 64 < a.c ? 2 : 1;
        mbar_expect_tx(full + slot,
                       S::A_BYTES + (DIRECT ? boxes * 8192 : raw_tx_bytes<IN_T>(a.x, k0)));
        for (int b = 0; b < 4; ++b)
          tma_load_2d(sb + b * 8192, &a_map, full + slot, k0, mt * BF16_TILE + 64 * b);
        if constexpr (DIRECT) {
          for (int h = 0; h < boxes; ++h)
            tma_load_3d(sb + S::A_BYTES + h * 8192, &x_map, full + slot, c0 + 64 * h, k0,
                        (int)r);
        } else {
          raw_fetch<IN_T>(a.x, &x_map, sb + S::A_BYTES, full + slot, r, k0, c0);
        }
      }
      __syncwarp();
    }
    return;
  }

  // consumers: warpgroup g holds modes [128 g, 128 g + 128) of the tile
  reg_alloc<232>();
  const int g = warp / 4;
  const bool dense = a.x.mode == RAW_TMA;
  const int pitch = dense ? WG_BN : a.c;
  float acc[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
  for (int s = 0; s < a.n_k; ++s) {
    const int slot = s % S::STAGES;
    char* sb = smem + slot * S::SLOT;
    char* bs = bbuf + (s & 1) * S::B_BYTES;
    mbar_wait(full + slot, (s / S::STAGES) & 1);
    if constexpr (DIRECT) {
      bs = sb + S::A_BYTES;
    } else {
      // the other B buffer may still be read by the other warpgroup's
      // previous wgmma; this one was last read two slabs ago
      stage_b<IN_T>(raw_slab<IN_T>(a.x, sb + S::A_BYTES, r, s * BF16_K), pitch,
                    min(BF16_K, a.w - s * BF16_K), pitch, bs, BF16_K * 128, 0, threadIdx.x,
                    WG_CONSUMERS, dense);
      fence_proxy_async();
      named_bar_sync(1, WG_CONSUMERS);
    }
    wgmma_fence();
    fence_operand(acc[0]);
    fence_operand(acc[1]);
#pragma unroll
    for (int ks = 0; ks < BF16_K / 16; ++ks) {
      const uint64_t db = wgmma_desc(bs + ks * 2048, BF16_K * 128, 1024);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint64_t da = wgmma_desc(sb + (2 * g + i) * 8192 + ks * 32, 16, 1024);
        wgmma_m64n128k16<1>(acc[i], da, db, (s > 0 || ks > 0) ? 1 : 0);
      }
    }
    wgmma_commit();
    if constexpr (DIRECT) {
      wgmma_wait<1>();  // the previous stage's wgmmas are done: release its slot
      fence_operand(acc[0]);
      fence_operand(acc[1]);
      if (s > 0 && lane == 0) mbar_arrive(empty + (s - 1) % S::STAGES);
    } else {
      wgmma_wait<0>();
      fence_operand(acc[0]);
      fence_operand(acc[1]);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
    }
  }
  if constexpr (DIRECT) {
    wgmma_wait<0>();
    fence_operand(acc[0]);
    fence_operand(acc[1]);
  }
  OUT_T* out = reinterpret_cast<OUT_T*>(a.out) + r * a.two_m * a.c;
  if (a.scale) {
    const float* sc = a.scale + (r / a.scale_rows) * a.c;
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c0 + 8 * q + 2 * (threadIdx.x % 4) + e;
        const float v = col < a.c ? sc[col] : 0.f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[i][4 * q + e] *= v;
          acc[i][4 * q + 2 + e] *= v;
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row0 = mt * BF16_TILE + 128 * g + 64 * i;
    if (row0 < a.two_m)
      store_fragment<OUT_T>(acc[i], out, row0, min(64, a.two_m - row0), c0, a.c, a.vec, false);
  }
}

template <typename IN_T, typename OUT_T, int STAGES_OPT>
int launch_analysis_wgmma(const void* at, const void* x, OUT_T* out, long long rows, int w,
                          int m, int c, int at_rows, int at_cols, cudaStream_t stream) {
  using S = AnalysisSmem<IN_T, STAGES_OPT>;
  WgAnalysisArgs a{};
  a.out = out;
  a.rows = rows;
  a.w = w;
  a.two_m = 2 * m;
  a.c = c;
  a.m_tiles = (2 * m + BF16_TILE - 1) / BF16_TILE;
  a.n_k = (w + BF16_K - 1) / BF16_K;
  if (rows < 1 || w < 1 || m < 1 || c < 1 || at_rows != a.m_tiles * BF16_TILE ||
      at_cols != a.n_k * BF16_K)
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, x_map;
  memset(&x_map, 0, sizeof(x_map));
  const uint64_t a_dims[2] = {(uint64_t)at_cols, (uint64_t)at_rows};
  const uint64_t a_strides[1] = {(uint64_t)at_cols * 2};
  const uint32_t a_box[2] = {BF16_K, 64};
  int err = make_tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, at, a_dims, a_strides,
                            a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  if ((err = raw_source<IN_T>(&a.x, &x_map, x, rows, w, c))) return err;
  a.c_tiles = a.x.mode == RAW_TMA ? (c + WG_BN - 1) / WG_BN : 1;
  a.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long blocks = rows * a.m_tiles * a.c_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = analysis_wgmma<IN_T, OUT_T, STAGES_OPT>;
  static bool smem_set = false;  // once per kernel
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  kernel<<<(unsigned)blocks, ANALYSIS_THREADS, S::BYTES, stream>>>(a_map, x_map, a);
  return (int)cudaGetLastError();
}

// The DIRECT bf16 forward DFT: f[r] = at @ y[r] per row, y (rows, w, c)
// bf16 read by TMA as the wgmma B operand itself; optionally scaled per
// (row / scale_rows, channel).  grid_encoder_spectral.cu's DFT pass and
// spectral_decoder_bwd.cu's transposed DFT.
template <typename OUT_T, int STAGES_OPT>
int launch_analysis_direct(const void* at, const void* y, OUT_T* out, long long rows, int w,
                           int m, int c, int at_rows, int at_cols, const float* scale,
                           long long scale_rows, cudaStream_t stream) {
  using S = AnalysisSmem<__nv_bfloat16, STAGES_OPT>;
  WgAnalysisArgs a{};
  a.out = out;
  a.rows = rows;
  a.w = w;
  a.two_m = 2 * m;
  a.c = c;
  a.m_tiles = (2 * m + BF16_TILE - 1) / BF16_TILE;
  a.n_k = (w + BF16_K - 1) / BF16_K;
  a.c_tiles = (c + WG_BN - 1) / WG_BN;
  a.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  a.scale = scale;
  a.scale_rows = scale_rows;
  const long long blocks = rows * a.m_tiles * a.c_tiles;
  if (rows < 1 || w < 1 || c % 8 || at_rows != a.m_tiles * BF16_TILE ||
      at_cols != a.n_k * BF16_K || blocks > INT_MAX || (scale && scale_rows < 1) ||
      reinterpret_cast<uintptr_t>(at) % 16 || reinterpret_cast<uintptr_t>(y) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, y_map;
  const uint64_t a_dims[2] = {(uint64_t)at_cols, (uint64_t)at_rows};
  const uint64_t a_strides[1] = {(uint64_t)at_cols * 2};
  const uint32_t a_box[2] = {BF16_K, 64};
  int err = make_tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, at, a_dims, a_strides,
                            a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const uint64_t y_dims[3] = {(uint64_t)c, (uint64_t)w, (uint64_t)rows};
  const uint64_t y_strides[2] = {(uint64_t)c * 2, (uint64_t)c * 2 * w};
  const uint32_t y_box[3] = {64, BF16_K, 1};
  err = make_tensor_map(&y_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, y, y_dims, y_strides, y_box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  auto kernel = analysis_wgmma<__nv_bfloat16, OUT_T, STAGES_OPT, true>;
  static bool smem_set = false;  // once per kernel
  if (!smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  kernel<<<(unsigned)blocks, ANALYSIS_THREADS, S::BYTES, stream>>>(a_map, y_map, a);
  return (int)cudaGetLastError();
}

}  // namespace
