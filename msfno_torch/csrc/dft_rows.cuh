// The batched row GEMM of the two longitude-DFT kernels (dft_analysis.cu,
// dft_synthesis.cu).  Per latitude row r:
//
//   out[r] (m_dim x c) = A (m_dim x k_dim) @ B[r] (k_dim x c),
//
// with A given by its transpose At, prepared once per transform and device
// (the wrappers' `prepare`): the merged DFT matrix [C | -S] (analysis, k =
// longitude, m = mode) or [Ci; -Si] (synthesis, k = mode, m = longitude),
// zero-padded to (k_pad, m_pad) = multiples of (DFT_K_MULTIPLE, DFT_BM), in
// the operand type (fp32, or bf16 rounded to nearest even).  B is fp32 or
// bf16 and is converted when staged; out is fp32 or bf16.
//
// A block owns one row r, a DFT_BM-row tile of out (modes or longitudes) and
// a DFT_BN-channel tile; the ragged edges of B and out (2M = 242, C = 73, W
// = 1440 = 5 * 256 + 160) are masked, never padded in device memory.
// K-slabs run double-buffered through shared memory: the At slab by
// cp.async (16-byte copies, no masks: the operand is padded), the B slab
// through registers, 16-byte vectors where C allows (VEC elements, else one
// at a time), converted to the operand type.  The next slab's copies and
// loads are in flight while the current one is multiplied.  With VEC, out
// is written in 16-byte vectors too (whole 32-byte sectors per thread or
// lane pair: the synthesis writes the 1 GB grid field).  Two blocks fit an
// SM (registers capped at 128), faster than one at the full-width sites
// (tools/kernel_variants.py MINB=1; PERF.md).  Operands:
//   fp32 ("float32", "tensorfloat"): true fp32 FMA on the CUDA cores, each
//     thread an 8 x 8 register tile (no TF32: "float32" means fp32);
//   bf16 ("bfloat16"): WMMA 16x16x16 with fp32 accumulation: bf16 x bf16
//     products are exact in fp32, so only the order of summation differs
//     from the plain version.
// The blocks of one row are adjacent in the launch order, so B[r] is read
// from device memory about once and from L2 by the other m tiles.

#pragma once

#include <climits>

#include "tile_common.cuh"

namespace {

#ifndef MINB_OVERRIDE
#define MINB_OVERRIDE 2
#endif
constexpr int DFT_BM = 256;          // rows of out (modes or longitudes) per block
constexpr int DFT_BN = 64;           // channels per block
constexpr int DFT_THREADS = 256;
constexpr int DFT_K_MULTIPLE = 32;   // k_pad of the prepared At: a multiple of both slabs
constexpr int DFT_MIN_BLOCKS = MINB_OVERRIDE;  // resident blocks per SM (register cap)

struct DftArgs {
  const void* at;   // (k_pad, m_pad), the operand type
  const void* b;    // (rows, k_dim, c)
  void* out;        // (rows, m_dim, c)
  long long rows;
  int k_dim, m_dim, c, k_pad, m_pad;
  int m_tiles, c_tiles;
};

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

// Per operand type: K-slab depth and the shared leading dimensions (WMMA
// wants the bf16 rows padded against bank conflicts)
template <bool BF16_OPS>
struct DftShape {
  using T = typename std::conditional<BF16_OPS, __nv_bfloat16, float>::type;
  static constexpr int KS = BF16_OPS ? 32 : 16;
  static constexpr int LDA = BF16_OPS ? DFT_BM + 8 : DFT_BM;
  static constexpr int LDB = BF16_OPS ? DFT_BN + 8 : DFT_BN;
};

// At rows [k0, k0 + KS), columns [m0, m0 + DFT_BM) into as[k][m] (leading
// dimension LDA) as 16-byte cp.async copies; commits the group
template <typename T, int KS, int LDA>
__device__ __forceinline__ void stage_at(const DftArgs& a, int k0, int m0, T* as) {
  constexpr int EPC = 16 / sizeof(T);   // elements per copy
  constexpr int CPR = DFT_BM / EPC;     // copies per row
  static_assert(KS * CPR % DFT_THREADS == 0, "slab split");
  const T* at = reinterpret_cast<const T*>(a.at);
#pragma unroll
  for (int j = 0; j < KS * CPR / DFT_THREADS; ++j) {
    const int i = threadIdx.x + j * DFT_THREADS;
    const int k = i / CPR, q = (i % CPR) * EPC;
    cp_async16(as + k * LDA + q, at + (long long)(k0 + k) * a.m_pad + m0 + q, 16);
  }
  cp_async_commit();
}

// One thread's share of a K-slab of B[r] (KS x DFT_BN) in VEC-element
// vectors (VEC > 1: C is a multiple of 8 and the rows are 16-byte
// aligned), held in registers between the loads and the shared stores;
// zeros past the edges
template <int KS, int VEC, typename IN_T>
struct BSlab {
  static constexpr int VPR = DFT_BN / VEC;                          // vectors per slab row
  static constexpr int TOTAL = KS * VPR;                            // vectors per slab
  static constexpr int N = (TOTAL + DFT_THREADS - 1) / DFT_THREADS;  // per thread
  static_assert(VEC == 1 || VEC * sizeof(IN_T) == 16, "16-byte vectors");
  float v[N][VEC];

  __device__ __forceinline__ void load(const DftArgs& a, const IN_T* brow, int k0, int c0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * DFT_THREADS;
      const int k = k0 + e / VPR, cc = c0 + (e % VPR) * VEC;
      const bool ok = e < TOTAL && k < a.k_dim && cc < a.c;
      const IN_T* src = brow + (long long)k * a.c + cc;
      if constexpr (VEC == 1) {
        v[i][0] = ok ? to_f32(*src) : 0.f;
      } else {
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (ok) raw = *reinterpret_cast<const uint4*>(src);
        const IN_T* vals = reinterpret_cast<const IN_T*>(&raw);
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[i][j] = to_f32(vals[j]);
      }
    }
  }

  template <typename T>
  __device__ __forceinline__ void store(T* bs, int ldb) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * DFT_THREADS;
      if (TOTAL % DFT_THREADS != 0 && e >= TOTAL) break;
      T* dst = bs + (e / VPR) * ldb + (e % VPR) * VEC;
      alignas(16) T packed[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) packed[j] = from_f32<T>(v[i][j]);
      if constexpr (VEC * sizeof(T) == 16) {
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(packed);
      } else if constexpr (VEC * sizeof(T) == 8) {
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(packed);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) dst[j] = packed[j];
      }
    }
  }
};

// (row, m tile, c tile) of a block: c tiles fastest, then m tiles, so the
// blocks of one row run side by side
struct DftTile {
  long long r;
  int m0, c0;
};

__device__ __forceinline__ DftTile dft_tile(const DftArgs& a) {
  const long long bid = blockIdx.x;
  const long long rest = bid / a.c_tiles;
  return {rest / a.m_tiles, (int)(rest % a.m_tiles) * DFT_BM,
          (int)(bid % a.c_tiles) * DFT_BN};
}

// fp32 FMA on a staged slab: thread (tm, tc) owns out rows {4 tm + i, 128 +
// 4 tm + i} (i < 4, so a warp's float4 reads of At are conflict-free) and
// channels 8 tc + j
template <int KS>
__device__ __forceinline__ void fma_slab(float (&acc)[8][8], const float* as, const float* bs,
                                         int tm, int tc) {
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + k * DFT_BM + 4 * tm);
    const float4 a1 = *reinterpret_cast<const float4*>(as + k * DFT_BM + 128 + 4 * tm);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + k * DFT_BN + 8 * tc);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + k * DFT_BN + 8 * tc + 4);
    const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// bf16 WMMA on a staged slab: warp w owns out rows [32 w, 32 w + 32) of the
// tile (two 16-row tiles) and all four 16-channel tiles
template <int KS, int LDA, int LDB>
__device__ __forceinline__ void mma_slab(FragC (&acc)[2][4], const __nv_bfloat16* as,
                                         const __nv_bfloat16* bs, int warp) {
#pragma unroll
  for (int kk = 0; kk < KS; kk += 16) {
    FragACol fa[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(fa[i], as + kk * LDA + (2 * warp + i) * 16, LDA);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      FragB fb;
      wmma::load_matrix_sync(fb, bs + kk * LDB + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
    }
  }
}

// 8 fp32 values written as 8 values of OUT_T in 16-byte vectors (dst 16-byte
// aligned)
template <typename OUT_T>
__device__ __forceinline__ void store8(OUT_T* dst, const float* v) {
  alignas(16) OUT_T packed[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) packed[j] = from_f32<OUT_T>(v[j]);
#pragma unroll
  for (int q = 0; q < (int)(8 * sizeof(OUT_T)) / 16; ++q)
    reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(packed)[q];
}

template <bool BF16_OPS, int VEC, typename IN_T, typename OUT_T>
__global__ void __launch_bounds__(DFT_THREADS, DFT_MIN_BLOCKS) dft_rows(DftArgs a) {
  using S = DftShape<BF16_OPS>;
  using T = typename S::T;
  constexpr int KS = S::KS, LDA = S::LDA, LDB = S::LDB;
  __shared__ __align__(128) T as[2][KS * LDA];
  __shared__ __align__(128) T bs[2][KS * LDB];
  const DftTile t = dft_tile(a);
  const IN_T* brow = reinterpret_cast<const IN_T*>(a.b) + t.r * a.k_dim * a.c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float acc32[BF16_OPS ? 1 : 8][8];
  FragC acc16[BF16_OPS ? 2 : 1][4];
  if constexpr (BF16_OPS) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc16[i][j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc32[i][j] = 0.f;
  }

  BSlab<KS, VEC, IN_T> slab;
  const int n_slabs = (a.k_dim + KS - 1) / KS;
  stage_at<T, KS, LDA>(a, 0, t.m0, as[0]);
  slab.load(a, brow, 0, t.c0);
  slab.store(bs[0], LDB);
  cp_async_wait<0>();
  __syncthreads();
  for (int s = 0; s < n_slabs; ++s) {
    const int cur = s & 1;
    const bool next = s + 1 < n_slabs;
    // the other buffers were last read before the previous barrier
    if (next) {
      stage_at<T, KS, LDA>(a, (s + 1) * KS, t.m0, as[cur ^ 1]);
      slab.load(a, brow, (s + 1) * KS, t.c0);
    }
    if constexpr (BF16_OPS)
      mma_slab<KS, LDA, LDB>(acc16, as[cur], bs[cur], warp);
    else
      fma_slab<KS>(acc32, as[cur], bs[cur], lane, warp);
    if (next) {
      slab.store(bs[cur ^ 1], LDB);
      cp_async_wait<0>();
    }
    __syncthreads();
  }

  OUT_T* out = reinterpret_cast<OUT_T*>(a.out) + t.r * a.m_dim * a.c;
  if constexpr (BF16_OPS) {
    // past the last barrier: the first At buffer is the warps' scratch
    float* my = reinterpret_cast<float*>(as[0]) + warp * 256;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wmma::store_matrix_sync(my, acc16[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        if constexpr (VEC > 1) {  // lane: 8 channels of one of the 16 rows
          const int m = t.m0 + (2 * warp + i) * 16 + lane / 2;
          const int cc = t.c0 + j * 16 + (lane % 2) * 8;
          if (m < a.m_dim && cc < a.c) store8(out + (long long)m * a.c + cc, my + 8 * lane);
        } else {
          for (int e = lane; e < 256; e += 32) {
            const int m = t.m0 + (2 * warp + i) * 16 + e / 16;
            const int cc = t.c0 + j * 16 + e % 16;
            if (m < a.m_dim && cc < a.c)
              out[(long long)m * a.c + cc] = from_f32<OUT_T>(my[e]);
          }
        }
        __syncwarp();
      }
    }
  } else {
    const int c8 = t.c0 + 8 * warp;  // the thread's 8 channels
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = t.m0 + (i < 4 ? 4 * lane + i : 128 + 4 * lane + i - 4);
      if (m >= a.m_dim) continue;
      OUT_T* row = out + (long long)m * a.c;
      if constexpr (VEC > 1) {
        if (c8 < a.c) store8(row + c8, acc32[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (c8 + j < a.c) row[c8 + j] = from_f32<OUT_T>(acc32[i][j]);
      }
    }
  }
}

// Padding multiples of the prepared At: axis 0 (rows, k), axis 1 (columns, m)
inline int dft_padding(int axis) { return axis == 0 ? DFT_K_MULTIPLE : DFT_BM; }

template <bool BF16_OPS, int VEC, typename IN_T, typename OUT_T>
int dft_rows_launch_vec(const DftArgs& a, unsigned blocks, cudaStream_t stream) {
  dft_rows<BF16_OPS, VEC, IN_T, OUT_T><<<blocks, DFT_THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename IN_T, typename OUT_T>
int dft_rows_launch(DftArgs a, int bf16_ops, cudaStream_t stream) {
  if (a.rows < 1 || a.k_dim < 1 || a.m_dim < 1 || a.c < 1 || a.k_pad < a.k_dim ||
      a.k_pad % DFT_K_MULTIPLE || a.m_pad < a.m_dim || a.m_pad % DFT_BM)
    return (int)cudaErrorInvalidValue;
  a.m_tiles = (a.m_dim + DFT_BM - 1) / DFT_BM;
  a.c_tiles = (a.c + DFT_BN - 1) / DFT_BN;
  const long long blocks = a.rows * a.m_tiles * a.c_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  // 16-byte vectors of B and out where all their rows start 16-byte aligned
  // and every 8-channel group is whole
  constexpr int VEC = 16 / sizeof(IN_T);
  const bool vec = a.c % 8 == 0 && reinterpret_cast<uintptr_t>(a.b) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const unsigned n = (unsigned)blocks;
  if (bf16_ops)
    return vec ? dft_rows_launch_vec<true, VEC, IN_T, OUT_T>(a, n, stream)
               : dft_rows_launch_vec<true, 1, IN_T, OUT_T>(a, n, stream);
  return vec ? dft_rows_launch_vec<false, VEC, IN_T, OUT_T>(a, n, stream)
             : dft_rows_launch_vec<false, 1, IN_T, OUT_T>(a, n, stream);
}

}  // namespace
