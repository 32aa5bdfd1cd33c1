// Device pieces shared by the kernels of msfno_torch/csrc: activation loads,
// cp.async copies, bf16 WMMA tile GEMMs with fp32 accumulation, row-tile
// staging into shared memory, the exact GELU, the first MLP layer into a
// bf16 hidden tile, and the fixed-order reduce of per-block column
// statistics.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragACol = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float load_act(const void* p, long long i, int bf16) {
  return bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
              : reinterpret_cast<const float*>(p)[i];
}

// 16-byte global -> shared copy that bypasses registers; src_bytes == 0
// writes zeros without reading
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ float gelu_exact(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// acc[i] = a_smem[i-th row tile] @ b_global[:, col0:col0+16] over k_dim;
// PREFETCH weight fragments are in flight from L2 at any time
template <int ROW_TILES, int PREFETCH>
__device__ __forceinline__ void tile_gemm(FragC (&acc)[ROW_TILES],
                                          const __nv_bfloat16* a_smem, int lda,
                                          const __nv_bfloat16* b, int ldb, int col0,
                                          int k_dim) {
#pragma unroll
  for (int i = 0; i < ROW_TILES; ++i) wmma::fill_fragment(acc[i], 0.f);
  FragB bq[PREFETCH];
#pragma unroll
  for (int u = 0; u < PREFETCH; ++u)
    if (u * 16 < k_dim) wmma::load_matrix_sync(bq[u], b + (long long)u * 16 * ldb + col0, ldb);
  for (int k0 = 0; k0 < k_dim; k0 += 16 * PREFETCH) {
#pragma unroll
    for (int u = 0; u < PREFETCH; ++u) {
      const int k = k0 + u * 16;
      if (k < k_dim) {
#pragma unroll
        for (int i = 0; i < ROW_TILES; ++i) {
          FragA a;
          wmma::load_matrix_sync(a, a_smem + i * 16 * lda + k, lda);
          wmma::mma_sync(acc[i], a, bq[u], acc[i]);
        }
        const int kn = k + 16 * PREFETCH;
        if (kn < k_dim)
          wmma::load_matrix_sync(bq[u], b + (long long)kn * ldb + col0, ldb);
      }
    }
  }
}

// Copies rows [0, rows) x columns [0, c) of a row-major (., c) tile that
// starts at element `base` of `src` into shared columns [col0, col0 + c),
// rounded to bf16, optionally through the per-channel affine x * aff_a +
// aff_b (aff_b null: scale only).  The tile is one contiguous run of
// rows * c values, read as 16-byte vectors when aligned, four in flight.
template <bool BF16>
__device__ __forceinline__ void stage_tile(__nv_bfloat16* xs, int ldx, int col0,
                                           const void* src, long long base, int rows,
                                           int c, const float* aff_a, const float* aff_b) {
  constexpr int vw = BF16 ? 8 : 4;  // values per 16-byte vector
  const int count = rows * c;
  const char* p0 = reinterpret_cast<const char*>(src) + base * (BF16 ? 2 : 4);
  const bool vec = reinterpret_cast<uintptr_t>(p0) % 16 == 0;
  const int n_vec = vec ? count / vw : 0;
#pragma unroll 4
  for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
    const uint4 raw = reinterpret_cast<const uint4*>(p0)[v];
    float vals[vw];
    if constexpr (BF16) {
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) vals[e] = __bfloat162float(h[e]);
    } else {
      const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) vals[e] = f[e];
    }
#pragma unroll
    for (int e = 0; e < vw; ++e) {
      const int idx = v * vw + e;
      const int r = idx / c, k = idx - r * c;
      float x = vals[e];
      if (aff_a) x = x * aff_a[k] + (aff_b ? aff_b[k] : 0.f);
      xs[r * ldx + col0 + k] = __float2bfloat16_rn(x);
    }
  }
  for (int idx = n_vec * vw + threadIdx.x; idx < count; idx += blockDim.x) {
    const int r = idx / c, k = idx - r * c;
    float x = load_act(src, base + idx, BF16);
    if (aff_a) x = x * aff_a[k] + (aff_b ? aff_b[k] : 0.f);
    xs[r * ldx + col0 + k] = __float2bfloat16_rn(x);
  }
}

// First MLP layer of a (16 * ROW_TILES)-row tile: hs = bf16(gelu(xs @ w1 +
// b1)), w1 (k1p, hidden) bf16 with leading dimension ldw, in device or
// shared memory.  The block's n_warps warps split the hidden column tiles;
// `my` is the warp's 256-float scratch.
template <int ROW_TILES, int PREFETCH>
__device__ __forceinline__ void mlp_hidden(const __nv_bfloat16* xs, int ldx, int k1p,
                                           const __nv_bfloat16* w1, int ldw, const float* b1,
                                           int hidden, __nv_bfloat16* hs, int ldh,
                                           float* my, int warp, int lane, int n_warps) {
  for (int ct = warp; ct < hidden / 16; ct += n_warps) {
    FragC acc[ROW_TILES];
    tile_gemm<ROW_TILES, PREFETCH>(acc, xs, ldx, w1, ldw, ct * 16, k1p);
#pragma unroll
    for (int i = 0; i < ROW_TILES; ++i) {
      wmma::store_matrix_sync(my, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = i * 16 + e / 16;
        const int col = ct * 16 + (e % 16);
        hs[row * ldh + col] = __float2bfloat16_rn(gelu_exact(my[e] + b1[col]));
      }
      __syncwarp();
    }
  }
}

// Copies the (rows, cols) bf16 block at `src` (leading dimension lds) into
// shared memory with leading dimension ldd, as 16-byte vectors: cols, lds,
// ldd and the source offset are multiples of 8 elements.
__device__ __forceinline__ void copy_tile_bf16(__nv_bfloat16* dst, int ldd,
                                               const __nv_bfloat16* src, long long lds,
                                               int rows, int cols) {
  const int vpr = cols / 8;  // vectors per row
  for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
    const int r = v / vpr, c = (v - r * vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * ldd + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// Adds each sample's per-block column partials (n_samples, n_blocks, c_out)
// in a fixed order: thread (tx, ty) sums blocks ty, ty + 8, ... of column
// bx*32 + tx, then the 8 partial sums are added in ty order.  Launch with
// grid ((c_out + 31) / 32, n_samples) and block (32, 8).
__global__ void stats_reduce(const float* __restrict__ part_sum,
                             const float* __restrict__ part_sq,
                             int n_blocks, int c_out,
                             float* __restrict__ ssum, float* __restrict__ ssq) {
  __shared__ float sh_sum[8][32];
  __shared__ float sh_sq[8][32];
  const int s = blockIdx.y;
  const int c = blockIdx.x * 32 + threadIdx.x;
  float a = 0.f, b = 0.f;
  if (c < c_out) {
    for (int i = threadIdx.y; i < n_blocks; i += 8) {
      const long long j = ((long long)s * n_blocks + i) * c_out + c;
      a += part_sum[j];
      b += part_sq[j];
    }
  }
  sh_sum[threadIdx.y][threadIdx.x] = a;
  sh_sq[threadIdx.y][threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.y == 0 && c < c_out) {
    float ta = 0.f, tb = 0.f;
    for (int t = 0; t < 8; ++t) {
      ta += sh_sum[t][threadIdx.x];
      tb += sh_sq[t][threadIdx.x];
    }
    ssum[(long long)s * c_out + c] = ta;
    ssq[(long long)s * c_out + c] = tb;
  }
}

}  // namespace
