// Pointwise two-layer grid MLP with fused epilogues, bf16 tensor-core GEMMs
// (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/grid_mlp.py:grid_mlp (the Pallas
// `_grid_mlp_call` TPU kernel, also reached through `_grid_mlp_with_stats`).
// Per pixel row:
//
//   u = A_s * x + B_s                  (optional per-sample channel affine)
//   h = gelu_exact(u @ W1a [+ skip @ W1b] + b1)
//   y = h @ W2 [+ b2] [+ pe[row % pe_rows]] [+ res]
//   out = round(y, out dtype);  optionally per-sample sum(y), sum(y*y)
//
// One kernel covers the three call sites of the serving step: the encoder
// (73 -> 256 -> 256, + pe, + stats), the inner block MLPs (256 -> 512 -> 256,
// + b2) and the big-skip decoder (256 + 73 -> 256 -> 73).
//
// Bound on the H100: the full-resolution encoder and decoder move ~1.37 GB
// and ~1.14 GB for ~1.7e11 FLOP each, so they are bound by memory traffic
// (~0.41 ms and ~0.34 ms at 3.35 TB/s); the hidden activation never leaves
// the chip.
//
// Design: a block owns TILE_ROWS pixel rows of one sample.  It stages the
// (affine-applied) input row tile in shared memory as bf16, runs the first
// GEMM with WMMA, applies b1 and the exact GELU (erff; the TPU kernel's
// polynomial erf was a Mosaic workaround) and keeps the bf16 hidden tile in
// shared memory, then runs the second GEMM and the epilogue straight to
// device memory.  Weights stream from L2.  The positional embedding is
// indexed as row % pe_rows, so no tile has to divide H*W.  The TPU kernel
// accumulates the per-sample statistics across its sequential grid; CUDA
// blocks run in no order, so here each block writes its column partial sums
// and a second kernel adds the partials of each sample in a fixed order:
// deterministic, and within ~1e-6 relative of a single fp32 sum.

#include "tile_common.cuh"

namespace {

#ifndef TILE_ROWS_OVERRIDE
#define TILE_ROWS_OVERRIDE 64
#endif
constexpr int TILE_ROWS = TILE_ROWS_OVERRIDE;
constexpr int ROW_TILES = TILE_ROWS / 16;
#ifndef WARPS_OVERRIDE
#define WARPS_OVERRIDE 8
#endif
constexpr int WARPS = WARPS_OVERRIDE;
constexpr int PAD = 8;
#ifndef PREFETCH_OVERRIDE
#define PREFETCH_OVERRIDE 2
#endif
constexpr int PREFETCH = PREFETCH_OVERRIDE;

struct GridArgs {
  const void* x;
  const void* skip;
  const float* aff_a;
  const float* aff_b;
  const __nv_bfloat16* w1;  // (k1p, hidden): main rows, zeros to cmp, skip rows, zeros
  const float* b1;
  const __nv_bfloat16* w2;  // (hidden, n2p): zero columns past c_out
  const float* b2;
  const void* pe;
  const void* res;
  void* out;
  float* part_sum;          // (n_samples, gridDim.x, c_out)
  float* part_sq;
  long long rows_per_sample;
  long long pe_rows;
  int c_main, c_skip, cmp, k1p, hidden, c_out, n2p;
  int x_bf16, skip_bf16, pe_bf16, res_bf16, out_bf16;
  int has_skip, has_aff, has_b2, has_pe, has_res, has_stats;
  int ldx, ldh;
};

__global__ void __launch_bounds__(WARPS * 32) grid_mlp_kernel(GridArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* hs = xs + TILE_ROWS * a.ldx;
  float* scratch = reinterpret_cast<float*>(hs + TILE_ROWS * a.ldh);
  float* col_sum = scratch + WARPS * 256;
  float* col_sq = col_sum + a.n2p;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int s = blockIdx.y;
  const long long r_begin = (long long)blockIdx.x * TILE_ROWS;
  const long long left = a.rows_per_sample - r_begin;
  const int rows = left < TILE_ROWS ? (int)left : TILE_ROWS;
  const long long g0 = (long long)s * a.rows_per_sample + r_begin;
  float* my = scratch + warp * 256;

  for (int c = threadIdx.x; c < a.n2p; c += blockDim.x) {
    col_sum[c] = 0.f;
    col_sq[c] = 0.f;
  }

  // stage the [affine(x) | skip] row tile as bf16: padding and rows past the
  // end are zero
  const int skip_end = a.has_skip ? a.cmp + a.c_skip : a.cmp;
  for (int idx = threadIdx.x; idx < TILE_ROWS * a.k1p; idx += blockDim.x) {
    const int r = idx / a.k1p;
    const int k = idx - r * a.k1p;
    if (r >= rows || (k >= a.c_main && k < a.cmp) || k >= skip_end)
      xs[r * a.ldx + k] = __float2bfloat16_rn(0.f);
  }
  const float* aa = a.has_aff ? a.aff_a + (long long)s * a.c_main : nullptr;
  const float* ab = a.has_aff ? a.aff_b + (long long)s * a.c_main : nullptr;
  if (a.x_bf16) stage_tile<true>(xs, a.ldx, 0, a.x, g0 * a.c_main, rows, a.c_main, aa, ab);
  else stage_tile<false>(xs, a.ldx, 0, a.x, g0 * a.c_main, rows, a.c_main, aa, ab);
  if (a.has_skip) {
    if (a.skip_bf16)
      stage_tile<true>(xs, a.ldx, a.cmp, a.skip, g0 * a.c_skip, rows, a.c_skip, nullptr, nullptr);
    else
      stage_tile<false>(xs, a.ldx, a.cmp, a.skip, g0 * a.c_skip, rows, a.c_skip, nullptr, nullptr);
  }
  __syncthreads();

  // first GEMM: hs = bf16(gelu(xs @ w1 + b1))
  mlp_hidden<ROW_TILES, PREFETCH>(xs, a.ldx, a.k1p, a.w1, a.hidden, a.b1, a.hidden, hs,
                                  a.ldh, my,
                                  warp, lane, WARPS);
  __syncthreads();

  // second GEMM + epilogue; a lane always sees the same column of its tile
  for (int ct = warp; ct < a.n2p / 16; ct += WARPS) {
    FragC acc[ROW_TILES];
    tile_gemm<ROW_TILES, PREFETCH>(acc, hs, a.ldh, a.w2, a.n2p, ct * 16, a.hidden);
    const int col = ct * 16 + (lane % 16);
    const bool col_ok = col < a.c_out;
    const float b2 = (a.has_b2 && col_ok) ? a.b2[col] : 0.f;
    float csum = 0.f, csq = 0.f;
#pragma unroll
    for (int i = 0; i < ROW_TILES; ++i) {
      wmma::store_matrix_sync(my, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
      // the pe / residual loads of the lane's 8 values go out before any store
      float extra[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = i * 16 + lane / 16 + 2 * j;
        const long long g = g0 + row;
        float v = 0.f;
        if (row < rows && col_ok) {
          if (a.has_pe) v += load_act(a.pe, (g % a.pe_rows) * a.c_out + col, a.pe_bf16);
          if (a.has_res) v += load_act(a.res, g * a.c_out + col, a.res_bf16);
        }
        extra[j] = v;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = i * 16 + lane / 16 + 2 * j;
        if (row < rows && col_ok) {
          const long long g = g0 + row;
          const float y = my[lane + 32 * j] + b2 + extra[j];
          if (a.out_bf16)
            reinterpret_cast<__nv_bfloat16*>(a.out)[g * a.c_out + col] = __float2bfloat16_rn(y);
          else
            reinterpret_cast<float*>(a.out)[g * a.c_out + col] = y;
          csum += y;
          csq += y * y;
        }
      }
      __syncwarp();
    }
    if (a.has_stats) {
      csum += __shfl_down_sync(0xffffffffu, csum, 16);
      csq += __shfl_down_sync(0xffffffffu, csq, 16);
      if (lane < 16) {  // this warp alone owns column tile ct
        col_sum[col] = csum;
        col_sq[col] = csq;
      }
    }
  }
  if (a.has_stats) {
    __syncthreads();
    const long long base = ((long long)s * gridDim.x + blockIdx.x) * a.c_out;
    for (int c = threadIdx.x; c < a.c_out; c += blockDim.x) {
      a.part_sum[base + c] = col_sum[c];
      a.part_sq[base + c] = col_sq[c];
    }
  }
}

enum Ptr { P_X, P_SKIP, P_AFF_A, P_AFF_B, P_W1, P_B1, P_W2, P_B2, P_PE, P_RES, P_OUT,
           P_PART_SUM, P_PART_SQ, P_SSUM, P_SSQ, N_PTRS };
enum Int { I_N_SAMPLES, I_ROWS_PER_SAMPLE, I_PE_ROWS, I_C_MAIN, I_C_SKIP, I_CMP, I_K1P,
           I_HIDDEN, I_C_OUT, I_N2P, I_X_BF16, I_SKIP_BF16, I_PE_BF16, I_RES_BF16,
           I_OUT_BF16, I_HAS_SKIP, I_HAS_AFF, I_HAS_B2, I_HAS_PE, I_HAS_RES, I_HAS_STATS,
           N_INTS };

}  // namespace

extern "C" int grid_mlp_n_blocks(long long rows_per_sample) {
  return (int)((rows_per_sample + TILE_ROWS - 1) / TILE_ROWS);
}

// ptrs and ints follow the Ptr and Int enums above; part_sum/part_sq hold
// n_samples * grid_mlp_n_blocks(rows_per_sample) * c_out floats when stats
// are requested.
extern "C" int grid_mlp_bf16(const void* const* ptrs, const long long* ints, void* stream) {
  GridArgs a;
  a.x = ptrs[P_X];
  a.skip = ptrs[P_SKIP];
  a.aff_a = (const float*)ptrs[P_AFF_A];
  a.aff_b = (const float*)ptrs[P_AFF_B];
  a.w1 = (const __nv_bfloat16*)ptrs[P_W1];
  a.b1 = (const float*)ptrs[P_B1];
  a.w2 = (const __nv_bfloat16*)ptrs[P_W2];
  a.b2 = (const float*)ptrs[P_B2];
  a.pe = ptrs[P_PE];
  a.res = ptrs[P_RES];
  a.out = (void*)ptrs[P_OUT];
  a.part_sum = (float*)ptrs[P_PART_SUM];
  a.part_sq = (float*)ptrs[P_PART_SQ];
  const int n_samples = (int)ints[I_N_SAMPLES];
  a.rows_per_sample = ints[I_ROWS_PER_SAMPLE];
  a.pe_rows = ints[I_PE_ROWS] > 0 ? ints[I_PE_ROWS] : 1;
  a.c_main = (int)ints[I_C_MAIN];
  a.c_skip = (int)ints[I_C_SKIP];
  a.cmp = (int)ints[I_CMP];
  a.k1p = (int)ints[I_K1P];
  a.hidden = (int)ints[I_HIDDEN];
  a.c_out = (int)ints[I_C_OUT];
  a.n2p = (int)ints[I_N2P];
  a.x_bf16 = (int)ints[I_X_BF16];
  a.skip_bf16 = (int)ints[I_SKIP_BF16];
  a.pe_bf16 = (int)ints[I_PE_BF16];
  a.res_bf16 = (int)ints[I_RES_BF16];
  a.out_bf16 = (int)ints[I_OUT_BF16];
  a.has_skip = (int)ints[I_HAS_SKIP];
  a.has_aff = (int)ints[I_HAS_AFF];
  a.has_b2 = (int)ints[I_HAS_B2];
  a.has_pe = (int)ints[I_HAS_PE];
  a.has_res = (int)ints[I_HAS_RES];
  a.has_stats = (int)ints[I_HAS_STATS];
  if (n_samples < 1 || n_samples > 65535 || a.rows_per_sample < 1 || a.k1p % 16 ||
      a.hidden % 16 || a.n2p % 16 || a.k1p < 16 || a.hidden < 16 || a.n2p < 16)
    return (int)cudaErrorInvalidValue;
  a.ldx = a.k1p + PAD;
  a.ldh = a.hidden + PAD;
  const size_t smem = (size_t)TILE_ROWS * (a.ldx + a.ldh) * sizeof(__nv_bfloat16) +
                      (size_t)WARPS * 256 * sizeof(float) + 2 * (size_t)a.n2p * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      grid_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = grid_mlp_n_blocks(a.rows_per_sample);
  dim3 grid(n_blocks, n_samples);
  grid_mlp_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || !a.has_stats) return (int)err;
  dim3 rgrid((a.c_out + 31) / 32, n_samples);
  stats_reduce<<<rgrid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
      a.part_sum, a.part_sq, n_blocks, a.c_out, (float*)ptrs[P_SSUM], (float*)ptrs[P_SSQ]);
  return (int)cudaGetLastError();
}
