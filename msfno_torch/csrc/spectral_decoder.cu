// Fused inverse longitude DFT + norm/FiLM affine + big-skip decoder MLP,
// bf16 tensor-core GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/spectral_decoder.py:spectral_decoder (the
// Pallas `_spectral_decoder_call` TPU kernel).  Per latitude row (b, h):
//
//   t = bf16(hm[b, h] * a[b])                 (2M, C): scaled Legendre synthesis
//   x = Mt @ t + b[b]                          (W, C) fp32 grid row, Mt (W, 2M) bf16
//   y = gelu_exact(bf16(x) @ W1a + bf16(skip) @ W1b + b1) @ W2 [+ b2]
//   out = round(y, out dtype)
//
// with the GELU output rounded to bf16 before the second GEMM.  The grid-
// space field of the last block (721 x 1440 x 256) never reaches device
// memory.
//
// Bound on the H100 at the serving shapes: hm (1, 721, 242, 256) fp32 179
// MB + skip (1, 721, 1440, 73) fp32 303 MB + out (1, 721, 1440, 73) fp32
// 303 MB ~0.79 GB -> 0.23 ms; 2 * 1,038,240 * (242*256 + 329*256 + 256*73)
// = 3.4e11 FLOP -> 0.35 ms at 989 TFLOP/s bf16: operations.
//
// Design: grid_mlp's big-skip decoder with an inverse-DFT prologue.  A small
// first kernel writes t = bf16(hm * a) once, (B, H, 256, C) with zero rows
// past 2M = 242 (94.5 MB at the serving shapes).  The main kernel's block
// owns one latitude row and a 64-longitude chunk (1440 = 22*64 + 32: the
// last chunk is ragged and masked).  Per 64-row K-slab it copies the slab of
// t and the chunk's (64 x 64) Mt slab into shared memory with cp.async and
// accumulates the (64 x C) x = Mt[chunk] @ t in registers (each warp owns 2
// of the 16 channel tiles, so C <= 256).  It adds b, rounds x to bf16 into
// the MLP's input tile beside the bf16 skip, then runs the two MLP layers as
// grid_mlp.cu does (shared tile_common.cuh), writing y straight to device
// memory.  The t slabs and the hidden tile share one shared-memory region.
// Measured on the H100 at the serving shapes (tools/kernel_variants.py,
// chip_smoke.py): registers capped for two resident blocks per SM (6.4 ms,
// against 10.0 ms with one block and 224 registers); the bf16 t copied by
// cp.async instead of hm * a converted in the block (4.34 vs 5.81 ms).  Each t row (128 KB) is read by the 23 blocks
// of its latitude, ~2.2 GB of L2 traffic per call; keeping t rows on chip
// across chunks is left to a later change.

#include "tile_common.cuh"

namespace {

constexpr int CHUNK = 64;                // longitudes per block
constexpr int ROW_TILES = CHUNK / 16;
#ifndef WARPS_OVERRIDE
#define WARPS_OVERRIDE 8
#endif
constexpr int WARPS = WARPS_OVERRIDE;
constexpr int PAD = 8;
constexpr int PREFETCH = 2;
constexpr int SLAB = 64;                 // rows of t per staging pass
constexpr int C_MAX = 256;
constexpr int XCT_PER_WARP = C_MAX / 16 / WARPS;  // x column tiles per warp
#ifndef MINB_OVERRIDE
#define MINB_OVERRIDE 2
#endif
constexpr int MIN_BLOCKS = MINB_OVERRIDE;  // resident blocks per SM (register cap)

struct DecArgs {
  const void* hm;                // (B, H, two_m, c)
  __nv_bfloat16* t;              // (B, H, m2p, c) scratch: bf16(hm * a), zero rows past two_m
  const float* aff_a;            // (B, c)
  const float* aff_b;            // (B, c)
  const __nv_bfloat16* mt;       // (w_pad, m2p), zero rows past W and columns past two_m
  const void* skip;              // (B, H, W, s)
  const __nv_bfloat16* w1;       // (k1p, hidden): rows [0, c) main, [cmp, cmp + s) skip
  const float* b1;
  const __nv_bfloat16* w2;       // (hidden, n2p): zero columns past c_out
  const float* b2;
  void* out;                     // (B, H, W, c_out)
  int H, W, two_m, m2p, c, s, cmp, k1p, hidden, c_out, n2p;
  int hm_bf16, skip_bf16, out_bf16, has_b2;
  int ldx, ldh, ldt;
};

// t = bf16(hm * a) per (sample, channel), rows [two_m, m2p) zero: 8
// channels per thread, one 16-byte store
__global__ void scale_to_bf16(DecArgs a, long long n_vec) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  const long long e0 = v * 8;
  const int col = (int)(e0 % a.c);
  const long long row = e0 / a.c;  // (b * H + h) * m2p + m
  const int m = (int)(row % a.m2p);
  const long long bh = row / a.m2p;
  const float* sa = a.aff_a + (bh / a.H) * a.c + col;
  __align__(16) __nv_bfloat16 out[8];
  const long long src = (bh * a.two_m + m) * a.c + col;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    out[e] = __float2bfloat16_rn(m < a.two_m ? load_act(a.hm, src + e, a.hm_bf16) * sa[e] : 0.f);
  *reinterpret_cast<uint4*>(a.t + e0) = *reinterpret_cast<const uint4*>(out);
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) spectral_decoder_kernel(DecArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // CHUNK x ldx
  __nv_bfloat16* region = xs + CHUNK * a.ldx;  // t slab (SLAB x ldt), then hs (CHUNK x ldh)
  __nv_bfloat16* ts = region;
  __nv_bfloat16* hs = region;
  const int region_elems = max(SLAB * a.ldt, CHUNK * a.ldh);
  __nv_bfloat16* ms = region + region_elems;                         // CHUNK x (SLAB + PAD): Mt slab
  float* scratch = reinterpret_cast<float*>(ms + CHUNK * (SLAB + PAD));  // WARPS x 256

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * CHUNK;
  const int rows = min(CHUNK, a.W - w0);
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  const float* sb = a.aff_b + (long long)blockIdx.z * a.c;
  float* my = scratch + warp * 256;

  // inverse DFT of the chunk: x = Mt[w0:w0+CHUNK] @ t, t staged per K-slab
  FragC acc_x[ROW_TILES][XCT_PER_WARP];
  chunk_inverse_dft<ROW_TILES, XCT_PER_WARP, SLAB>(acc_x, a.t + bh * a.m2p * a.c, a.mt, w0,
                                                   a.m2p, a.c, ts, a.ldt, ms, warp, WARPS);

  // MLP input tile: [bf16(x + b) | bf16(skip)], zero padding and zero skip
  // rows past the end (x rows past the end are b: finite, never written)
  stage_decoder_input<ROW_TILES, XCT_PER_WARP>(xs, a.ldx, acc_x, nullptr, sb, a.c, a.cmp, a.s,
                                               a.k1p, a.skip, a.skip_bf16, (bh * a.W + w0) * a.s,
                                               rows, my, warp, lane, WARPS);
  __syncthreads();  // xs complete; every warp is past its reads of the t slab

  // first layer over [x | skip]: hs = bf16(gelu(xs @ w1 + b1))
  mlp_hidden<ROW_TILES, PREFETCH>(xs, a.ldx, a.k1p, a.w1, a.hidden, a.b1, a.hidden, hs,
                                  a.ldh, my,
                                  warp, lane, WARPS);
  __syncthreads();

  // second layer + b2, straight to device memory
  for (int ct = warp; ct < a.n2p / 16; ct += WARPS) {
    FragC acc[ROW_TILES];
    tile_gemm<ROW_TILES, PREFETCH>(acc, hs, a.ldh, a.w2, a.n2p, ct * 16, a.hidden);
    const int col = ct * 16 + (lane % 16);
    const bool col_ok = col < a.c_out;
    const float b2 = (a.has_b2 && col_ok) ? a.b2[col] : 0.f;
#pragma unroll
    for (int i = 0; i < ROW_TILES; ++i) {
      wmma::store_matrix_sync(my, acc[i], 16, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int row = i * 16 + lane / 16 + 2 * j;
        if (row < rows && col_ok) {
          const long long o = (bh * a.W + w0 + row) * a.c_out + col;
          const float y = my[lane + 32 * j] + b2;
          if (a.out_bf16)
            reinterpret_cast<__nv_bfloat16*>(a.out)[o] = __float2bfloat16_rn(y);
          else
            reinterpret_cast<float*>(a.out)[o] = y;
        }
      }
      __syncwarp();
    }
  }
}

enum Ptr { P_HM, P_A, P_B, P_MT, P_SKIP, P_W1, P_B1, P_W2, P_B2, P_OUT, P_T, N_PTRS };
enum Int { I_B, I_H, I_W, I_TWO_M, I_M2P, I_W_PAD, I_C, I_S, I_CMP, I_K1P, I_HIDDEN,
           I_C_OUT, I_N2P, I_HM_BF16, I_SKIP_BF16, I_OUT_BF16, I_HAS_B2, N_INTS };

}  // namespace

// Rows of the Mt operand must be padded to a multiple of this (zero rows).
extern "C" int spectral_decoder_chunk() { return CHUNK; }

// ptrs and ints follow the Ptr and Int enums above.
extern "C" int spectral_decoder_bf16(const void* const* ptrs, const long long* ints,
                                     void* stream) {
  DecArgs a;
  a.hm = ptrs[P_HM];
  a.aff_a = (const float*)ptrs[P_A];
  a.aff_b = (const float*)ptrs[P_B];
  a.mt = (const __nv_bfloat16*)ptrs[P_MT];
  a.skip = ptrs[P_SKIP];
  a.w1 = (const __nv_bfloat16*)ptrs[P_W1];
  a.b1 = (const float*)ptrs[P_B1];
  a.w2 = (const __nv_bfloat16*)ptrs[P_W2];
  a.b2 = (const float*)ptrs[P_B2];
  a.out = (void*)ptrs[P_OUT];
  a.t = (__nv_bfloat16*)ptrs[P_T];
  const int b = (int)ints[I_B];
  a.H = (int)ints[I_H];
  a.W = (int)ints[I_W];
  a.two_m = (int)ints[I_TWO_M];
  a.m2p = (int)ints[I_M2P];
  const long long w_pad = ints[I_W_PAD];
  a.c = (int)ints[I_C];
  a.s = (int)ints[I_S];
  a.cmp = (int)ints[I_CMP];
  a.k1p = (int)ints[I_K1P];
  a.hidden = (int)ints[I_HIDDEN];
  a.c_out = (int)ints[I_C_OUT];
  a.n2p = (int)ints[I_N2P];
  a.hm_bf16 = (int)ints[I_HM_BF16];
  a.skip_bf16 = (int)ints[I_SKIP_BF16];
  a.out_bf16 = (int)ints[I_OUT_BF16];
  a.has_b2 = (int)ints[I_HAS_B2];
  if (b < 1 || b > 65535 || a.H < 1 || a.H > 65535 || a.W < 1 || w_pad % CHUNK ||
      w_pad < a.W || a.two_m < 1 || a.m2p < a.two_m || a.m2p % 16 || a.c < 16 || a.c % 16 ||
      a.c > C_MAX || a.cmp != a.c || a.s < 1 || a.k1p < a.cmp + a.s || a.k1p % 16 ||
      a.hidden < 16 || a.hidden % 16 || a.c_out < 1 || a.n2p < a.c_out || a.n2p % 16)
    return (int)cudaErrorInvalidValue;
  a.ldx = a.k1p + PAD;
  a.ldh = a.hidden + PAD;
  a.ldt = a.c + PAD;
  const size_t region = (size_t)(SLAB * a.ldt > CHUNK * a.ldh ? SLAB * a.ldt : CHUNK * a.ldh);
  const size_t smem = ((size_t)CHUNK * a.ldx + region + (size_t)CHUNK * (SLAB + PAD)) *
                          sizeof(__nv_bfloat16) +
                      (size_t)WARPS * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(spectral_decoder_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_vec = (long long)b * a.H * a.m2p * a.c / 8;
  scale_to_bf16<<<(unsigned)((n_vec + 255) / 256), 256, 0, (cudaStream_t)stream>>>(a, n_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.W + CHUNK - 1) / CHUNK, a.H, b);
  spectral_decoder_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
