// Fused encoder MLP + positional embedding + instance-norm statistics +
// truncated forward longitude DFT, bf16 tensor-core GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/grid_mlp.py:grid_encoder_spectral (the
// Pallas `_grid_encoder_spectral_call` TPU kernel).  Per pixel row of a
// latitude (b, h):
//
//   y[w] = gelu_exact(x[w] @ W1 + b1) @ W2 [+ pe[h, w]]     (fp32)
//   ssum += y, ssq += y*y                                    (fp32, pre-rounding)
//   f[b, h, m, :] = sum_w cs[w, m] * bf16(y[w])              (fp32 accumulation)
//
// with x, h and y rounded to bf16 before each GEMM, cs (W, 2M) the merged
// [C | -S] analysis matrix in bf16, and f rounded to the output dtype at
// the write.  The 721 x 1440 x 256 grid-space encoder output never reaches
// device memory.
//
// Bound on the H100 at the serving shapes: x (1, 721, 1440, 73) fp32 303 MB
// + pe (721, 1440, 256) bf16 531 MB + f (1, 721, 242, 256) bf16 89 MB ~0.92
// GB -> 0.28 ms; 2 * 1,038,240 * (73*256 + 256*256 + 242*256) = 3.0e11 FLOP
// -> 0.31 ms at 989 TFLOP/s bf16: operations, with the bytes nearly as large.
//
// Design: the TPU kernel keeps a whole latitude row of y (1440 x 256 fp32,
// 1.47 MB) in VMEM and carries the statistics across its sequential grid;
// neither carries over.  Here a block of 16 warps owns one latitude row and
// one 128-channel slice of C; W1 and its slice of W2 stay in shared memory
// while it walks the row in 64-pixel chunks (the last chunk of 1440 =
// 22*64 + 32 is ragged and masked).  Per chunk it copies the chunk's pe rows
// to shared memory with cp.async while it stages x as bf16 and recomputes
// the first layer (73 -> 256) into a bf16 shared tile (+13% FLOPs at the
// serving shapes); computes its 128 output channels of the second layer
// (two warps per column tile, each on half the rows), adds pe, keeps the
// fp32 column sums in registers; rounds y to bf16 in shared memory and
// accumulates the (2M x 128) fp32 DFT product cs[chunk]^T @ y in registers,
// each warp one of the 16 mode row tiles (2M <= 256), cs streaming from L2
// as col-major A fragments.  Measured on the H100 at the serving shapes
// (tools/kernel_variants.py): 8 warps owning 2 mode tiles each needed 250
// registers and took 10.3 ms; 16 warps 8.4 ms; resident weights 7.7 ms; the
// pe prefetch 6.7 ms.  The
// statistics follow grid_mlp.cu: each block writes its row's column sums,
// and a second small kernel adds the H rows of each sample in a fixed order
// (deterministic, no atomics).

#include "tile_common.cuh"

namespace {

constexpr int CHUNK = 64;                // pixels of a row per pass
constexpr int ROW_TILES = CHUNK / 16;
#ifndef WARPS_OVERRIDE
#define WARPS_OVERRIDE 16
#endif
constexpr int WARPS = WARPS_OVERRIDE;
constexpr int PAD = 8;
constexpr int PREFETCH = 2;
#ifndef CB_OVERRIDE
#define CB_OVERRIDE 128
#endif
constexpr int CB = CB_OVERRIDE;          // output channels per block
constexpr int CT_MAX = CB / 16;          // their column tiles (<= WARPS)
#ifndef MINB_OVERRIDE
#define MINB_OVERRIDE 1
#endif
constexpr int MIN_BLOCKS = MINB_OVERRIDE;  // resident blocks per SM (register cap)
constexpr int M2P_MAX = 256;             // 2M, padded
// DFT accumulators: the 16 mode row tiles x CT_MAX column tiles split over
// the warps, MT_PER_WARP mode tiles (strided by N_MGROUPS) and CT_PER_WARP
// consecutive column tiles each
#ifndef DFT_MT_OVERRIDE
#define DFT_MT_OVERRIDE (M2P_MAX / 16 / WARPS)
#endif
constexpr int MT_PER_WARP = DFT_MT_OVERRIDE;
constexpr int N_MGROUPS = M2P_MAX / 16 / MT_PER_WARP;
constexpr int CT_PER_WARP = CT_MAX * N_MGROUPS / WARPS;
static_assert(N_MGROUPS * MT_PER_WARP * 16 == M2P_MAX && WARPS % N_MGROUPS == 0 &&
              CT_PER_WARP * WARPS == CT_MAX * N_MGROUPS, "DFT tile split");
// second layer: FC2_SPLIT warps share a column tile, each on its own rows
constexpr int FC2_SPLIT = WARPS / CT_MAX;
constexpr int FC2_ROW_TILES = ROW_TILES / FC2_SPLIT;
static_assert(FC2_SPLIT * CT_MAX == WARPS && FC2_ROW_TILES * FC2_SPLIT == ROW_TILES,
              "CB / 16 must divide WARPS, and WARPS / (CB / 16) must divide CHUNK / 16");

struct EncArgs {
  const void* x;                 // (B, H, W, c_in)
  const __nv_bfloat16* w1;       // (k1p, hidden), zero rows past c_in
  const float* b1;               // (hidden,)
  const __nv_bfloat16* w2;       // (hidden, c)
  const void* pe;                // (H, W, c) or null
  const __nv_bfloat16* cs;       // (w_pad, m2p), zero rows past W and columns past two_m
  void* f;                       // (B, H, two_m, c)
  float* part_sum;               // (B, H, c): one row's column sums
  float* part_sq;
  int H, W, c_in, k1p, hidden, c, two_m, m2p;
  int x_bf16, pe_bf16, f_bf16, has_pe;
  int ldx, ldh, ldy, ldp;        // ldp in bytes
};

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
grid_encoder_spectral_kernel(EncArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // CHUNK x ldx
  __nv_bfloat16* hs = xs + CHUNK * a.ldx;                            // CHUNK x ldh
  __nv_bfloat16* ys = hs + CHUNK * a.ldh;                            // CHUNK x ldy
  __nv_bfloat16* w1s = ys + CHUNK * a.ldy;                           // k1p x ldh: W1
  __nv_bfloat16* w2s = w1s + a.k1p * a.ldh;                          // hidden x ldy: W2 slice
  // this chunk's pe rows of the block's channels, raw: CHUNK x ldp bytes
  unsigned char* pes = reinterpret_cast<unsigned char*>(w2s + a.hidden * a.ldy);
  float* scratch = reinterpret_cast<float*>(pes + CHUNK * a.ldp);    // WARPS x 256
  float* col_part = scratch + WARPS * 256;                           // 2 x FC2_SPLIT x CB

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * CB;
  const int n_ct = min(CB, a.c - c0) / 16;
  const int h = blockIdx.y;
  const long long bh = (long long)blockIdx.z * a.H + h;
  const long long px0 = bh * a.W;            // first pixel of this row in x
  const long long pe0 = (long long)h * a.W;  // first pixel of this row in pe
  const int n_mt = a.m2p / 16;
  float* my = scratch + warp * 256;
  // the weights stay in shared memory across the row's chunks; visible
  // after the first barrier
  copy_tile_bf16(w1s, a.ldh, a.w1, a.hidden, a.k1p, a.hidden);
  copy_tile_bf16(w2s, a.ldy, a.w2 + c0, a.c, a.hidden, n_ct * 16);

  const int mg = warp % N_MGROUPS;               // mode tiles mg + u * N_MGROUPS
  const int ct0 = (warp / N_MGROUPS) * CT_PER_WARP;  // column tiles ct0 + j
  FragC acc_f[MT_PER_WARP][CT_PER_WARP];
#pragma unroll
  for (int u = 0; u < MT_PER_WARP; ++u)
#pragma unroll
    for (int j = 0; j < CT_PER_WARP; ++j) wmma::fill_fragment(acc_f[u][j], 0.f);
  // second-layer work of this warp: column tile fct, row tiles from fr0;
  // the column sums of its rows, lane % 16 its column
  const int fct = warp % CT_MAX;
  const int fg = warp / CT_MAX;
  const int fr0 = fg * FC2_ROW_TILES * 16;
  float csum = 0.f, csq = 0.f;

  for (int w0 = 0; w0 < a.W; w0 += CHUNK) {
    const int rows = min(CHUNK, a.W - w0);
    __syncthreads();  // the previous chunk's tiles are no longer read

    // the chunk's pe rows go to shared memory while x is staged and the
    // first layer runs
    const int pe_size = a.pe_bf16 ? 2 : 4;
    if (a.has_pe) {
      const int vpr = n_ct * pe_size;  // 16-byte vectors per row: n_ct * 16 values
      const unsigned char* src = reinterpret_cast<const unsigned char*>(a.pe) +
                                 ((pe0 + w0) * a.c + c0) * pe_size;
      for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
        const int r = v / vpr, q = v - r * vpr;
        cp_async16(pes + r * a.ldp + q * 16, src + (long long)r * a.c * pe_size + q * 16, 16);
      }
    }
    cp_async_commit();

    // stage x as bf16: padding columns and rows past the end are zero
    for (int idx = threadIdx.x; idx < CHUNK * a.k1p; idx += blockDim.x) {
      const int r = idx / a.k1p;
      const int k = idx - r * a.k1p;
      if (r >= rows || k >= a.c_in) xs[r * a.ldx + k] = __float2bfloat16_rn(0.f);
    }
    if (a.x_bf16)
      stage_tile<true>(xs, a.ldx, 0, a.x, (px0 + w0) * a.c_in, rows, a.c_in, nullptr, nullptr);
    else
      stage_tile<false>(xs, a.ldx, 0, a.x, (px0 + w0) * a.c_in, rows, a.c_in, nullptr, nullptr);
    __syncthreads();

    // first layer, all hidden channels: hs = bf16(gelu(xs @ w1 + b1))
    mlp_hidden<ROW_TILES, PREFETCH>(xs, a.ldx, a.k1p, w1s, a.ldh, a.b1, a.hidden, hs, a.ldh,
                                    my, warp, lane, WARPS);
    cp_async_wait<0>();
    __syncthreads();

    // second layer, this block's channels: y = hs @ w2 [+ pe]; statistics
    // of the fp32 y, then ys = bf16(y) with zero rows past the end
    if (fct < n_ct) {
      FragC acc[FC2_ROW_TILES];
      tile_gemm<FC2_ROW_TILES, PREFETCH>(acc, hs + fr0 * a.ldh, a.ldh, w2s, a.ldy, fct * 16,
                                         a.hidden);
      const int col = fct * 16 + (lane % 16);
#pragma unroll
      for (int i = 0; i < FC2_ROW_TILES; ++i) {
        wmma::store_matrix_sync(my, acc[i], 16, wmma::mem_row_major);
        __syncwarp();
        float extra[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int row = fr0 + i * 16 + lane / 16 + 2 * j;
          extra[j] = (a.has_pe && row < rows)
                         ? load_act(pes + row * a.ldp, col, a.pe_bf16)
                         : 0.f;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int row = fr0 + i * 16 + lane / 16 + 2 * j;
          float y = 0.f;
          if (row < rows) {
            y = my[lane + 32 * j] + extra[j];
            csum += y;
            csq += y * y;
          }
          ys[row * a.ldy + col] = __float2bfloat16_rn(y);
        }
        __syncwarp();
      }
    }
    __syncthreads();

    // forward DFT of the chunk: acc_f[u][j] += cs[w0:w0+CHUNK, mt]^T @ ys[:, ct]
#pragma unroll
    for (int k = 0; k < CHUNK; k += 16) {
      FragACol ca[MT_PER_WARP];
#pragma unroll
      for (int u = 0; u < MT_PER_WARP; ++u) {
        const int mt = mg + u * N_MGROUPS;
        if (mt < n_mt)
          wmma::load_matrix_sync(ca[u], a.cs + (long long)(w0 + k) * a.m2p + mt * 16, a.m2p);
      }
#pragma unroll
      for (int j = 0; j < CT_PER_WARP; ++j) {
        if (ct0 + j < n_ct) {
          FragB yb;
          wmma::load_matrix_sync(yb, ys + k * a.ldy + (ct0 + j) * 16, a.ldy);
#pragma unroll
          for (int u = 0; u < MT_PER_WARP; ++u)
            if (mg + u * N_MGROUPS < n_mt) wmma::mma_sync(acc_f[u][j], ca[u], yb, acc_f[u][j]);
        }
      }
    }
  }

  // f rows of this warp's mode tiles, rounded at the write
#pragma unroll
  for (int u = 0; u < MT_PER_WARP; ++u) {
    const int mt = mg + u * N_MGROUPS;
    if (mt >= n_mt) continue;
#pragma unroll
    for (int j = 0; j < CT_PER_WARP; ++j) {
      if (ct0 + j >= n_ct) continue;
      wmma::store_matrix_sync(my, acc_f[u][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int m = mt * 16 + e / 16;
        if (m < a.two_m) {
          const long long o = (bh * a.two_m + m) * a.c + c0 + (ct0 + j) * 16 + (e % 16);
          if (a.f_bf16)
            reinterpret_cast<__nv_bfloat16*>(a.f)[o] = __float2bfloat16_rn(my[e]);
          else
            reinterpret_cast<float*>(a.f)[o] = my[e];
        }
      }
      __syncwarp();
    }
  }

  // this row's column sums: lanes l and l + 16 hold two row halves of a
  // warp's rows, and the FC2_SPLIT warps of a column tile are added in order
  csum += __shfl_down_sync(0xffffffffu, csum, 16);
  csq += __shfl_down_sync(0xffffffffu, csq, 16);
  if (fct < n_ct && lane < 16) {
    col_part[fg * CB + fct * 16 + lane] = csum;
    col_part[(FC2_SPLIT + fg) * CB + fct * 16 + lane] = csq;
  }
  __syncthreads();
  for (int col = threadIdx.x; col < n_ct * 16; col += blockDim.x) {
    float ps = 0.f, pq = 0.f;
    for (int g = 0; g < FC2_SPLIT; ++g) {
      ps += col_part[g * CB + col];
      pq += col_part[(FC2_SPLIT + g) * CB + col];
    }
    a.part_sum[bh * a.c + c0 + col] = ps;
    a.part_sq[bh * a.c + c0 + col] = pq;
  }
}

enum Ptr { P_X, P_W1, P_B1, P_W2, P_PE, P_CS, P_F, P_PART_SUM, P_PART_SQ, P_SSUM, P_SSQ,
           N_PTRS };
enum Int { I_B, I_H, I_W, I_C_IN, I_K1P, I_HIDDEN, I_C, I_TWO_M, I_M2P, I_W_PAD, I_X_BF16,
           I_PE_BF16, I_F_BF16, I_HAS_PE, N_INTS };

}  // namespace

// Rows of the cs operand must be padded to a multiple of this (zero rows).
extern "C" int grid_encoder_spectral_chunk() { return CHUNK; }

// ptrs and ints follow the Ptr and Int enums above; part_sum/part_sq hold
// B * H * c floats.
extern "C" int grid_encoder_spectral_bf16(const void* const* ptrs, const long long* ints,
                                          void* stream) {
  EncArgs a;
  a.x = ptrs[P_X];
  a.w1 = (const __nv_bfloat16*)ptrs[P_W1];
  a.b1 = (const float*)ptrs[P_B1];
  a.w2 = (const __nv_bfloat16*)ptrs[P_W2];
  a.pe = ptrs[P_PE];
  a.cs = (const __nv_bfloat16*)ptrs[P_CS];
  a.f = (void*)ptrs[P_F];
  a.part_sum = (float*)ptrs[P_PART_SUM];
  a.part_sq = (float*)ptrs[P_PART_SQ];
  const int b = (int)ints[I_B];
  a.H = (int)ints[I_H];
  a.W = (int)ints[I_W];
  a.c_in = (int)ints[I_C_IN];
  a.k1p = (int)ints[I_K1P];
  a.hidden = (int)ints[I_HIDDEN];
  a.c = (int)ints[I_C];
  a.two_m = (int)ints[I_TWO_M];
  a.m2p = (int)ints[I_M2P];
  const long long w_pad = ints[I_W_PAD];
  a.x_bf16 = (int)ints[I_X_BF16];
  a.pe_bf16 = (int)ints[I_PE_BF16];
  a.f_bf16 = (int)ints[I_F_BF16];
  a.has_pe = (int)ints[I_HAS_PE];
  if (b < 1 || b > 65535 || a.H < 1 || a.H > 65535 || a.W < 1 || w_pad % CHUNK ||
      w_pad < a.W || a.c_in < 1 || a.k1p < a.c_in || a.k1p % 16 || a.hidden < 16 ||
      a.hidden % 16 || a.c < 16 || a.c % 16 || a.two_m < 1 || a.m2p < a.two_m ||
      a.m2p % 16 || a.m2p > M2P_MAX)
    return (int)cudaErrorInvalidValue;
  a.ldx = a.k1p + PAD;
  a.ldh = a.hidden + PAD;
  a.ldy = CB + PAD;
  a.ldp = CB * (a.pe_bf16 ? 2 : 4) + 16;
  const size_t smem = ((size_t)CHUNK * (a.ldx + a.ldh + a.ldy) + (size_t)a.k1p * a.ldh +
                       (size_t)a.hidden * a.ldy) *
                          sizeof(__nv_bfloat16) +
                      (size_t)CHUNK * a.ldp +
                      ((size_t)WARPS * 256 + 2 * FC2_SPLIT * CB) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(grid_encoder_spectral_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.c + CB - 1) / CB, a.H, b);
  grid_encoder_spectral_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 rgrid((a.c + 31) / 32, b);
  stats_reduce<<<rgrid, dim3(32, 8), 0, (cudaStream_t)stream>>>(
      a.part_sum, a.part_sq, a.H, a.c, (float*)ptrs[P_SSUM], (float*)ptrs[P_SSQ]);
  return (int)cudaGetLastError();
}
