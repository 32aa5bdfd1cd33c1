// Backward of the fused inverse longitude DFT + norm/FiLM affine + big-skip
// decoder MLP, bf16 tensor-core GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/spectral_decoder.py:_spectral_decoder_bwd_call
// (the Pallas `_make_bwd_kernel` TPU kernel).  Per latitude row (b, h), with
// the row recomputed from the forward's inputs:
//
//   x_raw = Mt @ bf16(hm[b, h])               (W, C) fp32
//   xa = x_raw * a[b] + b[b];  z1 = bf16(xa) @ W1a + bf16(skip) @ W1b + b1
//   dz1 = (bf16(g) @ W2^T) * gelu'(z1)
//   dxa = bf16(dz1) @ W1a^T;   dskip = bf16(dz1) @ W1b^T
//   dhm[b, h] = a[b] * (Mt^T @ bf16(dxa))
//   da[b] = sum dxa * x_raw;  db[b] = sum dxa   (over the sample's pixels)
//   dW1 = [bf16(xa) | bf16(skip)]^T bf16(dz1);  db1 = sum dz1
//   dW2 = bf16(gelu(z1))^T bf16(g);            db2 = sum g
//
// GELU is exact (erff), as in the forward kernels.
//
// Bound on the H100 at the serving shapes (g and skip (1, 721, 1440, 73)
// fp32, hm (1, 721, 242, 256) fp32): 2 * 1,038,240 * (2*242*256 + 3*329*256
// + 2*256*73) = 8.6e11 FLOP -> 0.87 ms at 989 TFLOP/s bf16, against ~1.3 GB
// (g, skip, dskip, hm, dhm) -> 0.38 ms: operations.
//
// Design: the TPU kernel recomputes one latitude row in VMEM and
// accumulates da, db and the weight gradients in output blocks revisited by
// every step of its sequential grid.  Here:
//   1. a pre-pass writes t = bf16(hm), zero rows past 2M;
//   2. `decoder_bwd_rows`: a block per latitude row and 64-longitude chunk
//      recomputes x_raw as the forward kernel does (t and Mt K-slabs by
//      cp.async, x_raw kept in registers), then per hidden column tile z1
//      and dh1 and their product dz1, the transposed MLP with W1 and W2 read
//      as col-major fragments (no stored transpose), dskip (written), dxa
//      (written in bf16 for pass 3) and per-block column partials of
//      dxa * x_raw and dxa; for weight gradients also the bf16 operands of
//      dW1 and dW2 and partials of dz1 and g.  Its 104 KB of shared memory
//      (dz1 over the t slab) and a register cap (spilling 448 bytes) fit two
//      blocks per SM: 10.5 ms against 11.5 ms with one block and 250
//      registers at the serving shapes (tools/kernel_variants.py on an
//      NVIDIA H100 80GB HBM3 at 700 W);
//   3. `decoder_bwd_dhm`: dhm, the transposed DFT, is a reduction over the
//      row's 23 chunks into a (242 x 256) fp32 row, larger than shared
//      memory: it walks the row as the head kernel's forward DFT does
//      (grid_encoder_spectral.cu), 16 warps owning one mode tile each and
//      the (2M x 128-channel) product in registers;
//   4. da, db, db1 and db2 are the per-block partials added in a fixed
//      order; dW1 and dW2 are split-K GEMMs over the pixels into per-split
//      partials, added in a fixed order (tile_common.cuh).  Deterministic.
// Weight gradients are optional (need_w): the FiLM fine-tune step does not
// ask for them.

#include "tile_common.cuh"

namespace {

constexpr int CHUNK = 64;                // longitudes per block of pass 2
constexpr int ROW_TILES = CHUNK / 16;
constexpr int WARPS = 8;
constexpr int PAD = 8;
constexpr int PREFETCH = 2;
constexpr int SLAB = 64;                 // rows of t per staging pass
constexpr int C_MAX = 256;
constexpr int XCT_PER_WARP = C_MAX / 16 / WARPS;  // x column tiles per warp
#ifndef MINB_OVERRIDE
#define MINB_OVERRIDE 2
#endif
constexpr int MIN_BLOCKS = MINB_OVERRIDE;  // resident blocks per SM (register cap)
// pass 3
constexpr int DH_WARPS = 16;
constexpr int CB = 128;                  // channels per block
constexpr int CT_MAX = CB / 16;
constexpr int M2P_MAX = 16 * DH_WARPS;   // one mode tile per warp

using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major>;

struct BwdArgs {
  const void* g;                 // (B, H, W, c_out)
  const __nv_bfloat16* t;        // (B, H, m2p, c): bf16(hm), zero rows past two_m
  const float* aff_a;            // (B, c)
  const float* aff_b;            // (B, c)
  const __nv_bfloat16* mt;       // (w_pad, m2p), zero rows past W and columns past two_m
  const void* skip;              // (B, H, W, s)
  const __nv_bfloat16* w1;       // (k1p, hidden): rows [0, c) main, [cmp, cmp + s) skip
  const float* b1;
  const __nv_bfloat16* w2;       // (hidden, n2p): zero columns past c_out
  float* dskip;                  // (B, H, W, s)
  __nv_bfloat16* dxa;            // (B, H, W, c) scratch
  float* part_da;                // (B, H * nch, c)
  float* part_db;
  __nv_bfloat16* xin;            // need_w: (B*H*W, k1p) [bf16(xa) | bf16(skip)]
  __nv_bfloat16* h1;             // need_w: (B*H*W, hidden) bf16(gelu(z1))
  __nv_bfloat16* gb;             // need_w: (B*H*W, n2p) bf16(g)
  __nv_bfloat16* dz;             // need_w: (B*H*W, hidden) bf16(dz1)
  float* part_db1;               // need_w: (B * H * nch, hidden)
  float* part_db2;               // need_w: (B * H * nch, n2p)
  int H, W, two_m, m2p, c, s, cmp, k1p, hidden, c_out, n2p, nch;
  int g_bf16, skip_bf16, need_w;
  int ldx, ldt, ldg, ldd, region_elems;
};

// t = bf16(hm), rows [two_m, m2p) zero: 8 channels per thread
__global__ void hm_to_bf16(const void* hm, int hm_bf16, __nv_bfloat16* t, int two_m, int m2p,
                           int c, long long n_vec) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  const long long e0 = v * 8;
  const int col = (int)(e0 % c);
  const long long row = e0 / c;  // (b * H + h) * m2p + m
  const int m = (int)(row % m2p);
  const long long src = ((row / m2p) * two_m + m) * c + col;
  __align__(16) __nv_bfloat16 out[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    out[e] = __float2bfloat16_rn(m < two_m ? load_act(hm, src + e, hm_bf16) : 0.f);
  *reinterpret_cast<uint4*>(t + e0) = *reinterpret_cast<const uint4*>(out);
}

// rows [0, rows) of a (CHUNK x cols) shared bf16 tile to device memory
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int ld,
                                           int rows, int cols) {
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += blockDim.x) {
    const int r = v / vpr, q = (v - r * vpr) * 8;
    *reinterpret_cast<uint4*>(dst + (long long)r * cols + q) =
        *reinterpret_cast<const uint4*>(src + r * ld + q);
  }
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS) decoder_bwd_rows(BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // CHUNK x ldx
  // the t slab (SLAB x ldt) while x_raw is computed, then bf16(dz1) (CHUNK x ldd)
  __nv_bfloat16* ts = xs + CHUNK * a.ldx;
  __nv_bfloat16* dzs = ts;
  __nv_bfloat16* ms = ts + a.region_elems;                          // Mt slab
  __nv_bfloat16* gs = ms + CHUNK * (SLAB + PAD);                    // CHUNK x ldg: bf16(g)
  float* scratch = reinterpret_cast<float*>(gs + CHUNK * a.ldg);    // WARPS x 256

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * CHUNK;
  const int rows = min(CHUNK, a.W - w0);
  const long long bh = (long long)blockIdx.z * a.H + blockIdx.y;
  const long long px0 = bh * a.W + w0;                 // the chunk's first pixel
  const long long blk = bh * a.nch + blockIdx.x;       // partial row of this block
  const float* sa = a.aff_a + (long long)blockIdx.z * a.c;
  const float* sb = a.aff_b + (long long)blockIdx.z * a.c;
  const int n_xct = a.c / 16;
  float* my = scratch + warp * 256;

  // x_raw = Mt[w0:w0+CHUNK] @ t, t and Mt staged per K-slab (as the forward)
  FragC acc_x[ROW_TILES][XCT_PER_WARP];
  chunk_inverse_dft<ROW_TILES, XCT_PER_WARP, SLAB>(acc_x, a.t + bh * a.m2p * a.c, a.mt, w0,
                                                   a.m2p, a.c, ts, a.ldt, ms, warp, WARPS);
  // MLP input tile [bf16(x_raw * a + b) | bf16(skip)], zero padding and zero
  // skip rows past the end
  stage_decoder_input<ROW_TILES, XCT_PER_WARP>(xs, a.ldx, acc_x, sa, sb, a.c, a.cmp, a.s, a.k1p,
                                               a.skip, a.skip_bf16, px0 * a.s, rows, my, warp,
                                               lane, WARPS);
  // bf16(g), zero past c_out and past the last row
  for (int idx = threadIdx.x; idx < CHUNK * a.n2p; idx += blockDim.x) {
    const int r = idx / a.n2p, j = idx - r * a.n2p;
    const float v = (r < rows && j < a.c_out)
                        ? load_act(a.g, (px0 + r) * a.c_out + j, a.g_bf16) : 0.f;
    gs[r * a.ldg + j] = __float2bfloat16_rn(v);
  }
  __syncthreads();  // xs and gs complete; the t slab region is free
  if (a.need_w) {
    store_rows(a.xin + px0 * a.k1p, xs, a.ldx, rows, a.k1p);
    store_rows(a.gb + px0 * a.n2p, gs, a.ldg, rows, a.n2p);
    for (int j = threadIdx.x; j < a.n2p; j += blockDim.x) {  // db2: fp32 g
      float s = 0.f;
      if (j < a.c_out)
        for (int r = 0; r < rows; ++r) s += load_act(a.g, (px0 + r) * a.c_out + j, a.g_bf16);
      a.part_db2[blk * a.n2p + j] = s;
    }
  }

  // per hidden column tile: z1 = xs @ W1 + b1, dh1 = bf16(g) @ W2^T (W2
  // (hidden, n2p) as col-major B), dz1 = dh1 * gelu'(z1) into dzs; h1 =
  // bf16(gelu(z1)) for dW2.  gelu'(z1) goes through the warp's scratch back
  // into an accumulator fragment, whose element layout dh1's shares.
  for (int ct = warp; ct < a.hidden / 16; ct += WARPS) {
    FragC zacc[ROW_TILES], dacc[ROW_TILES];
    tile_gemm<ROW_TILES, PREFETCH>(zacc, xs, a.ldx, a.w1, a.hidden, ct * 16, a.k1p);
#pragma unroll
    for (int i = 0; i < ROW_TILES; ++i) wmma::fill_fragment(dacc[i], 0.f);
    for (int k = 0; k < a.n2p; k += 16) {
      FragBCol wb;
      wmma::load_matrix_sync(wb, a.w2 + (long long)ct * 16 * a.n2p + k, a.n2p);
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i) {
        FragA ga;
        wmma::load_matrix_sync(ga, gs + i * 16 * a.ldg + k, a.ldg);
        wmma::mma_sync(dacc[i], ga, wb, dacc[i]);
      }
    }
    float csum = 0.f;  // column ct * 16 + lane % 16
#pragma unroll
    for (int i = 0; i < ROW_TILES; ++i) {
      wmma::store_matrix_sync(my, zacc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = i * 16 + e / 16;
        const int col = ct * 16 + (e % 16);
        const float z = my[e] + a.b1[col];
        if (a.need_w && row < rows)
          a.h1[(px0 + row) * a.hidden + col] = __float2bfloat16_rn(gelu_exact(z));
        my[e] = gelu_exact_grad(z);
      }
      __syncwarp();
      FragC gg;
      wmma::load_matrix_sync(gg, my, 16, wmma::mem_row_major);
#pragma unroll
      for (int el = 0; el < dacc[i].num_elements; ++el) dacc[i].x[el] *= gg.x[el];
      __syncwarp();
      wmma::store_matrix_sync(my, dacc[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = i * 16 + e / 16;
        dzs[row * a.ldd + ct * 16 + (e % 16)] = __float2bfloat16_rn(my[e]);
        csum += my[e];
      }
      __syncwarp();
    }
    csum += __shfl_down_sync(0xffffffffu, csum, 16);
    if (a.need_w && lane < 16) a.part_db1[blk * a.hidden + ct * 16 + lane] = csum;
  }
  __syncthreads();
  if (a.need_w) store_rows(a.dz + px0 * a.hidden, dzs, a.ldd, rows, a.hidden);

  // dxa = bf16(dz1) @ W1a^T in x_raw's tile ownership: da and db partials,
  // bf16(dxa) for the transposed DFT
#pragma unroll
  for (int u = 0; u < XCT_PER_WARP; ++u) {
    const int ct = warp + u * WARPS;
    if (ct >= n_xct) continue;
    FragC ad[ROW_TILES];
#pragma unroll
    for (int i = 0; i < ROW_TILES; ++i) wmma::fill_fragment(ad[i], 0.f);
    for (int k = 0; k < a.hidden; k += 16) {
      FragBCol wb;
      wmma::load_matrix_sync(wb, a.w1 + (long long)ct * 16 * a.hidden + k, a.hidden);
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i) {
        FragA da;
        wmma::load_matrix_sync(da, dzs + i * 16 * a.ldd + k, a.ldd);
        wmma::mma_sync(ad[i], da, wb, ad[i]);
      }
    }
    float s_da = 0.f, s_db = 0.f;
#pragma unroll
    for (int i = 0; i < ROW_TILES; ++i) {
      wmma::store_matrix_sync(my, ad[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = i * 16 + e / 16;
        const float v = my[e];
        s_db += v;
        if (row < rows)
          a.dxa[(px0 + row) * a.c + ct * 16 + (e % 16)] = __float2bfloat16_rn(v);
      }
      __syncwarp();
      // the same accumulator layout: elementwise dxa * x_raw
#pragma unroll
      for (int el = 0; el < ad[i].num_elements; ++el) ad[i].x[el] *= acc_x[i][u].x[el];
      wmma::store_matrix_sync(my, ad[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) s_da += my[e];
      __syncwarp();
    }
    s_da += __shfl_down_sync(0xffffffffu, s_da, 16);
    s_db += __shfl_down_sync(0xffffffffu, s_db, 16);
    if (lane < 16) {
      a.part_da[blk * a.c + ct * 16 + lane] = s_da;
      a.part_db[blk * a.c + ct * 16 + lane] = s_db;
    }
  }

  // dskip = bf16(dz1) @ W1b^T
  for (int st = warp; st < (a.k1p - a.cmp) / 16; st += WARPS) {
    FragC ad[ROW_TILES];
#pragma unroll
    for (int i = 0; i < ROW_TILES; ++i) wmma::fill_fragment(ad[i], 0.f);
    for (int k = 0; k < a.hidden; k += 16) {
      FragBCol wb;
      wmma::load_matrix_sync(wb, a.w1 + (long long)(a.cmp + st * 16) * a.hidden + k, a.hidden);
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i) {
        FragA da;
        wmma::load_matrix_sync(da, dzs + i * 16 * a.ldd + k, a.ldd);
        wmma::mma_sync(ad[i], da, wb, ad[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < ROW_TILES; ++i) {
      wmma::store_matrix_sync(my, ad[i], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int row = i * 16 + e / 16;
        const int sc = st * 16 + (e % 16);
        if (row < rows && sc < a.s) a.dskip[(px0 + row) * a.s + sc] = my[e];
      }
      __syncwarp();
    }
  }
}

// dhm[b, h] = a[b] * (Mt^T @ bf16(dxa[b, h])): a block per latitude row and
// CB-channel slice walks the row in CHUNK-pixel chunks; warp w accumulates
// mode tile w of the (2M x CB) product in registers
__global__ void __launch_bounds__(DH_WARPS * 32)
decoder_bwd_dhm(const __nv_bfloat16* __restrict__ dxa, const __nv_bfloat16* __restrict__ mt,
                const float* __restrict__ aff_a, float* __restrict__ dhm, int H, int W,
                int two_m, int m2p, int c) {
  constexpr int LDY = CB + PAD;
  __shared__ __align__(128) __nv_bfloat16 ys[CHUNK * LDY];
  __shared__ __align__(32) float scratch[DH_WARPS][256];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * CB;
  const int n_ct = min(CB, c - c0) / 16;
  const long long bh = (long long)blockIdx.z * H + blockIdx.y;
  const bool mine = warp < m2p / 16;
  FragC acc[CT_MAX];
#pragma unroll
  for (int j = 0; j < CT_MAX; ++j) wmma::fill_fragment(acc[j], 0.f);
  for (int w0 = 0; w0 < W; w0 += CHUNK) {
    const int rows = min(CHUNK, W - w0);
    __syncthreads();  // the previous chunk is no longer read
    const int vpr = n_ct * 2;  // 16-byte vectors per row
    for (int v = threadIdx.x; v < CHUNK * vpr; v += blockDim.x) {
      const int r = v / vpr, q = (v - r * vpr) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows) val = *reinterpret_cast<const uint4*>(dxa + (bh * W + w0 + r) * c + c0 + q);
      *reinterpret_cast<uint4*>(ys + r * LDY + q) = val;
    }
    __syncthreads();
    if (mine) {
#pragma unroll
      for (int k = 0; k < CHUNK; k += 16) {
        FragACol ca;
        wmma::load_matrix_sync(ca, mt + (long long)(w0 + k) * m2p + warp * 16, m2p);
#pragma unroll
        for (int j = 0; j < CT_MAX; ++j) {
          if (j < n_ct) {
            FragB yb;
            wmma::load_matrix_sync(yb, ys + k * LDY + j * 16, LDY);
            wmma::mma_sync(acc[j], ca, yb, acc[j]);
          }
        }
      }
    }
  }
  if (!mine) return;
  const float* sa = aff_a + (long long)blockIdx.z * c;
#pragma unroll
  for (int j = 0; j < CT_MAX; ++j) {
    if (j >= n_ct) continue;
    wmma::store_matrix_sync(scratch[warp], acc[j], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int m = warp * 16 + e / 16;
      const int col = c0 + j * 16 + (e % 16);
      if (m < two_m) dhm[(bh * two_m + m) * c + col] = sa[col] * scratch[warp][e];
    }
    __syncwarp();
  }
}

enum Ptr { P_G, P_HM, P_SKIP, P_A, P_B, P_MT, P_W1, P_B1, P_W2, P_DHM, P_DSKIP, P_DA, P_DB,
           P_DW1, P_DB1, P_DW2, P_DB2, P_T, P_DXA, P_PART_DA, P_PART_DB, P_XIN, P_H1, P_GB, P_DZ,
           P_PART_DB1, P_PART_DB2, P_PART_W, N_PTRS };
enum Int { I_B, I_H, I_W, I_TWO_M, I_M2P, I_W_PAD, I_C, I_S, I_CMP, I_K1P, I_HIDDEN, I_C_OUT,
           I_N2P, I_HM_BF16, I_SKIP_BF16, I_G_BF16, I_NEED_W, I_SPLITS, N_INTS };

}  // namespace

// Rows of the Mt operand must be padded to a multiple of this (zero rows).
extern "C" int spectral_decoder_bwd_chunk() { return CHUNK; }

// Partial rows per sample of the da/db reduce: H * this(W).
extern "C" int spectral_decoder_bwd_chunks(int w) { return (w + CHUNK - 1) / CHUNK; }

// ptrs and ints follow the Ptr and Int enums above.  Outputs: dhm (B, H,
// two_m, c), dskip (B, H, W, s), da, db (B, c) fp32; with need_w also dw1p
// (k1p, hidden) in the w1 operand's row layout, db1 (hidden), dw2p
// (hidden, n2p), db2 (n2p).  Scratch: t (B*H*m2p*c bf16), dxa (B*H*W*c
// bf16), part_da, part_db (B*H*nch*c floats); with need_w xin, h1, gb, dz
// (B*H*W rows of k1p, hidden, n2p, hidden bf16), part_db1, part_db2
// (B*H*nch rows of hidden, n2p floats), part_w (splits * max(k1p, n2p) *
// hidden floats).
extern "C" int spectral_decoder_bwd_bf16(const void* const* ptrs, const long long* ints,
                                         void* stream) {
  BwdArgs a;
  a.g = ptrs[P_G];
  a.t = (const __nv_bfloat16*)ptrs[P_T];
  a.aff_a = (const float*)ptrs[P_A];
  a.aff_b = (const float*)ptrs[P_B];
  a.mt = (const __nv_bfloat16*)ptrs[P_MT];
  a.skip = ptrs[P_SKIP];
  a.w1 = (const __nv_bfloat16*)ptrs[P_W1];
  a.b1 = (const float*)ptrs[P_B1];
  a.w2 = (const __nv_bfloat16*)ptrs[P_W2];
  a.dskip = (float*)ptrs[P_DSKIP];
  a.dxa = (__nv_bfloat16*)ptrs[P_DXA];
  a.part_da = (float*)ptrs[P_PART_DA];
  a.part_db = (float*)ptrs[P_PART_DB];
  a.xin = (__nv_bfloat16*)ptrs[P_XIN];
  a.h1 = (__nv_bfloat16*)ptrs[P_H1];
  a.gb = (__nv_bfloat16*)ptrs[P_GB];
  a.dz = (__nv_bfloat16*)ptrs[P_DZ];
  a.part_db1 = (float*)ptrs[P_PART_DB1];
  a.part_db2 = (float*)ptrs[P_PART_DB2];
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
  a.g_bf16 = (int)ints[I_G_BF16];
  a.skip_bf16 = (int)ints[I_SKIP_BF16];
  a.need_w = (int)ints[I_NEED_W];
  const int splits = (int)ints[I_SPLITS];
  const int hm_bf16 = (int)ints[I_HM_BF16];
  a.nch = (a.W + CHUNK - 1) / CHUNK;
  if (b < 1 || b > 65535 || a.H < 1 || a.H > 65535 || a.W < 1 || w_pad % CHUNK ||
      w_pad < a.W || a.two_m < 1 || a.m2p < a.two_m || a.m2p % 16 || a.m2p > M2P_MAX ||
      a.c < 16 || a.c % 16 || a.c > C_MAX || a.cmp != a.c || a.s < 1 ||
      a.k1p < a.cmp + a.s || a.k1p % 16 || a.hidden < 16 || a.hidden % 16 || a.c_out < 1 ||
      a.n2p < a.c_out || a.n2p % 16 || splits < 1)
    return (int)cudaErrorInvalidValue;
  a.ldx = a.k1p + PAD;
  a.ldt = a.c + PAD;
  a.ldg = a.n2p + PAD;
  a.ldd = a.hidden + PAD;
  a.region_elems = SLAB * a.ldt > CHUNK * a.ldd ? SLAB * a.ldt : CHUNK * a.ldd;
  const size_t smem = ((size_t)CHUNK * a.ldx + a.region_elems + (size_t)CHUNK * (SLAB + PAD) +
                       (size_t)CHUNK * a.ldg) * sizeof(__nv_bfloat16) +
                      (size_t)WARPS * 256 * sizeof(float);
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(decoder_bwd_rows,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;

  const long long n_vec = (long long)b * a.H * a.m2p * a.c / 8;
  hm_to_bf16<<<(unsigned)((n_vec + 255) / 256), 256, 0, st>>>(ptrs[P_HM], hm_bf16,
                                                             (__nv_bfloat16*)ptrs[P_T], a.two_m,
                                                             a.m2p, a.c, n_vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  decoder_bwd_rows<<<dim3(a.nch, a.H, b), WARPS * 32, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  decoder_bwd_dhm<<<dim3((a.c + CB - 1) / CB, a.H, b), DH_WARPS * 32, 0, st>>>(
      a.dxa, a.mt, a.aff_a, (float*)ptrs[P_DHM], a.H, a.W, a.two_m, a.m2p, a.c);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  stats_reduce<<<dim3((a.c + 31) / 32, b), dim3(32, 8), 0, st>>>(
      a.part_da, a.part_db, a.H * a.nch, a.c, (float*)ptrs[P_DA], (float*)ptrs[P_DB]);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (!a.need_w) return (int)cudaSuccess;

  const long long n_px = (long long)b * a.H * a.W;
  const int n_part = b * a.H * a.nch;
  const long long k_split = (n_px + splits - 1) / splits;
  float* part_w = (float*)ptrs[P_PART_W];
  // dW1 (k1p x hidden) = xin^T dz
  gemm_bf16<true, false><<<dim3((a.hidden + GEMM_BN - 1) / GEMM_BN,
                                (a.k1p + GEMM_BM - 1) / GEMM_BM, splits),
                           GEMM_THREADS, 0, st>>>(a.xin, a.k1p, a.dz, a.hidden, part_w, a.k1p,
                                                  a.hidden, n_px, k_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows<<<(a.k1p * a.hidden + 255) / 256, 256, 0, st>>>(part_w, splits, a.k1p * a.hidden,
                                                           (float*)ptrs[P_DW1]);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dW2 (hidden x n2p) = h1^T gb
  gemm_bf16<true, false><<<dim3((a.n2p + GEMM_BN - 1) / GEMM_BN,
                                (a.hidden + GEMM_BM - 1) / GEMM_BM, splits),
                           GEMM_THREADS, 0, st>>>(a.h1, a.hidden, a.gb, a.n2p, part_w, a.hidden,
                                                  a.n2p, n_px, k_split);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows<<<(a.hidden * a.n2p + 255) / 256, 256, 0, st>>>(part_w, splits, a.hidden * a.n2p,
                                                           (float*)ptrs[P_DW2]);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows<<<(a.hidden + 255) / 256, 256, 0, st>>>(a.part_db1, n_part, a.hidden,
                                                   (float*)ptrs[P_DB1]);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows<<<(a.n2p + 255) / 256, 256, 0, st>>>(a.part_db2, n_part, a.n2p, (float*)ptrs[P_DB2]);
  return (int)cudaGetLastError();
}
