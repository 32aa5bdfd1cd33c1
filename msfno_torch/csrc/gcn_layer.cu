// One masked-grid GCN layer of the FiLM generator, bf16 tensor-core GEMM with
// a fused 3x3 stencil epilogue (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/gcn_layer.py:gcn_layer (the Pallas
// `_gcn_layer_call` TPU kernel):
//
//   t   = (x @ W) * dinv                     (per source pixel)
//   out = res + leaky_relu((box3(t) * dinv + b) * mask, slope)
//
// box3 is the 3x3 neighbour sum, periodic in longitude, zero past the poles.
// For c_in == 1 (the generator's first layer) x @ W is an fp32 outer product.
//
// Bound on the H100: a 512 -> 512 layer at (180, 360) is ~3.4e10 FLOP
// against ~200 MB of traffic in bf16, about 0.06 ms either way at the bf16
// dense peak and 3.35 TB/s.
//
// Design: the TPU kernel walks the latitude rows in grid order and carries
// the previous tile's rows in VMEM ("one tile of lag"); CUDA blocks run in no
// order, so here a block owns ROWS_PER_BLOCK output rows (all longitudes)
// and one chunk of FC output features, and recomputes t for one halo row
// above and below its rows (zero past the poles).  It walks its rows in
// order keeping the last three rows of t (fp32) in a shared-memory ring, so
// each t row is computed once per block, and emits an output row as soon as
// the row below it is in the ring.  Longitude wraps inside the row.  The
// GEMM of one t row is (W x c_in) @ (c_in x FC) on WMMA; chunks of KC input
// channels of the x row and of the weights stream into shared memory with
// 16-byte cp.async copies, double-buffered so the next chunk loads while the
// current one is multiplied.  The row's dinv and mask sit in shared memory and
// the residual loads of several pixels are issued before their stores.

#include "tile_common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int FC = 32;            // output features per block
#ifndef KC_OVERRIDE
#define KC_OVERRIDE 32
#endif
constexpr int KC = KC_OVERRIDE;            // input channels per staged chunk
#ifndef ROWS_PER_BLOCK_OVERRIDE
#define ROWS_PER_BLOCK_OVERRIDE 5
#endif
constexpr int ROWS_PER_BLOCK = ROWS_PER_BLOCK_OVERRIDE;
constexpr int LDX = KC + 8;       // bf16, padded
constexpr int LDW = FC + 8;       // bf16, padded
constexpr int MAX_TILES_PER_WARP = 8;
constexpr int MAX_WIDTH = 400;    // ring, two x stages and row vectors fit 227 KB

struct GcnArgs {
  const void* x;          // (B, H, W, c_in)
  const void* w;          // c_in > 1: bf16 (c_in, F); c_in == 1: fp32 (F)
  const float* bias;      // (F)
  const void* dinv;       // (B, H, W)
  const void* mask;       // (B, H, W)
  const void* res;        // (B, H, W, F) or null
  void* out;              // (B, H, W, F)
  int ht, wd, c_in, f;    // H, W, input and output channels
  int wp;                 // W rounded up to 16
  int x_bf16, dm_bf16, res_bf16, out_bf16;
  int vec;                // 16-byte async copies of x and w (bf16, aligned)
  float slope;
};

// stage channels [kc, kc + KC) of one x row and the matching weight rows
__device__ __forceinline__ void stage_chunk(const GcnArgs& a, long long row_base, int kc,
                                            int f0, __nv_bfloat16* xs, __nv_bfloat16* ws) {
  const __nv_bfloat16* x16 = reinterpret_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w16 = reinterpret_cast<const __nv_bfloat16*>(a.w);
  if (a.vec) {
    constexpr int VPP = KC / 8;  // 16-byte vectors per position
    for (int i = threadIdx.x; i < a.wp * VPP; i += blockDim.x) {
      const int p = i / VPP, k = (i % VPP) * 8;
      const bool ok = p < a.wd && kc + k < a.c_in;
      cp_async16(xs + p * LDX + k,
                 ok ? (const void*)(x16 + (row_base + p) * a.c_in + kc + k) : a.x,
                 ok ? 16 : 0);
    }
    constexpr int VPR = FC / 8;
    for (int i = threadIdx.x; i < KC * VPR; i += blockDim.x) {
      const int k = i / VPR, f = (i % VPR) * 8;
      const bool ok = kc + k < a.c_in && f0 + f < a.f;
      cp_async16(ws + k * LDW + f,
                 ok ? (const void*)(w16 + (long long)(kc + k) * a.f + f0 + f) : a.w,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < a.wp * KC; i += blockDim.x) {
      const int p = i / KC, k = i % KC;
      float v = 0.f;
      if (p < a.wd && kc + k < a.c_in)
        v = load_act(a.x, (row_base + p) * a.c_in + kc + k, a.x_bf16);
      xs[p * LDX + k] = __float2bfloat16_rn(v);
    }
    for (int i = threadIdx.x; i < KC * FC; i += blockDim.x) {
      const int k = i / FC, f = i % FC;
      ws[k * LDW + f] = (kc + k < a.c_in && f0 + f < a.f)
                            ? w16[(long long)(kc + k) * a.f + f0 + f]
                            : __float2bfloat16_rn(0.f);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(WARPS * 32) gcn_layer_kernel(GcnArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);            // 3 x wp x FC
  float* drow = ring + 3 * a.wp * FC;                          // dinv of the row in work
  float* dout = drow + a.wp;                                   // dinv of the output row
  float* mout = dout + a.wp;                                   // mask of the output row
  __nv_bfloat16* xs0 = reinterpret_cast<__nv_bfloat16*>(mout + a.wp);  // 2 x (wp x LDX)
  __nv_bfloat16* ws0 = xs0 + 2 * a.wp * LDX;                   // 2 x (KC x LDW)

  const int warp = threadIdx.x / 32;
  const int f0 = blockIdx.x * FC;
  const int h0 = blockIdx.y * ROWS_PER_BLOCK;
  const int b = blockIdx.z;
  const int h_end = min(h0 + ROWS_PER_BLOCK, a.ht);  // one past the last output row
  const int n_tiles = (a.wp / 16) * (FC / 16);
  const int slot_elems = a.wp * FC;
  const int n_chunks = (a.c_in + KC - 1) / KC;
  const int f_thread = threadIdx.x % FC;  // blockDim.x is a multiple of FC
  const float bias = f0 + f_thread < a.f ? a.bias[f0 + f_thread] : 0.f;

  for (int r = h0 - 1; r <= h_end; ++r) {
    float* slot = ring + ((r - h0 + 1) % 3) * slot_elems;
    const long long row_base = ((long long)b * a.ht + r) * a.wd;  // pixel of (b, r, 0)
    const bool inside = r >= 0 && r < a.ht;
    if (inside && a.c_in > 1) stage_chunk(a, row_base, 0, f0, xs0, ws0);
    for (int p = threadIdx.x; p < a.wp; p += blockDim.x)
      drow[p] = inside && p < a.wd ? load_act(a.dinv, row_base + p, a.dm_bf16) : 0.f;
    __syncthreads();
    if (!inside) {
      for (int i = threadIdx.x; i < slot_elems; i += blockDim.x) slot[i] = 0.f;
    } else if (a.c_in == 1) {
      const float w = f0 + f_thread < a.f ? reinterpret_cast<const float*>(a.w)[f0 + f_thread] : 0.f;
#pragma unroll 4
      for (int i = threadIdx.x; i < slot_elems; i += blockDim.x) {
        const int p = i / FC;
        slot[i] = p < a.wd ? load_act(a.x, row_base + p, a.x_bf16) * w * drow[p] : 0.f;
      }
    } else {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAX_TILES_PER_WARP];
#pragma unroll
      for (int j = 0; j < MAX_TILES_PER_WARP; ++j) wmma::fill_fragment(acc[j], 0.f);
      for (int c = 0; c < n_chunks; ++c) {
        // double buffer: chunk c + 1 streams in while chunk c is multiplied
        const __nv_bfloat16* xs = xs0 + (c % 2) * a.wp * LDX;
        const __nv_bfloat16* ws = ws0 + (c % 2) * KC * LDW;
        if (c + 1 < n_chunks) {
          stage_chunk(a, row_base, (c + 1) * KC, f0, xs0 + ((c + 1) % 2) * a.wp * LDX,
                      ws0 + ((c + 1) % 2) * KC * LDW);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < MAX_TILES_PER_WARP; ++j) {
          const int t = warp + j * WARPS;
          if (t < n_tiles) {
            const int rt = t / (FC / 16), ct = t % (FC / 16);
#pragma unroll
            for (int kk = 0; kk < KC; kk += 16) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
              wmma::load_matrix_sync(fa, xs + rt * 16 * LDX + kk, LDX);
              wmma::load_matrix_sync(fb, ws + kk * LDW + ct * 16, LDW);
              wmma::mma_sync(acc[j], fa, fb, acc[j]);
            }
          }
        }
        __syncthreads();  // this buffer is refilled two chunks on
      }
#pragma unroll
      for (int j = 0; j < MAX_TILES_PER_WARP; ++j) {
        const int t = warp + j * WARPS;
        if (t < n_tiles) {
          const int rt = t / (FC / 16), ct = t % (FC / 16);
          wmma::store_matrix_sync(slot + rt * 16 * FC + ct * 16, acc[j], FC,
                                  wmma::mem_row_major);
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int i = threadIdx.x; i < slot_elems; i += blockDim.x) slot[i] *= drow[i / FC];
    }

    // emit output row o = r - 1 once rows o-1, o, o+1 are in the ring
    const int o = r - 1;
    const bool emit = o >= h0 && o < h_end;
    const long long orow = ((long long)b * a.ht + o) * a.wd;
    if (emit) {
      for (int p = threadIdx.x; p < a.wd; p += blockDim.x) {
        dout[p] = load_act(a.dinv, orow + p, a.dm_bf16);
        mout[p] = load_act(a.mask, orow + p, a.dm_bf16);
      }
    }
    __syncthreads();
    if (emit && f0 + f_thread < a.f) {
      const float* up = ring + ((o - h0) % 3) * slot_elems;
      const float* mid = ring + ((o - h0 + 1) % 3) * slot_elems;
      const float* dn = slot;
      const int f = f_thread;
      const int step = blockDim.x / FC;
      constexpr int U = 4;  // residual loads of U pixels are issued before any store
      for (int p0 = threadIdx.x / FC; p0 < a.wd; p0 += U * step) {
        float rv[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int p = p0 + u * step;
          rv[u] = (a.res && p < a.wd)
                      ? load_act(a.res, (orow + p) * a.f + f0 + f, a.res_bf16) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int p = p0 + u * step;
          if (p >= a.wd) break;
          const int pl = (p == 0 ? a.wd - 1 : p - 1) * FC + f;
          const int pc = p * FC + f;
          const int pr = (p == a.wd - 1 ? 0 : p + 1) * FC + f;
          const float box = (up[pl] + mid[pl] + dn[pl]) + (up[pc] + mid[pc] + dn[pc]) +
                            (up[pr] + mid[pr] + dn[pr]);
          const float agg = (box * dout[p] + bias) * mout[p];
          const float y = (agg >= 0.f ? agg : a.slope * agg) + rv[u];
          const long long oi = (orow + p) * a.f + f0 + f;
          if (a.out_bf16)
            reinterpret_cast<__nv_bfloat16*>(a.out)[oi] = __float2bfloat16_rn(y);
          else
            reinterpret_cast<float*>(a.out)[oi] = y;
        }
      }
    }
    __syncthreads();  // the next row overwrites the oldest slot and the row vectors
  }
}

}  // namespace

// x: (B, H, W, c_in); w: bf16 (c_in, F) for c_in > 1, fp32 (F) for c_in == 1;
// bias fp32 (F); dinv, mask: (B, H, W) in fp32 or bf16 (dm_bf16); res may be
// null.  W must be at least 3 and at most 400.
extern "C" int gcn_layer_bf16(const void* x, const void* w, const void* bias,
                              const void* dinv, const void* mask, const void* res,
                              void* out, int batch, int h, int wd, int c_in, int f,
                              int x_bf16, int dm_bf16, int res_bf16, int out_bf16,
                              float slope, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || wd < 3 || wd > MAX_WIDTH || c_in < 1 || f < 1)
    return (int)cudaErrorInvalidValue;
  GcnArgs a;
  a.x = x; a.w = w; a.bias = (const float*)bias; a.dinv = dinv; a.mask = mask;
  a.res = res; a.out = out;
  a.ht = h; a.wd = wd; a.c_in = c_in; a.f = f;
  a.wp = (wd + 15) / 16 * 16;
  a.x_bf16 = x_bf16; a.dm_bf16 = dm_bf16; a.res_bf16 = res_bf16; a.out_bf16 = out_bf16;
  a.vec = x_bf16 && c_in % 8 == 0 && f % 8 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  a.slope = slope;
  const size_t smem = (3 * (size_t)a.wp * FC + 3 * (size_t)a.wp) * sizeof(float) +
                      2 * ((size_t)a.wp * LDX + (size_t)KC * LDW) * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      gcn_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((f + FC - 1) / FC, (h + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, batch);
  gcn_layer_kernel<<<grid, WARPS * 32, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
