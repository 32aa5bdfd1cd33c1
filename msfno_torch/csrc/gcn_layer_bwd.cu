// Backward of one masked-grid GCN layer, bf16 tensor-core GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/gcn_layer.py:_gcn_layer_bwd_call (the Pallas
// `_make_bwd_kernel` TPU kernel).  With the forward
// y = res + leaky_relu((box3(x W * d) * d + b) * mask, slope):
//
//   dagg = g * act' * mask          act' = 1 where y - res >= 0, else slope
//   dsup = box3(dagg * d) * d       box3 is symmetric: its own transpose
//   dx   = bf16(dsup) @ bf16(W)^T   (fp32 accumulation)
//   dW   = bf16(x)^T @ bf16(dsup)   db = sum over pixels of dagg
//
// No forward recompute: act' comes from the saved output.  For c_in == 1
// (the generator's first layer) dx is a dot per pixel and dW a column sum.
// fp32 operands (the JAX exact and balanced tiers' generator): dsup stays
// fp32 and the products are true fp32 FMA (no TF32).
//
// Bound on the H100 at a 512 -> 512 layer (1, 180, 360): g, y, res and x in
// bf16 (4 x 66 MB) and dx in fp32 (133 MB), ~0.40 GB -> 0.12 ms at 3.35
// TB/s; 2 GEMMs of 2 * 64,800 * 512 * 512 = 6.8e10 FLOP -> 0.07 ms: bytes.
// fp32 operands: the same 6.8e10 FLOP at 67 TFLOP/s -> 1.0 ms: operations.
//
// Design: the TPU kernel carries the previous tile's rows of dagg * d across
// its sequential grid and accumulates dW and db in output blocks that every
// grid step revisits.  CUDA blocks run in no order, so here:
//   1. `gcn_bwd_dsup`: a block owns one latitude row and 64 features, a
//      thread 8 features (16-byte loads and stores).  It sums dagg * d over
//      the rows above, at and below (recomputed pointwise from g, y, res,
//      mask and dinv; zero past the poles) into shared memory, adds the
//      periodic longitude neighbours, scales by d and writes dsup in bf16,
//      the rounding point of both products (fp32 operands: dsup in fp32).
//      It writes the row's column sums of dagg (and, for c_in == 1, of
//      x * dsup) as per-row partials.
//   2. dx: the split-free bf16 GEMM of tile_common.cuh (fp32 operands: the
//      fp32 FMA GEMM of row_gemm.cuh), W read as the transposed operand, so
//      no transpose is stored; for c_in == 1 one warp per pixel.
//   3. dW = x^T dsup: the same GEMM split over pixel ranges into per-split
//      partials; db, dW partials are added in a fixed order by `sum_rows`.
// Deterministic: no atomics.

#include "row_gemm.cuh"

namespace {

constexpr int FCB = 64;           // features per block of the dsup pass
constexpr int VEC = 8;            // features per thread: one 16-byte bf16 vector
constexpr int TPP = FCB / VEC;    // threads per pixel
constexpr int DSUP_THREADS = 256;
constexpr int PSTEP = DSUP_THREADS / TPP;  // pixels in flight per block
constexpr int MAX_WIDTH = 400;

struct BwdArgs {
  const void* g;          // (B, H, W, F)
  const void* y;          // (B, H, W, F): the forward output
  const void* res;        // (B, H, W, F) or null
  const void* x;          // (B, H, W, c_in)
  const void* w;          // (c_in, F) bf16, or fp32 (f32)
  const void* dinv;       // (B, H, W)
  const void* mask;       // (B, H, W)
  void* dsup;             // (B, H, W, F) scratch, bf16 or fp32 (f32)
  float* part_db;         // (B * H, F)
  float* part_dw1;        // (B * H, F), c_in == 1 only
  int ht, wd, c_in, f;
  int g_bf16, y_bf16, res_bf16, x_bf16, dm_bf16;
  float slope;
};

// 8 consecutive values at element i (16-byte aligned: F % 8 == 0)
__device__ __forceinline__ void load8(const void* p, long long i, int bf16, float (&v)[VEC]) {
  if (bf16) {
    const uint4 raw = *reinterpret_cast<const uint4*>(
        reinterpret_cast<const __nv_bfloat16*>(p) + i);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] = __bfloat162float(h[e]);
  } else {
    const float4* q = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
    const float4 lo = q[0], hi = q[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  }
}

// dagg * d of 8 features at pixel p (flat index of (b, row, w)); adds dagg
// to db when given
__device__ __forceinline__ void dbx8(const BwdArgs& a, long long p, int fi, float (&out)[VEC],
                                     float* db) {
  float g[VEC], y[VEC], r[VEC];
  const long long i = p * a.f + fi;
  load8(a.g, i, a.g_bf16, g);
  load8(a.y, i, a.y_bf16, y);
  if (a.res) {
    load8(a.res, i, a.res_bf16, r);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) r[e] = 0.f;
  }
  const float m = load_act(a.mask, p, a.dm_bf16);
  const float d = load_act(a.dinv, p, a.dm_bf16);
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    const float act = y[e] - r[e] >= 0.f ? 1.f : a.slope;
    const float dagg = g[e] * act * m;
    if (db) db[e] += dagg;
    out[e] = dagg * d;
  }
}

template <bool F32>
__global__ void __launch_bounds__(DSUP_THREADS) gcn_bwd_dsup(BwdArgs a) {
  extern __shared__ __align__(16) float vs[];   // wd x FCB vertical sums
  __shared__ float red[2][PSTEP][FCB];
  const int f0 = blockIdx.x * FCB;
  const int r = blockIdx.y, b = blockIdx.z;
  const int fl = (threadIdx.x % TPP) * VEC, pg = threadIdx.x / TPP;
  const int fi = f0 + fl;
  const bool f_ok = fi < a.f;  // F % 8 == 0: a vector is wholly in or out
  const long long row0 = ((long long)b * a.ht + r) * a.wd;
  float s_db[VEC], s_dw[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) s_db[e] = s_dw[e] = 0.f;
  for (int p = pg; p < a.wd; p += PSTEP) {
    float s[VEC], t[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) s[e] = 0.f;
    if (f_ok) {
      dbx8(a, row0 + p, fi, s, s_db);
      if (r > 0) {
        dbx8(a, row0 - a.wd + p, fi, t, nullptr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[e] += t[e];
      }
      if (r + 1 < a.ht) {
        dbx8(a, row0 + a.wd + p, fi, t, nullptr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) s[e] += t[e];
      }
    }
    float4* dst = reinterpret_cast<float4*>(vs + p * FCB + fl);
    dst[0] = make_float4(s[0], s[1], s[2], s[3]);
    dst[1] = make_float4(s[4], s[5], s[6], s[7]);
  }
  __syncthreads();
  if (f_ok) {
    for (int p = pg; p < a.wd; p += PSTEP) {
      const int pl = p == 0 ? a.wd - 1 : p - 1;
      const int pr = p == a.wd - 1 ? 0 : p + 1;
      const float d = load_act(a.dinv, row0 + p, a.dm_bf16);
      float xv = a.c_in == 1 ? load_act(a.x, row0 + p, a.x_bf16) : 0.f;
      if (!F32) xv = __bfloat162float(__float2bfloat16_rn(xv));
      float ds[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float dt = vs[pl * FCB + fl + e] + vs[p * FCB + fl + e] + vs[pr * FCB + fl + e];
        ds[e] = dt * d;
        if (!F32) ds[e] = __bfloat162float(__float2bfloat16_rn(ds[e]));
        s_dw[e] += xv * ds[e];
      }
      const long long oi = (row0 + p) * a.f + fi;
      if (F32) {
        float4* q = reinterpret_cast<float4*>(reinterpret_cast<float*>(a.dsup) + oi);
        q[0] = make_float4(ds[0], ds[1], ds[2], ds[3]);
        q[1] = make_float4(ds[4], ds[5], ds[6], ds[7]);
      } else {
        __align__(16) __nv_bfloat16 dh[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) dh[e] = __float2bfloat16_rn(ds[e]);
        *reinterpret_cast<uint4*>(reinterpret_cast<__nv_bfloat16*>(a.dsup) + oi) =
            *reinterpret_cast<const uint4*>(dh);
      }
    }
  }
  // the row's column sums: the PSTEP pixel groups of a feature, in order
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    red[0][pg][fl + e] = s_db[e];
    red[1][pg][fl + e] = s_dw[e];
  }
  __syncthreads();
  for (int col = threadIdx.x; col < FCB && f0 + col < a.f; col += blockDim.x) {
    float tb = 0.f, tw = 0.f;
    for (int q = 0; q < PSTEP; ++q) {
      tb += red[0][q][col];
      tw += red[1][q][col];
    }
    const long long o = ((long long)b * a.ht + r) * a.f + f0 + col;
    a.part_db[o] = tb;
    if (a.c_in == 1) a.part_dw1[o] = tw;
  }
}

// c_in == 1: dx[p] = sum_f dsup[p, f] * w[f] (both bf16, or both fp32),
// one warp per pixel
template <typename T>
__global__ void gcn_bwd_dx_c1(const T* __restrict__ dsup, const T* __restrict__ w,
                              long long n_px, int f, float* __restrict__ dx) {
  const long long p = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (p >= n_px) return;
  float s = 0.f;
  for (int k = lane; k < f; k += 32)
    s += to_float(dsup[p * f + k]) * to_float(w[k]);
#pragma unroll
  for (int o = 16; o > 0; o /= 2) s += __shfl_down_sync(0xffffffffu, s, o);
  if (lane == 0) dx[p] = s;
}

enum Ptr { P_G, P_Y, P_RES, P_X, P_W, P_DINV, P_MASK, P_DX, P_DW, P_DB, P_DSUP, P_PART_DB,
           P_PART_DW, N_PTRS };
enum Int { I_B, I_H, I_W, I_C_IN, I_F, I_G_BF16, I_Y_BF16, I_RES_BF16, I_X_BF16, I_DM_BF16,
           I_SPLITS, I_F32, N_INTS };

}  // namespace

// ptrs and ints follow the Ptr and Int enums above.  f32 (ints[I_F32]):
// fp32 operands, else bf16.  w: (c_in, F) of the operand type; dx (fp32,
// B*H*W x c_in) may be null (not needed); dsup: scratch of B*H*W*F values
// of the operand type; part_db: B*H*F floats; part_dw: B*H*F floats for
// c_in == 1, else splits*c_in*F.  F is a multiple of 8; for c_in > 1 on
// bf16 operands so is c_in, and x is a bf16 array; on fp32 operands x is
// fp32.  W must be at least 3 and at most 400.
extern "C" int gcn_layer_bwd(const void* const* ptrs, const long long* ints, float slope,
                             void* stream) {
  BwdArgs a;
  a.g = ptrs[P_G];
  a.y = ptrs[P_Y];
  a.res = ptrs[P_RES];
  a.x = ptrs[P_X];
  a.w = ptrs[P_W];
  a.dinv = ptrs[P_DINV];
  a.mask = ptrs[P_MASK];
  a.dsup = const_cast<void*>(ptrs[P_DSUP]);
  a.part_db = (float*)ptrs[P_PART_DB];
  a.part_dw1 = (float*)ptrs[P_PART_DW];
  const int b = (int)ints[I_B];
  a.ht = (int)ints[I_H];
  a.wd = (int)ints[I_W];
  a.c_in = (int)ints[I_C_IN];
  a.f = (int)ints[I_F];
  a.g_bf16 = (int)ints[I_G_BF16];
  a.y_bf16 = (int)ints[I_Y_BF16];
  a.res_bf16 = (int)ints[I_RES_BF16];
  a.x_bf16 = (int)ints[I_X_BF16];
  a.dm_bf16 = (int)ints[I_DM_BF16];
  a.slope = slope;
  const int splits = (int)ints[I_SPLITS];
  const bool f32 = ints[I_F32] != 0;
  if (b < 1 || b > 65535 || a.ht < 1 || a.ht > 65535 || a.wd < 3 || a.wd > MAX_WIDTH ||
      a.c_in < 1 || a.f < 8 || a.f % 8 || splits < 1 ||
      (a.c_in > 1 && !f32 && (a.c_in % 8 || !a.x_bf16)) || (a.c_in > 1 && f32 && a.x_bf16))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)a.wd * FCB * sizeof(float);
  void (*dsup_kernel)(BwdArgs) = f32 ? &gcn_bwd_dsup<true> : &gcn_bwd_dsup<false>;
  cudaError_t err = cudaFuncSetAttribute(dsup_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dsup_kernel<<<dim3((a.f + FCB - 1) / FCB, a.ht, b), DSUP_THREADS, smem, st>>>(a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  using bf = __nv_bfloat16;
  const long long n_px = (long long)b * a.ht * a.wd;
  const int rows = b * a.ht;
  float* dx = (float*)ptrs[P_DX];
  float* dw = (float*)ptrs[P_DW];
  float* part_dw = (float*)ptrs[P_PART_DW];
  if (a.c_in == 1) {
    if (dx) {
      const unsigned blocks = (unsigned)((n_px * 32 + 255) / 256);
      if (f32)
        gcn_bwd_dx_c1<float><<<blocks, 256, 0, st>>>((const float*)a.dsup, (const float*)a.w,
                                                     n_px, a.f, dx);
      else
        gcn_bwd_dx_c1<bf><<<blocks, 256, 0, st>>>((const bf*)a.dsup, (const bf*)a.w, n_px,
                                                  a.f, dx);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    sum_rows<<<(a.f + 255) / 256, 256, 0, st>>>(part_dw, rows, a.f, dw);
  } else if (f32) {
    int e = 0;
    if (dx)  // dx (n_px x c_in) = dsup (n_px x F) @ w^T, w stored (c_in x F)
      e = gemm_f32_launch<false, true>((const float*)a.dsup, a.f, (const float*)a.w, a.f, dx,
                                       a.c_in, (int)n_px, a.c_in, a.f, 1, nullptr, 0, st);
    if (e) return e;
    // dW partials (splits x c_in x F) = x^T dsup over pixel ranges
    e = gemm_f32_launch<true, false>((const float*)a.x, a.c_in, (const float*)a.dsup, a.f,
                                     part_dw, a.f, a.c_in, a.f, n_px, splits, nullptr, 0, st);
    if (e) return e;
    const int n = a.c_in * a.f;
    sum_rows<<<(n + 255) / 256, 256, 0, st>>>(part_dw, splits, n, dw);
  } else {
    const bf* ds = (const bf*)a.dsup;
    if (dx) {  // dx (n_px x c_in) = dsup (n_px x F) @ w^T, w stored (c_in x F)
      dim3 grid((a.c_in + GEMM_BN - 1) / GEMM_BN, (unsigned)((n_px + GEMM_BM - 1) / GEMM_BM), 1);
      gemm_bf16<false, true><<<grid, GEMM_THREADS, 0, st>>>(ds, a.f, (const bf*)a.w, a.f, dx,
                                                            (int)n_px, a.c_in, a.f, a.f);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    // dW partials (splits x c_in x F) = x^T dsup over pixel ranges
    const long long k_split = (n_px + splits - 1) / splits;
    dim3 grid((a.f + GEMM_BN - 1) / GEMM_BN, (a.c_in + GEMM_BM - 1) / GEMM_BM, splits);
    gemm_bf16<true, false><<<grid, GEMM_THREADS, 0, st>>>(
        (const bf*)a.x, a.c_in, ds, a.f, part_dw, a.c_in, a.f, n_px, k_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int n = a.c_in * a.f;
    sum_rows<<<(n + 255) / 256, 256, 0, st>>>(part_dw, splits, n, dw);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  sum_rows<<<(a.f + 255) / 256, 256, 0, st>>>(a.part_db, rows, a.f, (float*)ptrs[P_DB]);
  return (int)cudaGetLastError();
}
