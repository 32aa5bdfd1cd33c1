// One masked-grid GCN layer of the FiLM generator: a GEMM pass and a 3x3
// stencil pass (sm_90a), on bf16 or fp32 operands.
//
// Replaces msfno_tpu/ops/pallas/gcn_layer.py:gcn_layer (the Pallas
// `_gcn_layer_call` TPU kernel):
//
//   t   = (x @ W) * dinv                     (per source pixel, fp32)
//   out = res + leaky_relu((box3(t) * dinv + b) * mask, slope)
//
// box3 is the 3x3 neighbour sum, periodic in longitude, zero past the
// poles, summed in the TPU kernel's order: the rows (above + own) + below,
// then (centre + left) + right.  For c_in == 1 (the generator's first
// layer) t = (x * w) * dinv is an fp32 outer product.
//
// Bound on the H100 at a 512 -> 512 layer, (1, 180, 360): 3.4e10 FLOP.
// bf16 operands: ~0.2 GB of traffic (x, res, out in bf16, W) -> 0.06 ms at
// 3.35 TB/s, above the 0.035 ms of bf16 tensor-core work: bytes.  fp32
// operands (the JAX exact, balanced and fp32-kernel tiers' generator): an
// fp32-class product, whose least time on this card is three TF32
// tensor-core passes (165 TFLOP/s): 0.21 ms: operations.
//
// Design: the TPU kernel walks the latitude rows in grid order and carries
// the previous tile's rows in VMEM; CUDA blocks run in no order.  The old
// design here gave a block 32 output features and 5 rows with a halo, so x
// was read ~22 times.  Now a block of the GEMM pass owns all F <= WGM_BN
// features of a 128-pixel tile, so x is read about once, and t = (x W)
// dinv goes to an fp32 scratch (133 MB at the generator's shapes, L2- and
// HBM-resident):
//   1. GEMM: bf16 operands on the TMA + wgmma GEMM of row_gemm.cuh (F, c_in
//      multiples of 8), its epilogue scaling each row by dinv (bf16 with
//      other widths on row_gemm.cuh's fp32 FMA GEMM: bf16 x bf16 products
//      are exact in fp32, the same function).  fp32 operands on the
//      split-precision core (row_gemm.cuh:gemm_tf32x3: three TF32 wgmma
//      passes over hi / lo splits), A x's fp32 rows, B the hi / lo halves of
//      W^T (tf32_split_transposed, into a scratch of the call: W is trained
//      in place, so no split outlives a call), the epilogue TScale: 0.49 ms
//      of a 512 -> 512 layer's 0.68 on the H100, against 1.14 in true fp32
//      FMA on row_gemm.cuh:gemm_f32.
//   2. Stencil: a block owns one output row and ST_FC features; it sums the
//      rows above, at and below into shared memory (16-byte loads of t,
//      each t row read by three blocks, mostly from L2), then applies the
//      longitude taps, dinv, bias, mask, the leaky ReLU and the residual,
//      and writes the row once (batching several pixels' loads per thread
//      measured slower).  conv1 computes t = (x w) dinv here, so it is one byte pass.
//
// Tunables (tools/kernel_variants.py): ST_FC; WGM_BN and WGM_STAGES of
// row_gemm.cuh.

#include "row_gemm.cuh"

namespace {

#ifndef ST_FC_OVERRIDE
#define ST_FC_OVERRIDE 32
#endif
constexpr int ST_FC = ST_FC_OVERRIDE;  // output features per stencil block
constexpr int ST_THREADS = 256;
constexpr int ST_TPP = ST_FC / 4;      // threads per pixel, 4 features each
constexpr int ST_PSTEP = ST_THREADS / ST_TPP;
constexpr int MAX_WIDTH = 400;

// the GEMM's epilogue: t rows scaled by dinv, fp32, leading dimension ldt
struct TEpi {
  float* t;
  int ldt, f, dm_bf16;
  const void* dinv;
  __device__ __forceinline__ void operator()(float (&d)[64], long long row0, int rows,
                                             int col0) const {
    const int r0 = acc_row0();
    const float s0 = r0 < rows ? load_act(dinv, row0 + r0, dm_bf16) : 0.f;
    const float s1 = r0 + 8 < rows ? load_act(dinv, row0 + r0 + 8, dm_bf16) : 0.f;
#pragma unroll
    for (int i = 0; i < 64; ++i) d[i] *= (i % 4) < 2 ? s0 : s1;
    store_acc<float>(d, t, t, INT_MAX, ldt, row0, rows, col0, f, true);
  }
};

// the same on the split-precision core (TcTile): t rows scaled by dinv, a
// fragment's column pair as one 8-byte store (ldt is a multiple of 4)
struct TScale {
  float* t;
  int ldt, f, dm_bf16;
  const void* dinv;
  template <int NV>
  __device__ __forceinline__ void operator()(const float (&acc)[NV], const TcTile& tl) const {
    float s[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long m = tl.m0 + tl.row(2 * h);
      s[h] = m < tl.m_end ? load_act(dinv, m, dm_bf16) : 0.f;
    }
#pragma unroll
    for (int v = 0; v < NV; v += 2) {
      const long long m = tl.m0 + tl.row(v);
      const int n = tl.n0 + tl.col(v);
      if (m >= tl.m_end || n >= f) continue;
      const float sc = s[(v >> 1) & 1];
      *reinterpret_cast<float2*>(t + m * ldt + n) = make_float2(acc[v] * sc, acc[v + 1] * sc);
    }
  }
};

struct StencilArgs {
  const float* t;     // (B*H*W, ldt) fp32, or null: conv1
  long long ldt;
  const void* x;      // conv1: (B, H, W, 1)
  const float* w1;    // conv1: (F) fp32
  const float* bias;  // (F)
  const void* dinv;   // (B, H, W)
  const void* mask;   // (B, H, W)
  const void* res;    // (B, H, W, F) or null
  void* out;          // (B, H, W, F)
  int ht, wd, f;
  int x_bf16, dm_bf16, res_bf16, out_bf16;
  int vec;            // F % 4 == 0: 4-value loads and stores of res and out
  float slope;
};

// t of pixel px, features fi .. fi + 3 (zero at and past F)
__device__ __forceinline__ void t_values(const StencilArgs& a, long long px, int fi,
                                         float (&v)[4]) {
  if (a.t) {
    if (fi < a.f) {
      const float4 q = *reinterpret_cast<const float4*>(a.t + px * a.ldt + fi);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      v[0] = v[1] = v[2] = v[3] = 0.f;
    }
  } else {
    const float xv = load_act(a.x, px, a.x_bf16), d = load_act(a.dinv, px, a.dm_bf16);
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = fi + e < a.f ? (xv * a.w1[fi + e]) * d : 0.f;
  }
}

__device__ __forceinline__ void load4(const void* p, long long i, int bf16, bool vec, int n,
                                      float (&v)[4]) {
  if (vec) {
    if (bf16) {
      const uint2 raw = *reinterpret_cast<const uint2*>(
          reinterpret_cast<const __nv_bfloat16*>(p) + i);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(h[e]);
    } else {
      const float4 q = *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = e < n ? load_act(p, i + e, bf16) : 0.f;
  }
}

// out[px, fi .. fi + nf) = res + leaky_relu((box * dinv + b) * mask)
__device__ __forceinline__ void stencil_out(const StencilArgs& a, long long px, int fi, int nf,
                                            const float (&box)[4], const float (&bias)[4]) {
  const float d = load_act(a.dinv, px, a.dm_bf16);
  const float m = load_act(a.mask, px, a.dm_bf16);
  float r[4] = {0.f, 0.f, 0.f, 0.f};
  if (a.res) load4(a.res, px * a.f + fi, a.res_bf16, a.vec, nf, r);
  float y[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float agg = (box[e] * d + bias[e]) * m;
    y[e] = (agg >= 0.f ? agg : a.slope * agg) + r[e];
  }
  const long long oi = px * a.f + fi;
  if (a.out_bf16) {
    __nv_bfloat16* q = reinterpret_cast<__nv_bfloat16*>(a.out) + oi;
    if (a.vec) {
      alignas(8) __nv_bfloat16 packed[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) packed[e] = __float2bfloat16_rn(y[e]);
      *reinterpret_cast<uint2*>(q) = *reinterpret_cast<const uint2*>(packed);
    } else {
      for (int e = 0; e < nf; ++e) q[e] = __float2bfloat16_rn(y[e]);
    }
  } else {
    float* q = reinterpret_cast<float*>(a.out) + oi;
    if (a.vec) *reinterpret_cast<float4*>(q) = make_float4(y[0], y[1], y[2], y[3]);
    else for (int e = 0; e < nf; ++e) q[e] = y[e];
  }
}

__global__ void __launch_bounds__(ST_THREADS) gcn_stencil(StencilArgs a) {
  extern __shared__ __align__(16) float vs[];  // wd x ST_FC: (above + own) + below
  const int f0 = blockIdx.x * ST_FC, o = blockIdx.y, b = blockIdx.z;
  const int fl = (threadIdx.x % ST_TPP) * 4, pg = threadIdx.x / ST_TPP;
  const int fi = f0 + fl;
  const long long row_px = ((long long)b * a.ht + o) * a.wd;  // pixel (b, o, 0)
  for (int p = pg; p < a.wd; p += ST_PSTEP) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int dr = -1; dr <= 1; ++dr) {  // zero rows past the poles add nothing
      if (o + dr < 0 || o + dr >= a.ht) continue;
      float v[4];
      t_values(a, row_px + (long long)dr * a.wd + p, fi, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) s[e] += v[e];
    }
    *reinterpret_cast<float4*>(vs + p * ST_FC + fl) = make_float4(s[0], s[1], s[2], s[3]);
  }
  __syncthreads();
  if (fi >= a.f) return;
  const int nf = min(4, a.f - fi);
  float bias[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) bias[e] = e < nf ? a.bias[fi + e] : 0.f;
  for (int p = pg; p < a.wd; p += ST_PSTEP) {
    const int pl = p == 0 ? a.wd - 1 : p - 1;
    const int pr = p == a.wd - 1 ? 0 : p + 1;
    const float4 c4 = *reinterpret_cast<const float4*>(vs + p * ST_FC + fl);
    const float4 l4 = *reinterpret_cast<const float4*>(vs + pl * ST_FC + fl);
    const float4 r4 = *reinterpret_cast<const float4*>(vs + pr * ST_FC + fl);
    const float box[4] = {(c4.x + l4.x) + r4.x, (c4.y + l4.y) + r4.y, (c4.z + l4.z) + r4.z,
                          (c4.w + l4.w) + r4.w};
    stencil_out(a, row_px + p, fi, nf, box, bias);
  }
}

}  // namespace

// x: (B, H, W, c_in), bf16 for bf16 operands with c_in > 1, fp32 for fp32
// operands (f32_ops); w: (c_in, F) bf16 or fp32 (f32_ops) for c_in > 1,
// (F) fp32 for c_in == 1; bias fp32 (F); dinv, mask: (B, H, W) in fp32 or
// bf16 (dm_bf16); res may be null; t: fp32 scratch (B*H*W, ldt), ldt >= F
// a multiple of 4 (unused for c_in == 1); w_x3: with fp32 operands and c_in
// > 1, an fp32 scratch (2, F, c_in_pad) for W^T's hi / lo halves, c_in_pad
// >= c_in a multiple of 4.  W must be at least 3 and at most 400.
extern "C" int gcn_layer(const void* x, const void* w, const void* bias, const void* dinv,
                         const void* mask, const void* res, void* out, void* t, void* w_x3,
                         int batch, int h, int wd, int c_in, int f, int ldt, int c_in_pad,
                         int x_bf16, int dm_bf16, int res_bf16, int out_bf16, int f32_ops,
                         float slope, void* stream) {
  if (batch < 1 || batch > 65535 || h < 1 || h > 65535 || wd < 3 || wd > MAX_WIDTH ||
      c_in < 1 || f < 1 || (c_in > 1 && (ldt < f || ldt % 4 || t == nullptr)) ||
      (c_in > 1 && x_bf16 == f32_ops) ||
      (c_in > 1 && f32_ops && (w_x3 == nullptr || c_in_pad < c_in || c_in_pad % 4)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n_px = (long long)batch * h * wd;
  if (n_px > INT_MAX) return (int)cudaErrorInvalidValue;
  int err = 0;
  if (c_in > 1) {
    float* tk = (float*)t;
    using bf = __nv_bfloat16;
    if (f32_ops) {  // t (n_px x F) = x (n_px x c_in) @ W: B's (N x K) is W^T
      float* wx = (float*)w_x3;
      err = tf32_split_transposed_launch((const float*)w, c_in, f, c_in_pad, wx, st);
      if (!err)
        err = gemm_tf32x3_run<128>(F32Matrix<float>{(const float*)x, c_in}, wx,
                                   wx + (long long)f * c_in_pad, c_in_pad, n_px, f, c_in, 1, 0,
                                   TScale{tk, ldt, f, dm_bf16, dinv}, st);
    } else if (c_in % 8 == 0 && f % 8 == 0) {
      err = wgmma_gemm_launch(x, c_in, w, f, (int)n_px, f, c_in,
                              TEpi{tk, ldt, f, dm_bf16, dinv}, st);
    } else {
      err = gemm_f32_launch((const bf*)x, c_in, (const bf*)w, f, tk, ldt,
                                          (int)n_px, f, c_in, 1, dinv, dm_bf16, st);
    }
    if (err) return err;
  }
  StencilArgs a;
  a.t = c_in > 1 ? (const float*)t : nullptr;
  a.ldt = ldt;
  a.x = x; a.w1 = (const float*)w; a.bias = (const float*)bias;
  a.dinv = dinv; a.mask = mask; a.res = res; a.out = out;
  a.ht = h; a.wd = wd; a.f = f;
  a.x_bf16 = x_bf16; a.dm_bf16 = dm_bf16; a.res_bf16 = res_bf16; a.out_bf16 = out_bf16;
  a.vec = f % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(res) % 16 == 0;
  a.slope = slope;
  const size_t smem = (size_t)wd * ST_FC * sizeof(float);
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        gcn_stencil, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_WIDTH * ST_FC * 4);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  gcn_stencil<<<dim3((f + ST_FC - 1) / ST_FC, h, batch), ST_THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

// The hi / lo halves (2, F, c_in_pad) of W^T that the fp32 GEMM pass makes
// on every call (tf32_split_transposed), alone: w (c_in, F) fp32 (tests).
extern "C" int gcn_layer_split_w(const void* w, int c_in, int f, int c_in_pad, void* w_x3,
                                 void* stream) {
  return tf32_split_transposed_launch((const float*)w, c_in, f, c_in_pad, (float*)w_x3,
                                      (cudaStream_t)stream);
}
