// Complex spectral MLP over SHT mode rows, bf16 wgmma GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/spectral_mlp.py:spectral_mlp (the Pallas
// `_karatsuba_call` / `_packed_call` / `_fused_call` TPU kernels).  Per mode
// row n:
//
//   h0 = [xr_n | xi_n];  h_{l+1} = act_l(h_l @ P_l);  out = h_L
//   P_l = [[wr, wi], [-wi, wr]]  (2 d_l x 2 d_{l+1}, packed complex weight)
//   act_l = LeakyReLU(slope) on the real half (columns < d_{l+1}), identity
//           on the imaginary half, for every layer but the last (wout).
//
// The packed product is the 4-product complex form (hr wr - hi wi,
// hr wi + hi wr), not Karatsuba: bf16 operands wr, wi are rounded once, where
// the JAX Karatsuba kernel also rounds the sums wi - wr and wr + wi.
// Rounding points: bf16 operands, fp32 accumulation, the hidden state
// rounded to bf16 once per layer (where the TPU kernel rounds it at the next
// dot: the same point).
//
// Bound on the H100: one launch at the serving shapes (14,520 rows,
// 256 -> 512 -> 512 -> 512 -> 256) needs ~6.9e10 FLOP in the TPU kernel's
// Karatsuba form (this packed form does 9.1e10) against ~30 MB of
// activations and ~6 MB of weights, so it is bound by tensor-core
// operations (~0.07 ms at the bf16 dense peak), not by memory.
//
// Design: the TPU kernel keeps all ~6 MB of weights resident in VMEM; a
// Hopper SM has at most 227 KB, and keeping the hidden state of a row tile
// resident capped the tile at 32 rows, so every block streamed all the
// weights from L2 (~2.9 GB per launch).  Here each layer is one GEMM
// through L2 instead: a layer's bf16 hidden state (14,520 x 1024, 30 MB)
// fits the 50 MB L2, and each layer runs as the TMA + wgmma GEMM of
// row_gemm.cuh on 128 x WGM_BN tiles, whose epilogue applies the LeakyReLU
// to the real half and rounds to bf16 (hidden layers) or stores fp32 re and
// im apart (the last layer).  A small pass first casts fp32 xr, xi to the
// bf16 [re | im] rows that TMA reads (TMA does not convert).  One call is
// n_layers + 1 launches on the caller's stream; scratch h_a, h_b (bf16,
// n_rows x 2 max(d)) hold the hidden states in turn.
//
// Tunables (tools/kernel_variants.py): WGM_BN (128 or 256 columns per
// block) and WGM_STAGES (ring depth; 0 fills 200 KB), in row_gemm.cuh.
//
// fp32 operands (the "float32" and "tensorfloat" knobs, the JAX package's
// default `spectral_mxu_dtype`): spectral_mlp_f32, the same packed
// 4-product layers as fp32-class products, each layer one
// row_gemm.cuh:gemm_tf32x3 launch (three TF32 wgmma passes over hi / lo
// splits, fp32 accumulation) with the epilogues HiddenF32 / OutF32.  The
// least time of an fp32-class product on this card is three TF32
// tensor-core passes (495 / 3 = 165 TFLOP/s).  The first layer's A functor
// reads xr and xi in place (ComplexRows, 16-byte loads; no cast pass); the
// hidden states are fp32 [re | im] rows; B is pack_weights' hi and lo of
// each layer's P^T (2 d_{l+1} x 2 d_l, K-major).  Bound on the H100: the
// Karatsuba form's 6.9e10 FLOP at 165 TFLOP/s, 0.42 ms; the packed form's
// 9.1e10 take 0.553 ms at that rate.  Karatsuba is left out: the packed
// form's three passes are already below the FMA Karatsuba bound (1.02 ms),
// and its weight sums (wi - wr, wr + wi) would need splits of their own.
// The hidden state, 14,520 x 1024 x 4 B = 59 MB, exceeds the 50 MB L2;
// its round trip (~0.04 ms a layer at the HBM rate) is below the
// operations.

#include "row_gemm.cuh"

namespace {

constexpr int MAX_LAYERS = 8;

// h0 (n_rows, 2 d0) bf16 = [xr | xi]: 4 values of each half per thread
__global__ void stage_input(const float4* __restrict__ xr, const float4* __restrict__ xi,
                            __nv_bfloat16* __restrict__ h0, long long n4, int d0) {
  const int d4 = d0 / 4;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / d4;
    const int c = (int)(i - r * d4) * 4;
    const float4 a = xr[i], b = xi[i];
    alignas(8) __nv_bfloat16 pa[4] = {__float2bfloat16_rn(a.x), __float2bfloat16_rn(a.y),
                                      __float2bfloat16_rn(a.z), __float2bfloat16_rn(a.w)};
    alignas(8) __nv_bfloat16 pb[4] = {__float2bfloat16_rn(b.x), __float2bfloat16_rn(b.y),
                                      __float2bfloat16_rn(b.z), __float2bfloat16_rn(b.w)};
    __nv_bfloat16* row = h0 + r * 2 * d0;
    *reinterpret_cast<uint2*>(row + c) = *reinterpret_cast<const uint2*>(pa);
    *reinterpret_cast<uint2*>(row + d0 + c) = *reinterpret_cast<const uint2*>(pb);
  }
}

// hidden layer: LeakyReLU on the real half, bf16 rows of 2 d_out
struct HiddenEpi {
  __nv_bfloat16* h;
  int d_out;
  float slope;
  __device__ __forceinline__ void operator()(float (&d)[64], long long row0, int rows,
                                             int col0) const {
#pragma unroll
    for (int q = 0; q < 16; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& v = d[4 * q + e];
        if (col0 + acc_col(q, e % 2) < d_out && v < 0.f) v *= slope;
      }
    store_acc<__nv_bfloat16>(d, h, h, INT_MAX, 2 * d_out, row0, rows, col0, 2 * d_out, true);
  }
};

// last layer: fp32 re (columns < d_out) and im apart
struct OutEpi {
  float* re;
  float* im;
  int d_out;
  __device__ __forceinline__ void operator()(float (&d)[64], long long row0, int rows,
                                             int col0) const {
    store_acc<float>(d, re, im, d_out, d_out, row0, rows, col0, 2 * d_out, true);
  }
};

// the fp32 first layer's A: row m's [xr | xi] (d a multiple of 4, xr and
// xi 16-byte aligned)
struct ComplexRows {
  const float* re;
  const float* im;
  int d;
  __device__ __forceinline__ float operator()(long long m, long long k, int) const {
    return k < d ? __ldg(re + m * d + k) : __ldg(im + m * d + (k - d));
  }
  __device__ __forceinline__ float4 quad(long long m, long long k, int) const {
    return __ldg(reinterpret_cast<const float4*>(k < d ? re + m * d + k : im + m * d + (k - d)));
  }
  __device__ __forceinline__ float4 finish(float4 v, long long, int) const { return v; }
};

// fp32 hidden layer: LeakyReLU on the real half, fp32 rows of 2 d_out
struct HiddenF32 {
  float* h;
  int d_out;
  float slope;
  template <int NV>
  __device__ __forceinline__ void operator()(const float (&acc)[NV], const TcTile& t) const {
    const int n2 = 2 * d_out;
#pragma unroll
    for (int v = 0; v < NV; v += 2) {
      const long long m = t.m0 + t.row(v);
      const int n = t.n0 + t.col(v);
      if (m >= t.m_end || n >= n2) continue;  // d_out % 16 == 0: a pair is whole
      float2 y = make_float2(acc[v], acc[v + 1]);
      if (n < d_out) {
        if (y.x < 0.f) y.x *= slope;
        if (y.y < 0.f) y.y *= slope;
      }
      *reinterpret_cast<float2*>(h + m * n2 + n) = y;
    }
  }
};

// fp32 last layer: re (columns < d_out) and im apart
struct OutF32 {
  float* re;
  float* im;
  int d_out;
  template <int NV>
  __device__ __forceinline__ void operator()(const float (&acc)[NV], const TcTile& t) const {
#pragma unroll
    for (int v = 0; v < NV; v += 2) {
      const long long m = t.m0 + t.row(v);
      const int n = t.n0 + t.col(v);
      if (m >= t.m_end || n >= 2 * d_out) continue;
      float* p = n < d_out ? re + m * d_out + n : im + m * d_out + (n - d_out);
      *reinterpret_cast<float2*>(p) = make_float2(acc[v], acc[v + 1]);
    }
  }
};

// the core's plain epilogue (tf32x3_matmul): split z's partial product to
// c + z m ldc
struct TcStore {
  float* c;
  long long ldc, m;
  int n;
  template <int NV>
  __device__ __forceinline__ void operator()(const float (&acc)[NV], const TcTile& t) const {
    float* out = c + (long long)t.z * m * ldc;
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const long long r = t.m0 + t.row(v);
      const int col = t.n0 + t.col(v);
      if (r < t.m_end && col < n) out[r * ldc + col] = acc[v];
    }
  }
};

int check_dims(const int* d, const long long* off, int n_layers, int n_rows) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || n_rows < 1) return (int)cudaErrorInvalidValue;
  for (int l = 0; l <= n_layers; ++l)
    if (d[l] <= 0 || d[l] % 16 != 0) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l)
    if (off[l] % 8) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// As spectral_mlp_bf16, on fp32 operands: w_hi and w_lo hold the hi and lo
// halves of each layer's transposed packed weight P_l^T (2 d[l+1] x 2 d[l],
// at off[l] in each), h_a and h_b are fp32 scratch of n_rows * 2 * max(d)
// each.
extern "C" int spectral_mlp_f32(const void* xr, const void* xi, const void* w_hi,
                                const void* w_lo, const int* d, const long long* off,
                                int n_layers, void* out_r, void* out_i, int n_rows, float slope,
                                void* h_a, void* h_b, void* stream) {
  if (int err = check_dims(d, off, n_layers, n_rows)) return err;
  if ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi)) % 16)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  for (int l = 0; l < n_layers; ++l) {
    const float* a = (const float*)(l % 2 == 1 ? h_a : h_b);  // layer l - 1's output
    float* next = (float*)(l % 2 == 0 ? h_a : h_b);
    const int k = 2 * d[l], n = 2 * d[l + 1];
    const float* hi = (const float*)w_hi + off[l];
    const float* lo = (const float*)w_lo + off[l];
    // the A functor: the input's [xr | xi] (first layer), else layer l - 1's rows
    auto layer = [&](const auto& x) {
      return l == n_layers - 1
                 ? gemm_tf32x3_run<128>(x, hi, lo, k, n_rows, n, k, 1, 0,
                                        OutF32{(float*)out_r, (float*)out_i, d[l + 1]}, st)
                 : gemm_tf32x3_run<128>(x, hi, lo, k, n_rows, n, k, 1, 0,
                                        HiddenF32{next, d[l + 1], slope}, st);
    };
    const int err = l == 0 ? layer(ComplexRows{(const float*)xr, (const float*)xi, d[0]})
                           : layer(F32Matrix<false, float>{a, k});
    if (err) return err;
  }
  return 0;
}

// The split-precision core on its own (tests): c (m x n, fp32, rows of ldc)
// = a (m x k, fp32, rows of lda) @ b, b given as the hi and lo halves of
// its (n x k) transpose (rows of ldb), on bn-column tiles (112 or 128),
// rows in segments of seg_rows (0: one), K in `splits` ranges whose
// partial products go to c + z m ldc.
extern "C" int tf32x3_matmul(const void* a, long long lda, const void* b_hi, const void* b_lo,
                             long long ldb, void* c, long long ldc, int m, int n, int k,
                             long long seg_rows, int splits, int bn, void* stream) {
  const F32Matrix<false, float> x{(const float*)a, lda};
  const TcStore out{(float*)c, ldc, m, n};
  const cudaStream_t st = (cudaStream_t)stream;
  const float* hi = (const float*)b_hi;
  const float* lo = (const float*)b_lo;
  if (bn == 112) return gemm_tf32x3_run<112>(x, hi, lo, ldb, m, n, k, splits, seg_rows, out, st);
  if (bn == 128) return gemm_tf32x3_run<128>(x, hi, lo, ldb, m, n, k, splits, seg_rows, out, st);
  return (int)cudaErrorInvalidValue;
}

// xr, xi: (n_rows, d[0]) fp32, 16-byte aligned; wbuf: packed bf16 weights,
// layer l at off[l] with shape (2 d[l], 2 d[l+1]); out_r, out_i: (n_rows,
// d[n_layers]) fp32; h_a, h_b: bf16 scratch of n_rows * 2 * max(d) each.
// Every d must be a multiple of 16.
extern "C" int spectral_mlp_bf16(const void* xr, const void* xi, const void* wbuf,
                                 const int* d, const long long* off, int n_layers,
                                 void* out_r, void* out_i, int n_rows, float slope, void* h_a,
                                 void* h_b, void* stream) {
  if (int err = check_dims(d, off, n_layers, n_rows)) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long n4 = (long long)n_rows * d[0] / 4;
  const long long blocks = (n4 + 255) / 256;
  stage_input<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, st>>>(
      (const float4*)xr, (const float4*)xi, (__nv_bfloat16*)h_a, n4, d[0]);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const __nv_bfloat16* w = (const __nv_bfloat16*)wbuf;
  for (int l = 0; l < n_layers; ++l) {
    const void* a = l % 2 == 0 ? h_a : h_b;
    __nv_bfloat16* next = (__nv_bfloat16*)(l % 2 == 0 ? h_b : h_a);
    const int k = 2 * d[l], n = 2 * d[l + 1];
    int err;
    if (l == n_layers - 1)
      err = wgmma_gemm_launch(a, k, w + off[l], n, n_rows, n, k,
                              OutEpi{(float*)out_r, (float*)out_i, d[l + 1]}, st);
    else
      err = wgmma_gemm_launch(a, k, w + off[l], n, n_rows, n, k,
                              HiddenEpi{next, d[l + 1], slope}, st);
    if (err) return err;
  }
  return 0;
}
