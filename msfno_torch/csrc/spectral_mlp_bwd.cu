// Input gradient of the complex spectral MLP over SHT mode rows, bf16 wgmma
// GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/spectral_mlp.py:_packed_bwd_call (the Pallas
// `_make_packed_bwd_kernel` TPU kernel).  Forward, per mode row (packed
// complex weights P_l = [[wr, wi], [-wi, wr]], spectral_mlp.cu):
//
//   h_0 = [xr | xi];  z_l = bf16(h_l) @ P_l;  h_{l+1} = act(z_l)
//   act = LeakyReLU(slope) on the real half (columns < d_{l+1}), identity on
//         the imaginary half, for every layer but the last
//
// Backward, g_L = [gr | gi]:
//
//   g_l = (bf16(g_{l+1}) @ P_l^T) * m_{l-1}     (m: bf16(slope) where the
//                                               real-half z was < 0, else 1)
//   dx = g_0 (fp32)
//
// Bound on the H100 at the serving shapes (14,520 rows, 256 -> 512 -> 512 ->
// 512 -> 256): the forward recompute of three layers and the transposed chain
// of four are 8 * 14,520 * (655,360 + 786,432) = 1.7e11 FLOP -> 0.17 ms at
// 989 TFLOP/s bf16, against ~60 MB of fp32 rows and 6 MB of weights: bound
// by operations.
//
// Design: the TPU kernel keeps all packed weights resident in VMEM.  Here,
// as in the forward kernel (spectral_mlp.cu), each layer is one GEMM through
// L2 on row_gemm.cuh's TMA + wgmma `wgmma_gemm`: a layer's bf16 rows (14,520
// x 1024, 30 MB) fit the 50 MB L2.  One call is 2 casts + 7 GEMMs on the
// caller's stream:
//   1. casts: fp32 xr, xi and gr, gi to bf16 [re | im] rows (the forward's
//      stage_input, as stage_grad_rows);
//   2. recompute: layers 0 .. L-2 as `z_l = bf16(h_l) @ P_l`, the forward
//      kernel's GEMM in its K order, so z is the forward's bit for bit.  The
//      epilogue writes bf16 h_{l+1} (LeakyReLU on the real half; the last
//      recomputed layer writes no h, only its mask) and the layer's
//      derivative mask: one bit per real-half value, set where z < 0, in
//      the accumulator fragment's own layout (a 32-bit word per row, 128
//      columns and lane quad: bit 2q + e is fragment column 8q + 2(lane % 4)
//      + e), so the transposed chain reads one word per row and fragment.
//      At the serving shapes a mask is 0.9 MB a layer against 15 MB as bf16
//      multipliers;
//   3. transposed chain: layers L-1 .. 0 as `g_l = bf16(g_{l+1}) @ P_l^T`,
//      P_l^T read by wgmma's K-major B descriptor straight from the forward's
//      packed buffer (no transposed copy).  The epilogue multiplies by
//      bf16(slope) where layer l-1's mask bit is set and rounds to bf16,
//      where JAX rounds (`g.astype(mxu_dtype)` at the next dot); the last
//      GEMM writes fp32 dxr and dxi apart.
// Scratch (the wrapper allocates it): two bf16 row buffers of n_rows * 2
// max(d) and the masks, n_rows * max(d) / 8 bytes per hidden layer.
//
// Tunables (tools/kernel_variants.py): WGM_BN, WGM_STAGES (row_gemm.cuh).

#include "row_gemm.cuh"

namespace {

constexpr int MAX_LAYERS = 8;

// h0 (n_rows, 2 d0) bf16 = [xr | xi]: 4 values of each half per thread (the
// forward's stage_input, named apart so that a profile tells them apart)
__global__ void stage_grad_rows(const float4* __restrict__ xr, const float4* __restrict__ xi,
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

// mask words per row of a layer of d_out (real-half) columns: 4 per 128
__host__ __device__ __forceinline__ int mask_words(int d_out) {
  return 4 * ((d_out + 127) / 128);
}

// recompute: h (null: none) = LeakyReLU on the real half, bf16 rows of 2
// d_out; the mask bits of the real half
struct RecomputeEpi {
  __nv_bfloat16* h;
  uint32_t* mask;  // (n_rows, mask_words(d_out))
  int d_out;
  float slope;
  __device__ __forceinline__ void operator()(float (&d)[64], long long row0, int rows,
                                             int col0) const {
    if (col0 < d_out) {
      uint32_t bits[2] = {0u, 0u};  // rows r0 and r0 + 8
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& v = d[4 * q + e];
          if (col0 + acc_col(q, e % 2) < d_out && v < 0.f) {
            bits[e / 2] |= 1u << (2 * q + e % 2);
            v *= slope;
          }
        }
      const int r0 = acc_row0(), words = mask_words(d_out);
      const int w = (col0 / 128) * 4 + threadIdx.x % 4;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (r0 + 8 * hh < rows) mask[(row0 + r0 + 8 * hh) * words + w] = bits[hh];
    }
    if (h)
      store_acc<__nv_bfloat16>(d, h, h, INT_MAX, 2 * d_out, row0, rows, col0, 2 * d_out, true);
  }
};

// transposed chain, hidden layer: times bf16(slope) where layer l-1's mask
// bit is set (real half), bf16 rows of 2 d_in
struct ChainEpi {
  __nv_bfloat16* g;
  const uint32_t* mask;  // layer l-1's, (n_rows, mask_words(d_in))
  int d_in;
  float slope_m;
  __device__ __forceinline__ void operator()(float (&d)[64], long long row0, int rows,
                                             int col0) const {
    if (col0 < d_in) {
      const int r0 = acc_row0(), words = mask_words(d_in);
      const int w = (col0 / 128) * 4 + threadIdx.x % 4;
      uint32_t bits[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        bits[hh] = r0 + 8 * hh < rows ? mask[(row0 + r0 + 8 * hh) * words + w] : 0u;
#pragma unroll
      for (int q = 0; q < 16; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if ((bits[e / 2] >> (2 * q + e % 2)) & 1u) d[4 * q + e] *= slope_m;
    }
    store_acc<__nv_bfloat16>(d, g, g, INT_MAX, 2 * d_in, row0, rows, col0, 2 * d_in, true);
  }
};

// the input layer: fp32 re (columns < d_in) and im apart
struct InputGradEpi {
  float* re;
  float* im;
  int d_in;
  __device__ __forceinline__ void operator()(float (&d)[64], long long row0, int rows,
                                             int col0) const {
    store_acc<float>(d, re, im, d_in, d_in, row0, rows, col0, 2 * d_in, true);
  }
};

int cast_rows(const void* re, const void* im, void* out, int n_rows, int c, cudaStream_t st) {
  const long long n4 = (long long)n_rows * c / 4;
  const long long blocks = (n4 + 255) / 256;
  stage_grad_rows<<<(unsigned)(blocks < 132 * 16 ? blocks : 132 * 16), 256, 0, st>>>(
      (const float4*)re, (const float4*)im, (__nv_bfloat16*)out, n4, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of mask scratch for n_rows rows of a layer of width d_out.
extern "C" long long spectral_mlp_bwd_mask_bytes(int n_rows, int d_out) {
  return (long long)n_rows * mask_words(d_out) * 4;
}

// xr, xi: (n_rows, d[0]) fp32 and gr, gi: (n_rows, d[n_layers]) fp32, all
// 16-byte aligned; wbuf: the forward kernel's packed bf16 weights, layer l
// at off[l] with shape (2 d[l], 2 d[l+1]); dxr, dxi: (n_rows, d[0]) fp32.
// Scratch: h_a, h_b bf16 of n_rows * 2 max(d) each; masks, layer l (<
// n_layers - 1) at mask_off[l] bytes with spectral_mlp_bwd_mask_bytes(n_rows,
// d[l + 1]) bytes.  Every d must be a multiple of 16.
extern "C" int spectral_mlp_bwd_bf16(const void* xr, const void* xi, const void* gr,
                                     const void* gi, const void* wbuf, const int* d,
                                     const long long* off, int n_layers, void* dxr, void* dxi,
                                     int n_rows, float slope, void* h_a, void* h_b,
                                     void* masks, const long long* mask_off, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || n_rows < 1) return (int)cudaErrorInvalidValue;
  for (int l = 0; l <= n_layers; ++l)
    if (d[l] <= 0 || d[l] % 16 != 0) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < n_layers; ++l)
    if (off[l] % 8 || (l + 1 < n_layers && mask_off[l] % 16)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const __nv_bfloat16* w = (const __nv_bfloat16*)wbuf;
  uint32_t* mask_of[MAX_LAYERS];
  for (int l = 0; l + 1 < n_layers; ++l)
    mask_of[l] = (uint32_t*)((char*)masks + mask_off[l]);
  const float slope_m = __bfloat162float(__float2bfloat16_rn(slope));

  // recompute layers 0 .. L-2, the forward's GEMMs, keeping their masks
  int err = cast_rows(xr, xi, h_a, n_rows, d[0], st);
  if (err) return err;
  for (int l = 0; l + 1 < n_layers; ++l) {
    const void* a = l % 2 == 0 ? h_a : h_b;
    __nv_bfloat16* next = l + 2 < n_layers ? (__nv_bfloat16*)(l % 2 == 0 ? h_b : h_a) : nullptr;
    const int k = 2 * d[l], n = 2 * d[l + 1];
    err = wgmma_gemm_launch(a, k, w + off[l], n, n_rows, n, k,
                            RecomputeEpi{next, mask_of[l], d[l + 1], slope}, st);
    if (err) return err;
  }

  // transposed chain: g <- (bf16(g) @ P_l^T) * m_{l-1}, from the output back
  if ((err = cast_rows(gr, gi, h_a, n_rows, d[n_layers], st))) return err;
  for (int l = n_layers - 1, i = 0; l >= 0; --l, ++i) {
    const void* a = i % 2 == 0 ? h_a : h_b;
    __nv_bfloat16* next = (__nv_bfloat16*)(i % 2 == 0 ? h_b : h_a);
    const int k = 2 * d[l + 1], n = 2 * d[l];  // P_l (n x k) row-major is P_l^T's transpose
    if (l == 0)
      err = wgmma_gemm_launch<InputGradEpi, true>(a, k, w + off[l], k, n_rows, n, k,
                                                  InputGradEpi{(float*)dxr, (float*)dxi, d[0]}, st);
    else
      err = wgmma_gemm_launch<ChainEpi, true>(a, k, w + off[l], k, n_rows, n, k,
                                              ChainEpi{next, mask_of[l - 1], d[l], slope_m}, st);
    if (err) return err;
  }
  return 0;
}
