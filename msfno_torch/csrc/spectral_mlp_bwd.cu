// Input gradient of the complex spectral MLP over SHT mode rows, bf16
// tensor-core GEMMs (sm_90a).
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
// Design: the TPU kernel keeps all packed weights resident in VMEM and one
// bf16 multiplier per hidden value.  Here a block owns TILE_ROWS mode rows,
// as the forward kernel does: it recomputes the hidden layers with the
// weights slab-streamed through shared memory (forward slab layout), keeping
// only the activation masks; then runs the transposed chain through the same
// packed weights.  A K-slab of P^T is 16 columns of P for all its rows,
// copied as two 16-byte vectors per row into an unpadded (rows x 16) slab
// that the tensor cores read as a col-major B fragment: no transpose is
// stored.  The masks live only on the real half of each hidden layer and
// are one bit per value whatever the slope (negative or not): 16-bit words
// per (row, column tile), built with a warp ballot, 2 KB per hidden layer
// at 32 rows, against 64 KB as bf16 multipliers, which would not fit beside
// the two bf16 row buffers and the slabs in 227 KB.

#include "tile_common.cuh"

namespace {

constexpr int MAX_LAYERS = 8;
constexpr int TILE_ROWS = 32;   // mode rows per block
constexpr int ROW_TILES = TILE_ROWS / 16;
constexpr int WARPS = 16;
constexpr int PAD = 8;          // bf16 elements of padding per shared row
constexpr int MAX_CT = 4;       // column tiles per warp: widths up to 16 * WARPS * MAX_CT / 2
constexpr int KS = 16;          // weight rows (forward) or columns (backward) per slab

struct MlpDims {
  int n_layers;
  int d[MAX_LAYERS + 1];
  long long off[MAX_LAYERS];  // element offset of P_l in the weight buffer
};

// backward: columns [k0, k0 + KS) of all n_rows rows of a (n_rows, row_len)
// layer, as an unpadded (n_rows x KS) slab
__device__ __forceinline__ void stage_cols(const __nv_bfloat16* w, int k0, int row_len,
                                           int n_rows, __nv_bfloat16* slab) {
  for (int i = threadIdx.x; i < n_rows * 2; i += blockDim.x) {
    const int r = i / 2, c = (i % 2) * 8;
    cp_async16(slab + r * KS + c, w + (long long)r * row_len + k0 + c, 16);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(WARPS * 32)
spectral_mlp_bwd_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                        const float* __restrict__ gr, const float* __restrict__ gi,
                        const __nv_bfloat16* __restrict__ wbuf, MlpDims dims,
                        float* __restrict__ dxr, float* __restrict__ dxi, int n_rows,
                        float slope, int ld, int slab_elems, int mct) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* buf_b = buf_a + TILE_ROWS * ld;
  __nv_bfloat16* slabs = buf_b + TILE_ROWS * ld;              // 2 x slab_elems
  float* scratch = reinterpret_cast<float*>(slabs + 2 * slab_elems);
  // masks[l][row][ct]: bit e of the word is column ct * 16 + e of layer l's
  // real half, set where z < 0
  uint16_t* masks = reinterpret_cast<uint16_t*>(scratch + WARPS * 256);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = (long long)blockIdx.x * TILE_ROWS;
  const long long rows_left = n_rows - row0;
  const int rows = rows_left < TILE_ROWS ? (int)rows_left : TILE_ROWS;
  float* my = scratch + warp * 256;
  const int n_layers = dims.n_layers;
  const float slope_m = __bfloat162float(__float2bfloat16_rn(slope));

  // forward recompute of the hidden layers, keeping their masks
  stage_complex_rows<TILE_ROWS>(xr, xi, row0, rows, dims.d[0], buf_a, ld);
  __nv_bfloat16* h_in = buf_a;
  __nv_bfloat16* h_out = buf_b;
  for (int l = 0; l + 1 < n_layers; ++l) {
    const int d_out = dims.d[l + 1];
    const int k_dim = 2 * dims.d[l];
    const int n_dim = 2 * d_out;
    const int n_ct = n_dim / 16;
    const __nv_bfloat16* w = wbuf + dims.off[l];
    FragC acc[MAX_CT][ROW_TILES];
#pragma unroll
    for (int j = 0; j < MAX_CT; ++j)
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i) wmma::fill_fragment(acc[j][i], 0.f);
    const int n_slabs = k_dim / KS;
    stage_weight_rows<KS>(w, 0, n_dim, slabs, ld);
    for (int ks = 0; ks < n_slabs; ++ks) {
      if (ks + 1 < n_slabs) {
        stage_weight_rows<KS>(w, (ks + 1) * KS, n_dim, slabs + ((ks + 1) % 2) * slab_elems, ld);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* slab = slabs + (ks % 2) * slab_elems;
      FragA a[ROW_TILES];
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i)
        wmma::load_matrix_sync(a[i], h_in + i * 16 * ld + ks * KS, ld);
#pragma unroll
      for (int j = 0; j < MAX_CT; ++j) {
        const int ct = warp + j * WARPS;
        if (ct < n_ct) {
          FragB bf;
          wmma::load_matrix_sync(bf, slab + ct * 16, ld);
#pragma unroll
          for (int i = 0; i < ROW_TILES; ++i) wmma::mma_sync(acc[j][i], a[i], bf, acc[j][i]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < MAX_CT; ++j) {
      const int ct = warp + j * WARPS;
      if (ct >= n_ct) continue;
      const bool real = ct * 16 < d_out;  // a 16-column tile lies in one half
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i) {
        wmma::store_matrix_sync(my, acc[j][i], 16, wmma::mem_row_major);
        __syncwarp();
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          // lane -> row i*16 + 2q + lane/16, column ct*16 + lane%16
          const int e = lane + 32 * q;
          const int row = i * 16 + e / 16;
          float v = my[e];
          const bool neg = real && v < 0.f;
          if (neg) v *= slope;
          h_out[row * ld + ct * 16 + (e % 16)] = __float2bfloat16_rn(v);
          const unsigned bits = __ballot_sync(0xffffffffu, neg);
          if (real && lane == 0) {
            uint16_t* mrow = masks + ((long long)l * TILE_ROWS + i * 16 + 2 * q) * mct + ct;
            mrow[0] = (uint16_t)(bits & 0xffffu);
            mrow[mct] = (uint16_t)(bits >> 16);
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
    __nv_bfloat16* t = h_in;
    h_in = h_out;
    h_out = t;
  }

  // transposed chain: g <- (bf16(g) @ P_l^T) * m_{l-1}, from the output back
  __nv_bfloat16* g_in = buf_a;
  __nv_bfloat16* g_out = buf_b;
  __syncthreads();  // the forward's buffers are no longer read
  stage_complex_rows<TILE_ROWS>(gr, gi, row0, rows, dims.d[n_layers], g_in, ld);
  for (int l = n_layers - 1; l >= 0; --l) {
    const int d_in = dims.d[l];
    const int k_dim = 2 * dims.d[l + 1];  // contracted: the layer's output width
    const int n_dim = 2 * d_in;
    const int n_ct = n_dim / 16;
    const __nv_bfloat16* w = wbuf + dims.off[l];  // (n_dim, k_dim) row-major
    FragC acc[MAX_CT][ROW_TILES];
#pragma unroll
    for (int j = 0; j < MAX_CT; ++j)
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i) wmma::fill_fragment(acc[j][i], 0.f);
    const int n_slabs = k_dim / KS;
    __syncthreads();  // g_in is staged; the slabs are free
    stage_cols(w, 0, k_dim, n_dim, slabs);
    for (int ks = 0; ks < n_slabs; ++ks) {
      if (ks + 1 < n_slabs) {
        stage_cols(w, (ks + 1) * KS, k_dim, n_dim, slabs + ((ks + 1) % 2) * slab_elems);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* slab = slabs + (ks % 2) * slab_elems;
      FragA a[ROW_TILES];
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i)
        wmma::load_matrix_sync(a[i], g_in + i * 16 * ld + ks * KS, ld);
#pragma unroll
      for (int j = 0; j < MAX_CT; ++j) {
        const int ct = warp + j * WARPS;
        if (ct < n_ct) {
          // B(k, n) = P[n][k]: col-major in the (n_dim x KS) slab
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, slab + ct * 16 * KS, KS);
#pragma unroll
          for (int i = 0; i < ROW_TILES; ++i) wmma::mma_sync(acc[j][i], a[i], bf, acc[j][i]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < MAX_CT; ++j) {
      const int ct = warp + j * WARPS;
      if (ct >= n_ct) continue;
      const bool masked = l > 0 && ct * 16 < d_in;
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i) {
        wmma::store_matrix_sync(my, acc[j][i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = i * 16 + e / 16;
          const int col = ct * 16 + (e % 16);
          float v = my[e];
          if (masked) {
            const uint16_t m = masks[((long long)(l - 1) * TILE_ROWS + row) * mct + ct];
            if ((m >> (e % 16)) & 1u) v *= slope_m;
          }
          if (l > 0) {
            g_out[row * ld + col] = __float2bfloat16_rn(v);
          } else {
            const long long gidx = row0 + row;
            if (gidx < n_rows) {
              if (col < d_in) dxr[gidx * d_in + col] = v;
              else dxi[gidx * d_in + (col - d_in)] = v;
            }
          }
        }
        __syncwarp();
      }
    }
    __syncthreads();
    __nv_bfloat16* t = g_in;
    g_in = g_out;
    g_out = t;
  }
}

}  // namespace

// xr, xi: (n_rows, d[0]) fp32 and gr, gi: (n_rows, d[n_layers]) fp32, all
// 16-byte aligned; wbuf: the forward kernel's packed bf16 weights, layer l
// at off[l] with shape (2 d[l], 2 d[l+1]); dxr, dxi: (n_rows, d[0]) fp32.
// Every d must be a multiple of 16 and at most 512.
extern "C" int spectral_mlp_bwd_bf16(const void* xr, const void* xi, const void* gr,
                                     const void* gi, const void* wbuf, const int* d,
                                     const long long* off, int n_layers, void* dxr, void* dxi,
                                     int n_rows, float slope, void* stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS || n_rows < 1)
    return (int)cudaErrorInvalidValue;
  MlpDims dims;
  dims.n_layers = n_layers;
  int d_max = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (d[l] <= 0 || d[l] % 16 != 0) return (int)cudaErrorInvalidValue;
    dims.d[l] = d[l];
    d_max = d[l] > d_max ? d[l] : d_max;
  }
  for (int l = 0; l < n_layers; ++l) dims.off[l] = off[l];
  if (2 * d_max > 16 * WARPS * MAX_CT) return (int)cudaErrorInvalidValue;
  const int ld = 2 * d_max + PAD;
  const int slab_elems = KS * ld > 2 * d_max * KS ? KS * ld : 2 * d_max * KS;
  const int mct = d_max / 16;  // mask words per row and layer
  const size_t smem = (2 * (size_t)TILE_ROWS * ld + 2 * (size_t)slab_elems) * sizeof(__nv_bfloat16) +
                      (size_t)WARPS * 256 * sizeof(float) +
                      (size_t)(n_layers > 1 ? n_layers - 1 : 0) * TILE_ROWS * mct * sizeof(uint16_t);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  spectral_mlp_bwd_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (const float*)gr, (const float*)gi,
      (const __nv_bfloat16*)wbuf, dims, (float*)dxr, (float*)dxi, n_rows, slope, ld, slab_elems,
      mct);
  return (int)cudaGetLastError();
}
