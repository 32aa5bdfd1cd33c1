// Complex spectral MLP over SHT mode rows, bf16 tensor-core GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/spectral_mlp.py:spectral_mlp (the Pallas
// `_karatsuba_call` / `_packed_call` TPU kernels).  Per mode row n:
//
//   h0 = [xr_n | xi_n];  h_{l+1} = act_l(h_l @ P_l);  out = h_L
//   P_l = [[wr, wi], [-wi, wr]]  (2 d_l x 2 d_{l+1}, packed complex weight)
//   act_l = LeakyReLU(slope) on the real half (columns < d_{l+1}), identity
//           on the imaginary half, for every layer but the last (wout).
//
// The packed product is the 4-product complex form (hr wr - hi wi,
// hr wi + hi wr), not Karatsuba: bf16 operands wr, wi are rounded once, where
// the JAX Karatsuba kernel also rounds the sums wi - wr and wr + wi.
//
// Bound on the H100: one launch at the serving shapes (14,520 rows,
// 256 -> 512 -> 512 -> 512 -> 256) is ~9.1e10 FLOP against ~30 MB of
// activations and ~6 MB of weights, so it is bound by tensor-core
// operations (~0.09 ms at the bf16 dense peak), not by memory.
//
// Design: the TPU kernel keeps all ~6 MB of weights resident in VMEM; a
// Hopper block has at most 227 KB.  Here a block owns TILE_ROWS mode rows and
// keeps their whole [re | im] hidden state on chip, in bf16, across all
// layers (ping-pong between two shared buffers of TILE_ROWS x (2*512+8)
// values); only the input is read from and the output written to device
// memory.  Weights stream from L2 (all of them fit in its 50 MB) in slabs of
// 16 rows, double-buffered with cp.async into shared memory; each warp owns
// up to 4 column tiles and reuses its A fragments across them.  Matmul
// operands are bf16 with fp32 accumulation; the hidden state is rounded to
// bf16 when written back to shared memory, where the TPU kernel rounds it at
// the next dot: the same rounding point.

#include "tile_common.cuh"

namespace {

constexpr int MAX_LAYERS = 8;
#ifndef TILE_ROWS_OVERRIDE
#define TILE_ROWS_OVERRIDE 32
#endif
constexpr int TILE_ROWS = TILE_ROWS_OVERRIDE;   // mode rows per block
constexpr int ROW_TILES = TILE_ROWS / 16;
#ifndef WARPS_OVERRIDE
#define WARPS_OVERRIDE 16
#endif
constexpr int WARPS = WARPS_OVERRIDE;
constexpr int PAD = 8;          // bf16 elements of padding per shared row
constexpr int MAX_CT = 4;       // column tiles per warp: widths up to 16 * WARPS * MAX_CT / 2
constexpr int KS = 16;          // weight rows per staged slab

struct MlpDims {
  int n_layers;
  int d[MAX_LAYERS + 1];
  long long off[MAX_LAYERS];  // element offset of P_l in the weight buffer
};

__global__ void __launch_bounds__(WARPS * 32)
spectral_mlp_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    const __nv_bfloat16* __restrict__ wbuf, MlpDims dims,
                    float* __restrict__ out_r, float* __restrict__ out_i,
                    int n_rows, float slope, int ld) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* buf_a = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* buf_b = buf_a + TILE_ROWS * ld;
  __nv_bfloat16* slabs = buf_b + TILE_ROWS * ld;               // 2 x (KS x ld)
  float* scratch = reinterpret_cast<float*>(slabs + 2 * KS * ld);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 = (long long)blockIdx.x * TILE_ROWS;
  float* my_scratch = scratch + warp * 256;

  // stage the input rows as bf16 [re | im]; rows past the end are zero
  const long long rows_left = n_rows - row0;
  const int rows = rows_left < TILE_ROWS ? (int)rows_left : TILE_ROWS;
  stage_complex_rows<TILE_ROWS>(xr, xi, row0, rows, dims.d[0], buf_a, ld);

  __nv_bfloat16* h_in = buf_a;
  __nv_bfloat16* h_out = buf_b;
  for (int l = 0; l < dims.n_layers; ++l) {
    const int d_out = dims.d[l + 1];
    const int k_dim = 2 * dims.d[l];
    const int n_dim = 2 * d_out;
    const int n_ct = n_dim / 16;
    const __nv_bfloat16* w = wbuf + dims.off[l];
    const bool last = (l == dims.n_layers - 1);

    FragC acc[MAX_CT][ROW_TILES];
#pragma unroll
    for (int j = 0; j < MAX_CT; ++j)
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i) wmma::fill_fragment(acc[j][i], 0.f);

    // K slabs of the weights stream in (double-buffered cp.async) while the
    // previous slab is multiplied; every warp reads its A fragments once per
    // slab and applies them to all of its column tiles
    const int n_slabs = k_dim / KS;
    stage_weight_rows<KS>(w, 0, n_dim, slabs, ld);
    for (int ks = 0; ks < n_slabs; ++ks) {
      if (ks + 1 < n_slabs) {
        stage_weight_rows<KS>(w, (ks + 1) * KS, n_dim, slabs + ((ks + 1) % 2) * KS * ld, ld);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* slab = slabs + (ks % 2) * KS * ld;
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
      __syncthreads();  // this slab buffer is refilled two slabs on
    }

#pragma unroll
    for (int j = 0; j < MAX_CT; ++j) {
      const int ct = warp + j * WARPS;
      if (ct >= n_ct) continue;
      // every element of a 16-column tile lies in the same (re or im) half
      const bool act = !last && (ct * 16 < d_out);
#pragma unroll
      for (int i = 0; i < ROW_TILES; ++i) {
        if (act) {
          for (int e = 0; e < acc[j][i].num_elements; ++e) {
            const float v = acc[j][i].x[e];
            acc[j][i].x[e] = v >= 0.f ? v : slope * v;
          }
        }
        wmma::store_matrix_sync(my_scratch, acc[j][i], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int row = i * 16 + e / 16;
          const int col = ct * 16 + (e % 16);
          const float v = my_scratch[e];
          if (!last) {
            h_out[row * ld + col] = __float2bfloat16_rn(v);
          } else {
            const long long g = row0 + row;
            if (g < n_rows) {
              if (col < d_out) out_r[g * d_out + col] = v;
              else out_i[g * d_out + (col - d_out)] = v;
            }
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
}

}  // namespace

// xr, xi: (n_rows, d[0]) fp32, 16-byte aligned; wbuf: packed bf16 weights, layer l at off[l]
// with shape (2 d[l], 2 d[l+1]); out_r, out_i: (n_rows, d[n_layers]) fp32.
// Every d must be a multiple of 16 and at most 512.
extern "C" int spectral_mlp_bf16(const void* xr, const void* xi, const void* wbuf,
                                 const int* d, const long long* off, int n_layers,
                                 void* out_r, void* out_i, int n_rows, float slope,
                                 void* stream) {
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
  const size_t smem = (2 * (size_t)TILE_ROWS + 2 * KS) * ld * sizeof(__nv_bfloat16) +
                      (size_t)WARPS * 256 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      spectral_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + TILE_ROWS - 1) / TILE_ROWS;
  spectral_mlp_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (const __nv_bfloat16*)wbuf, dims,
      (float*)out_r, (float*)out_i, n_rows, slope, ld);
  return (int)cudaGetLastError();
}
