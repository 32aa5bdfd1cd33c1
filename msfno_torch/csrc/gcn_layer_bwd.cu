// Backward of one masked-grid GCN layer (sm_90a): a strip-walk stencil pass
// and two TMA + wgmma GEMMs on bf16 operands, fp32 FMA GEMMs on fp32 ones.
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
// Design: the TPU kernel walks the latitude tiles in grid order, computes
// dagg * d once a row and carries the previous rows in VMEM, and
// accumulates dW and db in output blocks that every grid step revisits.
// CUDA blocks run in no order, so here three passes, each bounded by bytes:
//   1. `gcn_bwd_dsup` walks a strip of DS_ROWS latitude rows (plus one halo
//      row above and below) of a segment of DS_PIX - 2 longitudes (plus one
//      halo longitude each side, for the periodic taps) x a band of DS_FB
//      features, as the TPU kernel's row carry does: a thread owns one
//      longitude x 8 features and keeps the two previous rows' dagg * d in
//      registers, so g, y and res are read about (DS_ROWS + 2) / DS_ROWS x
//      DS_PIX / (DS_PIX - 2) times (the previous design recomputed the rows
//      above and below: 3 times).  The next row's loads are issued before
//      the current row's two block barriers, and d and x of the row being
//      emitted are carried, so a row costs one memory latency at most.  A
//      row's vertical sums go through shared memory for the longitude taps;
//      dsup is scaled by d and written in bf16, the rounding point of both
//      products (fp32 operands: fp32).  Per row and segment it writes the
//      column sums of dagg (and, for c_in == 1, of x * dsup) as partials: a
//      shuffle tree over a warp's longitudes, then the warps in order.
//      Small blocks (128 threads), many a SM: the first strip walk here, a
//      block a whole row of 360 longitudes with two a thread, 12 warps an
//      SM, ran 0.24 ms on the H100, no faster than the three-row recompute;
//      this one 0.12 ms (DS_ROWS 4 to 16 within 5%; DS_FB 16 with DS_PIX 64
//      0.14).  Bound: g, y, res read and dsup written, ~0.27 GB at 512 ->
//      512.
//   2. dx = dsup W^T on row_gemm.cuh's wgmma_gemm with B_T: W is stored (c_in
//      x F), the (N x K) layout that B_T reads, so no transpose is stored;
//      the epilogue writes fp32 dx.  Bound: dsup read, dx written (133 MB).
//   3. dW = x^T dsup on wgmma_gemm with A_T (x stored (pixels x c_in) read
//      MN-major), split over pixel ranges (blockIdx.z) into fp32 partials
//      (splits x c_in x F, ~1 MB a split).  Bound: x and dsup read.
//   Then `sum_rows` adds the dW partials, and `tile_reduce` and
//   `stats_reduce` the per-row db (and c_in == 1 dW) partials, each in a
//   fixed order: deterministic, no atomics.  fp32 operands keep the fp32 FMA GEMM of row_gemm.cuh for both
//   products.
//
// Tunables (tools/kernel_variants.py): DS_ROWS (strip height), DS_FB
// (feature band: 8, 16 or 32), DS_PIX (longitudes a block loads); WGM_BN,
// WGM_STAGES of row_gemm.cuh.

#include "row_gemm.cuh"

namespace {

#ifndef DS_ROWS_OVERRIDE
#define DS_ROWS_OVERRIDE 8
#endif
#ifndef DS_FB_OVERRIDE
#define DS_FB_OVERRIDE 32
#endif
#ifndef DS_PIX_OVERRIDE
#define DS_PIX_OVERRIDE 32
#endif
constexpr int DS_ROWS = DS_ROWS_OVERRIDE;     // latitude rows a block emits
constexpr int DS_FB = DS_FB_OVERRIDE;         // features a block owns
constexpr int DS_PIX = DS_PIX_OVERRIDE;       // longitudes a block loads, a thread each
constexpr int DS_EMIT = DS_PIX - 2;           // ... and emits: one halo longitude each side
constexpr int VEC = 8;                        // features a thread: one 16-byte bf16 vector
constexpr int DS_TPP = DS_FB / VEC;           // threads a longitude
constexpr int DS_THREADS = DS_PIX * DS_TPP;
static_assert(DS_FB % VEC == 0 && 32 % DS_TPP == 0 && DS_THREADS % 32 == 0 &&
                  DS_THREADS <= 1024,
              "DS_FB is 8, 16 or 32; DS_PIX * DS_FB / 8 whole warps");

struct BwdArgs {
  const void* g;          // (B, H, W, F)
  const void* y;          // (B, H, W, F): the forward output
  const void* res;        // (B, H, W, F) or null
  const void* x;          // (B, H, W, c_in)
  const void* dinv;       // (B, H, W)
  const void* mask;       // (B, H, W)
  void* dsup;             // (B, H, W, F) scratch, bf16 or fp32 (f32); null: not needed
  float* part_db;         // (B * H * segments, F)
  float* part_dw1;        // (B * H * segments, F), c_in == 1 only
  int ht, wd, c_in, f, segs;
  int x_bf16, dm_bf16;
  float slope;
};

// 8 consecutive activations, as stored: one 16-byte vector of bf16, two of fp32
template <typename T> struct Raw8;
template <> struct Raw8<__nv_bfloat16> {
  uint4 v;
  __device__ __forceinline__ void load(const void* p, long long i) {
    v = *reinterpret_cast<const uint4*>(reinterpret_cast<const __nv_bfloat16*>(p) + i);
  }
  __device__ __forceinline__ float operator[](int e) const {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(&v)[e]);
  }
};
template <> struct Raw8<float> {
  float4 lo, hi;
  __device__ __forceinline__ void load(const void* p, long long i) {
    const float4* q = reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
    lo = q[0];
    hi = q[1];
  }
  __device__ __forceinline__ float operator[](int e) const {
    const float4& h = e < 4 ? lo : hi;
    const int k = e % 4;
    return k == 0 ? h.x : k == 1 ? h.y : k == 2 ? h.z : h.w;
  }
};

// v summed over the lanes of a warp that own the same 8 features (lane %
// DS_TPP); lanes < DS_TPP write the warp's sums to dst[feature]
__device__ __forceinline__ void warp_sums(float (&v)[VEC], float* dst, int fl, int lane) {
#pragma unroll
  for (int o = DS_TPP; o < 32; o *= 2)
#pragma unroll
    for (int e = 0; e < VEC; ++e) v[e] += __shfl_xor_sync(0xffffffffu, v[e], o);
  if (lane < DS_TPP) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[fl + e] = v[e];
  }
}

// Block (band, segment and strip, sample): features [f0, f0 + DS_FB) of
// longitudes [p0, p0 + DS_EMIT) and rows [r0, r1); a thread owns one of the
// DS_PIX longitudes [p0 - 1, p0 + DS_EMIT + 1) (periodic).  Iteration j
// takes row j (j = r0 - 1 and r1 are the halo rows, zero past the poles)
// from registers, issues the loads of row j + 1 and emits row j - 1 from the
// carried rows j - 2, j - 1 and row j: two block barriers a row, which the
// next row's loads overlap.  T is the activations' type (g, y, res).
template <bool F32, typename T>
__global__ void __launch_bounds__(DS_THREADS) gcn_bwd_dsup(BwdArgs a) {
  __shared__ __align__(16) float vs[DS_PIX][DS_FB];  // one row's vertical sums
  __shared__ float red[2][DS_THREADS / 32][DS_FB];   // warps' db and dw1 sums
  const int f0 = blockIdx.x * DS_FB;
  const int seg = blockIdx.y % a.segs, strip = blockIdx.y / a.segs, b = blockIdx.z;
  const int r0 = strip * DS_ROWS, r1 = min(a.ht, r0 + DS_ROWS);
  const int p0 = seg * DS_EMIT, n_emit = min(DS_EMIT, a.wd - p0);
  const int i = threadIdx.x / DS_TPP, fl = (threadIdx.x % DS_TPP) * VEC;
  const bool f_ok = f0 + fl < a.f;  // F % 8 == 0: a vector is wholly in or out
  const bool loaded = f_ok && i < n_emit + 2, emitter = f_ok && i >= 1 && i <= n_emit;
  int p = p0 - 1 + i;
  p = p < 0 ? p + a.wd : p >= a.wd ? p - a.wd : p;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long plane = (long long)b * a.ht;
  Raw8<T> rg, ry, rr;  // row j + 1, in flight
  float rm = 0.f, rd = 0.f, rx = 0.f;
  auto fetch = [&](int row) {
    if (row < 0 || row >= a.ht || !loaded) return;
    const long long px = (plane + row) * a.wd + p, e = px * a.f + f0 + fl;
    rg.load(a.g, e);
    ry.load(a.y, e);
    if (a.res) rr.load(a.res, e);
    rm = load_act(a.mask, px, a.dm_bf16);
    rd = load_act(a.dinv, px, a.dm_bf16);
    if (a.c_in == 1) rx = load_act(a.x, px, a.x_bf16);
  };
  fetch(r0 - 1);
  float prev[VEC], cur[VEC];  // dagg * d of rows j - 2 and j - 1
#pragma unroll
  for (int e = 0; e < VEC; ++e) prev[e] = cur[e] = 0.f;
  float d_cur = 0.f, x_cur = 0.f;  // d and x of row j - 1
  for (int j = r0 - 1; j <= r1; ++j) {
    const bool in_grid = j >= 0 && j < a.ht, own = j >= r0 && j < r1, emit = j > r0;
    float nxt[VEC], db[VEC];
    const float d_j = rd, x_j = rx;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      db[e] = 0.f;
      nxt[e] = 0.f;
      if (in_grid && loaded) {
        const float act = ry[e] - (a.res ? rr[e] : 0.f) >= 0.f ? 1.f : a.slope;
        const float dagg = rg[e] * act * rm;
        if (emitter) db[e] = dagg;
        nxt[e] = dagg * rd;
      }
    }
    if (j < r1) fetch(j + 1);
    if (emit && loaded) {  // row j - 1's vertical sums: (own + above) + below
      float4* dst = reinterpret_cast<float4*>(&vs[i][fl]);
      dst[0] = make_float4(cur[0] + prev[0] + nxt[0], cur[1] + prev[1] + nxt[1],
                           cur[2] + prev[2] + nxt[2], cur[3] + prev[3] + nxt[3]);
      dst[1] = make_float4(cur[4] + prev[4] + nxt[4], cur[5] + prev[5] + nxt[5],
                           cur[6] + prev[6] + nxt[6], cur[7] + prev[7] + nxt[7]);
    }
    if (own) warp_sums(db, red[0][warp], fl, lane);
    __syncthreads();
    if (emit) {  // row j - 1: longitude taps (own + left) + right, times d
      float dw[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) dw[e] = 0.f;
      if (emitter) {
        float xv = x_cur;
        if (!F32) xv = __bfloat162float(__float2bfloat16_rn(xv));
        float ds[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          ds[e] = (vs[i][fl + e] + vs[i - 1][fl + e] + vs[i + 1][fl + e]) * d_cur;
          if (!F32) ds[e] = __bfloat162float(__float2bfloat16_rn(ds[e]));
          dw[e] = xv * ds[e];
        }
        if (a.dsup) {
          const long long oi = ((plane + j - 1) * a.wd + p) * a.f + f0 + fl;
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
      if (a.c_in == 1) warp_sums(dw, red[1][warp], fl, lane);
    }
    const int col = threadIdx.x;
    if (own && col < DS_FB && f0 + col < a.f) {  // row j's db: the warps in order
      float t = 0.f;
      for (int w = 0; w < DS_THREADS / 32; ++w) t += red[0][w][col];
      a.part_db[((plane + j) * a.segs + seg) * a.f + f0 + col] = t;
    }
    __syncthreads();
    if (emit && a.c_in == 1 && col < DS_FB && f0 + col < a.f) {  // row j - 1's dW
      float t = 0.f;
      for (int w = 0; w < DS_THREADS / 32; ++w) t += red[1][w][col];
      a.part_dw1[((plane + j - 1) * a.segs + seg) * a.f + f0 + col] = t;
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      prev[e] = cur[e];
      cur[e] = nxt[e];
    }
    d_cur = d_j;
    x_cur = x_j;
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

// wgmma_gemm epilogue: the fp32 fragment to out (rows of ld floats, n_cols
// of them), split z of the product at out + z * z_stride
struct StoreEpi {
  float* out;
  long long ld, z_stride;
  int n_cols;
  bool vec;
  __device__ __forceinline__ void operator()(float (&d)[64], long long row0, int rows,
                                             int col0) const {
    float* o = out + blockIdx.z * z_stride;
    store_acc<float>(d, o, o, INT_MAX, ld, row0, rows, col0, n_cols, vec);
  }
};

enum Ptr { P_G, P_Y, P_RES, P_X, P_W, P_DINV, P_MASK, P_DX, P_DW, P_DB, P_DSUP, P_PART_DB,
           P_PART_DW, P_GRP_DB, P_GRP_DW, N_PTRS };
enum Int { I_B, I_H, I_W, I_C_IN, I_F, I_ACT_BF16, I_X_BF16, I_DM_BF16, I_SPLITS, I_F32,
           I_GROUPS, N_INTS };

}  // namespace

// The longitude segments of a latitude row in the dsup pass: the per-row
// partials are (B * H * segments, F).
extern "C" int gcn_layer_bwd_segments(int wd) { return (wd + DS_EMIT - 1) / DS_EMIT; }

// ptrs and ints follow the Ptr and Int enums above.  f32 (ints[I_F32]):
// fp32 operands, else bf16; act_bf16: g, y and res are bf16, else fp32.  w:
// (c_in, F) of the operand type; dx (fp32, B*H*W x c_in) may be null (not
// needed); dsup: scratch of B*H*W*F values of the operand type (may be null
// for c_in == 1 without dx); part_db: B*H*segments*F floats; part_dw: as
// many for c_in == 1, else splits*c_in*F; grp_db (and, for c_in == 1,
// grp_dw): groups*F floats (the per-row partials are added in `groups` runs
// of ceil(B*H*segments / groups)).  F is a multiple of 8; for c_in >
// 1 on bf16 operands so is c_in, and x is a bf16 array; on fp32 operands x
// is fp32.  W must be at least 3.
extern "C" int gcn_layer_bwd(const void* const* ptrs, const long long* ints, float slope,
                             void* stream) {
  BwdArgs a;
  a.g = ptrs[P_G];
  a.y = ptrs[P_Y];
  a.res = ptrs[P_RES];
  a.x = ptrs[P_X];
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
  const int act_bf16 = (int)ints[I_ACT_BF16];
  a.x_bf16 = (int)ints[I_X_BF16];
  a.dm_bf16 = (int)ints[I_DM_BF16];
  a.slope = slope;
  const int splits = (int)ints[I_SPLITS];
  const bool f32 = ints[I_F32] != 0;
  const void* w = ptrs[P_W];
  float* dx = (float*)ptrs[P_DX];
  a.segs = gcn_layer_bwd_segments(a.wd);
  const int strips = (a.ht + DS_ROWS - 1) / DS_ROWS;
  if (b < 1 || b > 65535 || a.ht < 1 || (long long)strips * a.segs > 65535 || a.wd < 3 ||
      a.c_in < 1 || a.f < 8 || a.f % 8 ||
      splits < 1 || (a.c_in > 1 && !f32 && (a.c_in % 8 || !a.x_bf16)) ||
      (a.c_in > 1 && f32 && a.x_bf16) || ((a.c_in > 1 || dx) && a.dsup == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  void (*dsup_kernel)(BwdArgs) =
      f32 ? (act_bf16 ? &gcn_bwd_dsup<true, bf> : &gcn_bwd_dsup<true, float>)
          : (act_bf16 ? &gcn_bwd_dsup<false, bf> : &gcn_bwd_dsup<false, float>);
  dsup_kernel<<<dim3((a.f + DS_FB - 1) / DS_FB, strips * a.segs, b), DS_THREADS, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long n_px = (long long)b * a.ht * a.wd;
  const int rows = b * a.ht * a.segs;
  float* dw = (float*)ptrs[P_DW];
  float* part_dw = (float*)ptrs[P_PART_DW];
  // the per-row partials of db (and, for c_in == 1, dW): runs, then the runs
  const int groups = (int)ints[I_GROUPS], per = (rows + groups - 1) / groups;
  if (groups < 1 || (long long)per * (groups - 1) >= rows) return (int)cudaErrorInvalidValue;
  float* grp_db = (float*)ptrs[P_GRP_DB];
  float* grp_dw = a.c_in == 1 ? (float*)ptrs[P_GRP_DW] : nullptr;
  const dim3 rgrid((a.f + 31) / 32, 1);
  tile_reduce<<<dim3(rgrid.x, 1, groups), dim3(32, 8), 0, st>>>(
      a.part_db, a.c_in == 1 ? part_dw : nullptr, rows, per, a.f, grp_db, grp_dw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  stats_reduce<<<rgrid, dim3(32, 8), 0, st>>>(grp_db, grp_dw, groups, a.f, (float*)ptrs[P_DB],
                                              a.c_in == 1 ? dw : nullptr);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  int e = 0;
  if (a.c_in == 1) {
    if (dx) {
      const unsigned blocks = (unsigned)((n_px * 32 + 255) / 256);
      if (f32)
        gcn_bwd_dx_c1<float><<<blocks, 256, 0, st>>>((const float*)a.dsup, (const float*)w,
                                                     n_px, a.f, dx);
      else
        gcn_bwd_dx_c1<bf><<<blocks, 256, 0, st>>>((const bf*)a.dsup, (const bf*)w, n_px, a.f,
                                                  dx);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return 0;
  }
  if (f32) {
    if (dx)  // dx (n_px x c_in) = dsup (n_px x F) @ w^T, w stored (c_in x F)
      e = gemm_f32_launch<false, true>((const float*)a.dsup, a.f, (const float*)w, a.f, dx,
                                       a.c_in, (int)n_px, a.c_in, a.f, 1, nullptr, 0, st);
    if (e) return e;
    // dW partials (splits x c_in x F) = x^T dsup over pixel ranges
    e = gemm_f32_launch<true, false>((const float*)a.x, a.c_in, (const float*)a.dsup, a.f,
                                     part_dw, a.f, a.c_in, a.f, n_px, splits, nullptr, 0, st);
  } else {
    if (n_px > INT_MAX) return (int)cudaErrorInvalidValue;
    if (dx)  // dx (n_px x c_in) = dsup (n_px x F) @ w^T: w stored (c_in x F) is B_T's B
      e = wgmma_gemm_launch<StoreEpi, true>(
          a.dsup, a.f, w, a.f, (int)n_px, a.c_in, a.f,
          StoreEpi{dx, a.c_in, 0, a.c_in, a.c_in % 4 == 0}, st);
    if (e) return e;
    // dW partials (splits x c_in x F) = x^T dsup: x stored (n_px x c_in) is A_T's A
    e = wgmma_gemm_launch<StoreEpi, false, true>(
        a.x, a.c_in, a.dsup, a.f, a.c_in, a.f, (int)n_px,
        StoreEpi{part_dw, a.f, (long long)a.c_in * a.f, a.f, a.f % 4 == 0}, st, splits);
  }
  if (e) return e;
  const int n = a.c_in * a.f;
  sum_rows<<<(n + 255) / 256, 256, 0, st>>>(part_dw, splits, n, dw);
  return (int)cudaGetLastError();
}
