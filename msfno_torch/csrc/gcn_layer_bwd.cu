// Backward of one masked-grid GCN layer (sm_90a): a strip-walk stencil pass
// and two TMA + wgmma GEMMs on bf16 operands; on fp32 ones two
// split-precision TF32 GEMMs (dx on wgmma, dW on mma.sync).
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
// fp32 operands (the JAX exact, balanced and fp32-kernel tiers' generator):
// dsup stays fp32 and the products are fp32-class: three TF32 tensor-core
// passes over hi / lo splits, for the "float32" and "tensorfloat" knobs
// alike.
//
// Bound on the H100 at a 512 -> 512 layer (1, 180, 360): g, y, res and x in
// bf16 (4 x 66 MB) and dx in fp32 (133 MB), ~0.40 GB -> 0.12 ms at 3.35
// TB/s; 2 GEMMs of 2 * 64,800 * 512 * 512 = 6.8e10 FLOP -> 0.07 ms: bytes.
// fp32 operands: the same 6.8e10 FLOP at 495 / 3 = 165 TFLOP/s (the least
// time of an fp32-class product on this card) -> 0.41 ms: operations.
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
//   fixed order: deterministic, no atomics.
// fp32 operands: the same passes, both products split-precision TF32
// (three tensor-core passes over hi / lo splits, fp32 accumulation).
//   dx = dsup W^T on row_gemm.cuh:gemm_tf32x3 (A: dsup's fp32 rows by
//   16-byte loads; B: the hi / lo split of W as stored, (c_in x F) = its
//   (N x K) K-major form, made on every call by `tf32_split_rows` into the
//   caller's scratch: W is a trained weight that the optimizer updates in
//   place, so no split outlives a call).
//   dW = x^T dsup on `dw_mma`: both operands are stored pixels outermost
//   (MN-major), which tf32 wgmma cannot read, so mma.sync.m16n8k8 TF32
//   with fragments read from MN-major shared-memory tiles (x and dsup as
//   stored, by cp.async), split into hi / lo in registers.  A/B on the
//   H100 at 512 -> 512 (tools/kernel_variants.py --profile): 0.642 ms
//   against 0.754 for a wgmma variant of gemm_tf32x3 whose loader
//   transposed both operands into the K-major swizzle while it split
//   them.  Split over pixel ranges into partials of 128 x 128 tiles, as
//   many splits as make four blocks an SM (132 SMs).
//
// Tunables (tools/kernel_variants.py): DS_ROWS (strip height), DS_FB
// (feature band: 8, 16 or 32), DS_PIX (longitudes a block loads); WGM_BN,
// WGM_STAGES, TF3_STAGES of row_gemm.cuh; MMA_STAGES (dw_mma's ring).

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

#ifndef MMA_STAGES_OVERRIDE
#define MMA_STAGES_OVERRIDE 3
#endif

// dW = x^T dsup on fp32 operands (see the note at the top): C (m x n) =
// A^T B with A (k x m) and B (k x n) stored K outermost.  A block owns a
// 128 x 128 tile of one K range (blockIdx.z) and loads 32 K rows a stage
// of both tiles as stored, by cp.async (16-byte copies where both
// operands' rows are 16-byte multiples, else 4-byte ones), into a ring of
// MMA_STAGES stages whose rows are padded to 136 floats (a fragment's 32
// loads hit 32 banks).  8 warps of 64 x 32: per k8 step each warp reads
// its 4 A and 4 B fragments, splits them into hi / lo in registers and
// issues lo.hi, hi.lo and hi.hi for each of its 16 m16n8 tiles into a
// per-stage accumulator that the CUDA cores add to a second one (fp32,
// round to nearest).  Writes split z's partial product to out + z m n.
constexpr int MMA_BM = 128, MMA_BN = 128, MMA_BK = 32, MMA_LD = 136;
constexpr int MMA_STAGES = MMA_STAGES_OVERRIDE;
constexpr int MMA_THREADS = 256;
constexpr int MMA_STAGE_FLOATS = 2 * MMA_BK * MMA_LD;
constexpr int MMA_SMEM = MMA_STAGES * MMA_STAGE_FLOATS * 4;
static_assert(MMA_STAGES >= 2 && MMA_SMEM <= 232448, "dw_mma's ring does not fit");

// 4-byte global -> shared copy; src_bytes == 0 writes zeros without reading
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void split_u32(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_rna(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(tf32_rna(x - h));
}

template <bool VEC>
__global__ void __launch_bounds__(MMA_THREADS, 1)
    dw_mma(const float* __restrict__ x, int m, const float* __restrict__ d, int n, int k,
           int k_split, float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int n_tiles = (n + MMA_BN - 1) / MMA_BN;
  const int m0 = blockIdx.x / n_tiles * MMA_BM, n0 = blockIdx.x % n_tiles * MMA_BN;
  const int kb = blockIdx.z * k_split, ke = min(k, kb + k_split);
  const int n_st = ke > kb ? (ke - kb + MMA_BK - 1) / MMA_BK : 0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;
  // stage st into its slot: thread tid copies 16-byte chunks tid + 256 i
  // (a warp: one K row of 128 floats) of both tiles; zeros past K, M, N
  auto load = [&](int st) {
    float* as = sm + (st % MMA_STAGES) * MMA_STAGE_FLOATS;
    float* bs = as + MMA_BK * MMA_LD;
    const int k0 = kb + st * MMA_BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + MMA_THREADS * i, row = c / 32, col = (c % 32) * 4, kk = k0 + row;
      const float* pa = x + (long long)kk * m + m0 + col;
      const float* pb = d + (long long)kk * n + n0 + col;
      if (VEC) {  // m and n multiples of 4: a chunk is wholly in or out
        const bool oka = kk < ke && m0 + col < m, okb = kk < ke && n0 + col < n;
        cp_async16(as + row * MMA_LD + col, oka ? pa : x, oka ? 16 : 0);
        cp_async16(bs + row * MMA_LD + col, okb ? pb : d, okb ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool oka = kk < ke && m0 + col + e < m, okb = kk < ke && n0 + col + e < n;
          cp_async4(as + row * MMA_LD + col + e, oka ? pa + e : x, oka ? 4 : 0);
          cp_async4(bs + row * MMA_LD + col + e, okb ? pb + e : d, okb ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
#pragma unroll
  for (int st = 0; st < MMA_STAGES - 1; ++st)
    if (st < n_st) load(st);
  for (int st = 0; st < n_st; ++st) {
    // stage st has landed once at most min(STAGES - 2, n_st - 1 - st)
    // later groups are pending
    if (st + MMA_STAGES - 2 < n_st) cp_async_wait<MMA_STAGES - 2>();
    else cp_async_wait<0>();
    __syncthreads();  // and every warp is done with the slot refilled next
    if (st + MMA_STAGES - 1 < n_st) load(st + MMA_STAGES - 1);
    const float* as = sm + (st % MMA_STAGES) * MMA_STAGE_FLOATS;
    const float* bs = as + MMA_BK * MMA_LD;
    float part[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int k8 = 0; k8 < MMA_BK; k8 += 8) {
      // fragments (m16n8k8, row-major A, column-major B): a[0..3] at (row
      // g, g + 8) x (k t, t + 4), b[0..1] at k t, t + 4 of column g
      uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* p = as + (k8 + t) * MMA_LD + wm + 16 * i + g;
        split_u32(p[0], ah[i][0], al[i][0]);
        split_u32(p[8], ah[i][1], al[i][1]);
        split_u32(p[4 * MMA_LD], ah[i][2], al[i][2]);
        split_u32(p[4 * MMA_LD + 8], ah[i][3], al[i][3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* p = bs + (k8 + t) * MMA_LD + wn + 8 * j + g;
        split_u32(p[0], bh[j][0], bl[j][0]);
        split_u32(p[4 * MMA_LD], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // the small terms first
          mma_tf32(part[i][j], al[i], bh[j]);
          mma_tf32(part[i][j], ah[i], bl[j]);
          mma_tf32(part[i][j], ah[i], bh[j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  // d[0..3] at (row g, column 2 t, 2 t + 1), (row g + 8, the same): n even
  float* o = out + (long long)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm + 16 * i + g + 8 * h, c = n0 + wn + 8 * j + 2 * t;
        if (r < m && c < n)
          *reinterpret_cast<float2*>(o + (long long)r * n + c) =
              make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
      }
}

// x (k x m) and d (k x n) fp32, n even; out: splits x m x n partials.
// Returns a CUDA error code.
template <bool VEC>
int dw_mma_run(const float* x, int m, const float* d, int n, int k, int splits, float* out,
               cudaStream_t st) {
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(dw_mma<VEC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               MMA_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  const int k_split = ((k + splits - 1) / splits + MMA_BK - 1) / MMA_BK * MMA_BK;
  const dim3 grid(((m + MMA_BM - 1) / MMA_BM) * ((n + MMA_BN - 1) / MMA_BN), 1, splits);
  dw_mma<VEC><<<grid, MMA_THREADS, MMA_SMEM, st>>>(x, m, d, n, k, k_split, out);
  return (int)cudaGetLastError();
}

int dw_mma_launch(const float* x, int m, const float* d, int n, int k, int splits, float* out,
                  cudaStream_t st) {
  if (m < 1 || n < 2 || n % 2 || k < 1 || splits < 1 || splits > 65535 ||
      (long long)((m + MMA_BM - 1) / MMA_BM) * ((n + MMA_BN - 1) / MMA_BN) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec = m % 4 == 0 && n % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(d)) % 16 == 0;
  return vec ? dw_mma_run<true>(x, m, d, n, k, splits, out, st)
             : dw_mma_run<false>(x, m, d, n, k, splits, out, st);
}

enum Ptr { P_G, P_Y, P_RES, P_X, P_W, P_DINV, P_MASK, P_DX, P_DW, P_DB, P_DSUP, P_PART_DB,
           P_PART_DW, P_GRP_DB, P_GRP_DW, P_W_X3, N_PTRS };
enum Int { I_B, I_H, I_W, I_C_IN, I_F, I_ACT_BF16, I_X_BF16, I_DM_BF16, I_SPLITS, I_F32,
           I_GROUPS, I_F_PAD, N_INTS };

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
// of ceil(B*H*segments / groups)); w_x3: for fp32 operands with c_in > 1
// and dx, scratch of 2*c_in*f_pad floats (the split of w, rows padded to
// f_pad, a multiple of 4 >= F).  F is a multiple of 8; for c_in > 1 on
// bf16 operands so is c_in, and x is a bf16 array; on fp32 operands x is
// fp32.  W must be at least 3.
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
  if (n_px > INT_MAX) return (int)cudaErrorInvalidValue;
  if (f32) {
    const float* dsup = (const float*)a.dsup;
    if (dx) {  // dx (n_px x c_in) = dsup (n_px x F) @ w^T: w stored (c_in x F) is B's (N x K)
      float* w_x3 = (float*)ptrs[P_W_X3];
      const long long f_pad = ints[I_F_PAD];
      if (!w_x3 || f_pad < a.f || f_pad % 4) return (int)cudaErrorInvalidValue;
      e = tf32_split_rows_launch((const float*)w, a.c_in, a.f, (int)f_pad, w_x3, st);
      if (!e)
        e = gemm_tf32x3_run<128>(F32Matrix<float>{dsup, a.f}, w_x3,
                                 w_x3 + a.c_in * f_pad, f_pad, n_px, a.c_in, a.f, 1, 0,
                                 TcStore{dx, a.c_in, n_px, a.c_in}, st);
      if (e) return e;
    }
    // dW partials (splits x c_in x F) = x^T dsup over pixel ranges
    e = dw_mma_launch((const float*)a.x, a.c_in, dsup, a.f, (int)n_px, splits, part_dw, st);
  } else {
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
