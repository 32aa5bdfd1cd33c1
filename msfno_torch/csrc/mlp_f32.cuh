// The pointwise two-layer MLP on fp32 operands, shared by grid_mlp.cu, the
// head (grid_encoder_spectral.cu) and the tail (spectral_decoder.cu).  Per
// pixel row:
//
//   u = A_s * x + B_s                  (optional per-sample channel affine)
//   h = gelu_exact(u @ W1a [+ skip @ W1b] + b1)
//   y = h @ W2 [+ b2] [+ pe[row % pe_rows]] [+ res]
//   out = round(y, out dtype);  optionally per-sample sum(y), sum(y*y)
//
// with no rounding of any operand (the JAX kernels' "float32" and
// "tensorfloat" knobs), as fp32-class products on the tensor cores.  x, the
// skip, pe and the residual are read as stored, fp32 or bf16.
//
// Bound on the H100: operations, e.g. the encoder site (1,038,240 rows, 73
// -> 256 -> 256) 1.75e11 FLOP, 1.06 ms at 165 TFLOP/s (an fp32-class
// product's least time on this card); its bytes (x, pe, y: 2.6 GB fp32)
// 0.8 ms.
//
// Design, mlp_tf32x3_run: two launches of row_gemm.cuh:gemm_tf32x3, three
// TF32 tensor-core passes over hi / lo splits, B the prepared hi / lo
// K-major halves of W1^T and W2^T (tf32x3.py:kmajor_split), h (rows x
// hidden, fp32) through device memory.  The first GEMM's A is the caller's
// functor, read by 16-byte loads where its rows allow (grid_mlp's GmInput:
// x, then the skip; the head's: x's 73-wide rows copied into rows of 76 by
// pad_rows; the tail's: [a x + b | skip | 0] rows of 332); its epilogue
// HiddenGelu adds b1, applies the exact GELU (chain_gemm.cuh:gelu_rational)
// and writes fp32 h.  The second reads h (F32Matrix, or a caller's type of
// the same layout: a name of its own in a profile).  Without statistics on
// OUT_BN-column tiles (80: the tail's 73 output columns) and OutStore; with
// them on 128-column tiles and OutStats, which also writes the statistics'
// tile partials: each thread sums its two rows, the warp's 8 row groups add
// by a fixed butterfly of shuffles, then the 8 warps in order, into one
// partial per (sample, 128-row tile, column), which tile_reduce and
// stats_reduce (tile_common.cuh) add in a fixed order (mlp_stats_reduce):
// no atomics, deterministic.  Both epilogues add one of b2, pe and the
// residual (OutAdd, loaded before the first store of y) and write y
// (OutStats: fp32 y).  Both GEMMs' row segments are the samples, so no tile
// crosses a sample.  h's round trip costs 2 x rows x hidden x 4 bytes (the
// encoder site: 2.1 GB, ~0.6 ms at the HBM rate).

#pragma once

#include "chain_gemm.cuh"

namespace {

// the first GEMM's A: row m's main channels (the affine applied), then its
// skip channels
struct MlpInput {
  const void* x;
  const void* skip;
  const float* aff_a;  // (samples, c_main) or null
  const float* aff_b;
  int c_main, c_skip, x_bf16, skip_bf16;
  __device__ __forceinline__ float operator()(long long m, long long k, int seg) const {
    if (k < c_main) {
      const float v = load_act(x, m * c_main + k, x_bf16);
      if (!aff_a) return v;
      const long long i = (long long)seg * c_main + k;
      return fmaf(aff_a[i], v, aff_b[i]);
    }
    return load_act(skip, m * c_skip + (k - c_main), skip_bf16);
  }
  // raw elements (m, k .. k + 3), k a multiple of 4 (gemm_tf32x3's loader):
  // one 16-byte load where the quad lies in 16-byte aligned fp32 rows of x
  // or of the skip, four read-only loads in fp32 skip rows of another
  // width (the tail backward's z1 over the 73-wide skip: 4.25 against 4.44
  // ms through load_act on the H100), else four load_act; loads only,
  // `finish` applies the affine once they are needed (a quad of the skip
  // taken from the two aligned vectors that hold it ran z1 1.3 ms slower:
  // picking its elements waits for the loads, one quad after another)
  __device__ __forceinline__ float4 quad(long long m, long long k, int) const {
    const auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    if (k + 3 < c_main && !x_bf16 && (c_main & 3) == 0 && al(x))
      return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(x) +
                                                   m * c_main + k));
    if (k >= c_main && !skip_bf16 && (c_skip & 3) == 0 && al(skip))
      return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(skip) +
                                                   m * c_skip + (k - c_main)));
    if (k >= c_main && !skip_bf16) {
      const float* q = static_cast<const float*>(skip) + m * c_skip + (k - c_main);
      return make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
    }
    float r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      r[i] = k + i < c_main ? load_act(x, m * c_main + k + i, x_bf16)
                            : load_act(skip, m * c_skip + (k + i - c_main), skip_bf16);
    return make_float4(r[0], r[1], r[2], r[3]);
  }
  // the affine on a quad's main channels
  __device__ __forceinline__ float4 finish(float4 v, long long k, int seg) const {
    if (!aff_a || k >= c_main) return v;
    float r[4] = {v.x, v.y, v.z, v.w};
    const long long i = (long long)seg * c_main + k;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k + e < c_main) r[e] = fmaf(__ldg(aff_a + i + e), r[e], __ldg(aff_b + i + e));
    return make_float4(r[0], r[1], r[2], r[3]);
  }
};

// x's rows (rows x c, fp32 or bf16) into fp32 rows of ld floats, ld a
// multiple of 4 (zeros past c): an A of 16-byte rows for gemm_tf32x3's
// loader, which reads a quad of a row of another width as four scalar
// loads.  A thread a quad.  `A` names the copy in a profile (the head's
// EncRows, grid_mlp's GmRows).
template <class A>
__global__ void pad_rows(const void* x, int x_bf16, int n_quads, int quads, int c,
                         float4* __restrict__ xp) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_quads) return;
  const int r = i / quads, k = (i - r * quads) * 4;
  const long long o = (long long)r * c + k;
  if (!x_bf16) {
    const float* p = static_cast<const float*>(x) + o;
    xp[i] = make_float4(__ldg(p), k + 1 < c ? __ldg(p + 1) : 0.f, k + 2 < c ? __ldg(p + 2) : 0.f,
                        k + 3 < c ? __ldg(p + 3) : 0.f);
    return;
  }
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = k + e < c ? load_act(x, o + e, 1) : 0.f;
  xp[i] = make_float4(v[0], v[1], v[2], v[3]);
}

template <class A>
int pad_rows_launch(const void* x, int x_bf16, long long rows, int c, int ld, float* xp,
                    cudaStream_t st) {
  const long long n = rows * (ld / 4);
  if (rows < 1 || c < 1 || ld < c || ld % 4 || n > INT_MAX || (uintptr_t)xp % 16)
    return (int)cudaErrorInvalidValue;
  pad_rows<A><<<(unsigned)((n + 255) / 256), 256, 0, st>>>(x, x_bf16, (int)n, ld / 4, c,
                                                           reinterpret_cast<float4*>(xp));
  return (int)cudaGetLastError();
}

// The first GEMM's epilogue on the split-precision core (TcTile): h =
// gelu(acc + b1), fp32 rows of `hidden` (a fragment's column pair as one
// 8-byte store where `hidden` is even)
struct HiddenGelu {
  float* h;
  const float* b1;
  int hidden;
  template <int NV>
  __device__ __forceinline__ void operator()(const float (&acc)[NV], const TcTile& t) const {
    float bias[NV / 2];  // the thread's columns: col(4 q + e)
#pragma unroll
    for (int u = 0; u < NV / 2; ++u) {
      const int n = t.n0 + t.col(4 * (u / 2) + u % 2);
      bias[u] = n < hidden ? __ldg(b1 + n) : 0.f;
    }
#pragma unroll
    for (int v = 0; v < NV; v += 2) {
      const long long m = t.m0 + t.row(v);
      const int n = t.n0 + t.col(v), u = 2 * (v / 4);
      if (m >= t.m_end || n >= hidden) continue;
      float* p = h + m * hidden + n;
      const float g0 = gelu_rational(acc[v] + bias[u]);
      const float g1 = gelu_rational(acc[v + 1] + bias[u + 1]);
      if (hidden % 2 == 0) {
        *reinterpret_cast<float2*>(p) = make_float2(g0, g1);
      } else {
        p[0] = g0;
        if (n + 1 < hidden) p[1] = g1;
      }
    }
  }
};

// y0, y1 into elements (i, i + 1) of a row-major fp32 or bf16 array
// (8-byte aligned), i even where `vec`; the second only with `two`.  One
// 8-byte (fp32) or 4-byte (bf16) store where `vec`.
__device__ __forceinline__ void store_pair(void* p, long long i, float y0, float y1, int bf16,
                                           bool two, bool vec) {
  if (two && vec) {
    if (bf16) reinterpret_cast<__nv_bfloat162*>(p)[i / 2] = __floats2bfloat162_rn(y0, y1);
    else reinterpret_cast<float2*>(p)[i / 2] = make_float2(y0, y1);
  } else if (bf16) {
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p) + i;
    o[0] = __float2bfloat16_rn(y0);
    if (two) o[1] = __float2bfloat16_rn(y1);
  } else {
    float* o = static_cast<float*>(p) + i;
    o[0] = y0;
    if (two) o[1] = y1;
  }
}

// The second GEMM's addend: y = acc + b2[col] or acc + T[row][col], at
// most one of them (null: none).  T is pe, its rows repeating every
// t_rows rows, or the residual (t_rows: every row), fp32 or bf16 as
// stored; a call with more than one of b2, pe and the residual adds them
// into one fp32 table first (grid_mlp.py).  `table` gives the addend at
// each element of the thread's fragment: b2 once a column (the tail's),
// or T with every load issued before the epilogue's first store of y
// (loaded between those stores, each waited for memory in turn: the
// head's GEMM 2 took 4.04 ms against 2.80 on the H100).  (b2 read at the
// store and T's pairs loaded through load_pair's dtype switch took the
// head's GEMM 2 from 2.47 to 2.96 ms; each of b2, pe and the residual
// loaded ahead, the epilogue spilled.)
struct OutAdd {
  const float* b2;
  const void* t;
  long long t_rows;
  int c_out, t_bf16;
  template <int NV>
  __device__ __forceinline__ void table(float (&a)[NV], const TcTile& tt) const {
    if (b2) {
#pragma unroll
      for (int u = 0; u < NV / 2; ++u) {  // column col(v) of rows row(v) and row(v + 2)
        const int v = 4 * (u / 2) + u % 2, n = tt.n0 + tt.col(v);
        a[v] = a[v + 2] = n < c_out ? __ldg(b2 + n) : 0.f;
      }
      return;
    }
#pragma unroll
    for (int v = 0; v < NV; v += 2) {
      const long long m = tt.m0 + tt.row(v);
      const int n = tt.n0 + tt.col(v);
      a[v] = a[v + 1] = 0.f;
      if (!t || m >= tt.m_end || n >= c_out) continue;
      const long long i = (m % t_rows) * c_out + n;
      if (!t_bf16 && n + 1 < c_out && c_out % 2 == 0) {
        const float2 q = __ldg(reinterpret_cast<const float2*>(static_cast<const float*>(t) + i));
        a[v] = q.x;
        a[v + 1] = q.y;
      } else {
        a[v] = load_act(t, i, t_bf16);
        if (n + 1 < c_out) a[v + 1] = load_act(t, i + 1, t_bf16);
      }
    }
  }
};

// The second GEMM's epilogue without statistics: y = acc + OutAdd's
// table, rows of c_out in the output dtype (a fragment's column pair as
// one store where c_out is even)
struct OutStore {
  OutAdd add;
  void* out;
  int c_out, out_bf16;
  template <int NV>
  __device__ __forceinline__ void operator()(const float (&acc)[NV], const TcTile& t) const {
    float a[NV];
    add.table(a, t);
#pragma unroll
    for (int v = 0; v < NV; v += 2) {
      const long long m = t.m0 + t.row(v);
      const int n = t.n0 + t.col(v);
      if (m >= t.m_end || n >= c_out) continue;
      store_pair(out, m * c_out + n, acc[v] + a[v], acc[v + 1] + a[v + 1], out_bf16,
                 n + 1 < c_out, c_out % 2 == 0);
    }
  }
};

// The second GEMM's epilogue with statistics: y as OutStore writes it, in
// fp32, and the tile's column sums of y and y^2 into part_sum / part_sq
// (samples, tiles, c_out): each thread sums its two rows, the warp's 8 row
// groups add by a fixed butterfly of shuffles, then the 8 warps (16 rows
// each) in order through TcTile::smem.  No atomics: deterministic.
struct OutStats {
  OutAdd add;
  float* out;
  float* part_sum;
  float* part_sq;
  int c_out, tiles;
  template <int NV>
  __device__ __forceinline__ void operator()(const float (&acc)[NV], const TcTile& t) const {
    constexpr int BN = 2 * NV;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float* sh_s = t.smem;  // (8 warps, BN)
    float* sh_q = t.smem + 8 * BN;
    float a[NV];
    add.table(a, t);
    t.sync();  // the block's last tile has read sh_s and sh_q
    float sums[NV];  // of column col(4 (u / 2) + u % 2): y at u < NV / 2, y^2 at NV / 2 + u
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
      const int n = t.n0 + t.col(4 * q);  // the pair's first column
      float* s = sums + 2 * q;
      float* sq = sums + NV / 2 + 2 * q;
      s[0] = s[1] = sq[0] = sq[1] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 4 * q + 2 * h;
        const long long m = t.m0 + t.row(v);
        if (m >= t.m_end || n >= c_out) continue;
        const float y0 = acc[v] + a[v], y1 = acc[v + 1] + a[v + 1];
        const bool two = n + 1 < c_out;
        float* o = out + m * c_out + n;
        if (two && c_out % 2 == 0) {
          *reinterpret_cast<float2*>(o) = make_float2(y0, y1);
        } else {
          o[0] = y0;
          if (two) o[1] = y1;
        }
        s[0] += y0;
        sq[0] = fmaf(y0, y0, sq[0]);
        if (two) {
          s[1] += y1;
          sq[1] = fmaf(y1, y1, sq[1]);
        }
      }
    }
    // over the warp's 8 row groups (lane bits 2-4): at each step a lane
    // keeps one half of its sums, adds the partner's, and sends the other
    // half, so a lane ends with NV / 8 of the warp's column sums (NV - NV / 8
    // shuffles, not 3 NV)
    static_assert(NV % 8 == 0, "three halvings of the thread's sums");
    float h1[NV / 2], h2[NV / 4], h3[NV / 8];
    const bool up16 = lane & 16, up8 = lane & 8, up4 = lane & 4;
#pragma unroll
    for (int i = 0; i < NV / 2; ++i)
      h1[i] = (up16 ? sums[NV / 2 + i] : sums[i]) +
              __shfl_xor_sync(0xffffffffu, up16 ? sums[i] : sums[NV / 2 + i], 16);
#pragma unroll
    for (int i = 0; i < NV / 4; ++i)
      h2[i] = (up8 ? h1[NV / 4 + i] : h1[i]) +
              __shfl_xor_sync(0xffffffffu, up8 ? h1[i] : h1[NV / 4 + i], 8);
#pragma unroll
    for (int i = 0; i < NV / 8; ++i)
      h3[i] = (up4 ? h2[NV / 8 + i] : h2[i]) +
              __shfl_xor_sync(0xffffffffu, up4 ? h2[i] : h2[NV / 8 + i], 4);
    const int first = (up16 ? NV / 2 : 0) + (up8 ? NV / 4 : 0) + (up4 ? NV / 8 : 0);
#pragma unroll
    for (int j = 0; j < NV / 8; ++j) {
      const int u = (first + j) % (NV / 2);
      (first + j < NV / 2 ? sh_s : sh_q)[warp * BN + t.col(4 * (u / 2) + u % 2)] = h3[j];
    }
    t.sync();
    const int col = threadIdx.x;
    if (col < BN && t.n0 + col < c_out) {
      float ss = 0.f, qq = 0.f;
      for (int w = 0; w < TF3_CONSUMERS / 32; ++w) {
        ss += sh_s[w * BN + col];
        qq += sh_q[w * BN + col];
      }
      const long long i = ((long long)t.seg * tiles + t.tile) * c_out + t.n0 + col;
      part_sum[i] = ss;
      part_sq[i] = qq;
    }
  }
};

// The MLP's operands.  x, skip, pe, res: fp32 or bf16 (the *_bf16 flags);
// w1_x3 the hi and lo halves (2, hidden, k1_pad) of W1^T and w2_x3 those
// (2, c_out, hid_pad) of W2^T (tf32x3.py:kmajor_split: K-major rows
// zero-padded to multiples of 16 floats); h (samples * rps, hidden) fp32
// scratch; part_sum / part_sq (samples, tiles, c_out) and grp_sum / grp_sq
// (samples, groups, c_out) fp32 scratch, or null part_sum: no statistics;
// ssum / ssq (samples, c_out).
struct MlpF32 {
  const void* x;
  const void* skip;
  const float* aff_a;
  const float* aff_b;
  const float* w1_x3;
  const float* b1;
  const float* w2_x3;
  const float* b2;
  const void* pe;
  const void* res;
  void* out;
  float* h;
  float* part_sum;
  float* part_sq;
  float* grp_sum;
  float* grp_sq;
  float* ssum;
  float* ssq;
  long long rps, pe_rows, k1_pad, hid_pad;
  int samples, c_main, c_skip, hidden, c_out, groups;
  int x_bf16, skip_bf16, pe_bf16, res_bf16, out_bf16;
};

// The pointer and integer layout of an MlpF32 in the C entry points'
// arrays (ops/kernels/mlp_f32.py:mlp_args builds it); a head or tail
// entry point appends its own after them.
enum MlpPtr { MP_X, MP_SKIP, MP_AFF_A, MP_AFF_B, MP_W1_X3, MP_B1, MP_W2_X3, MP_B2, MP_PE,
              MP_RES, MP_OUT, MP_H, MP_PART_SUM, MP_PART_SQ, MP_GRP_SUM, MP_GRP_SQ, MP_SSUM,
              MP_SSQ, MLP_PTRS };
enum MlpInt { MI_SAMPLES, MI_RPS, MI_PE_ROWS, MI_C_MAIN, MI_C_SKIP, MI_HIDDEN, MI_C_OUT,
              MI_GROUPS, MI_X_BF16, MI_SKIP_BF16, MI_PE_BF16, MI_RES_BF16, MI_OUT_BF16,
              MI_K1_PAD, MI_HID_PAD, MLP_INTS };

inline MlpF32 mlp_f32_args(const void* const* p, const long long* v) {
  MlpF32 a;
  a.x = p[MP_X];
  a.skip = p[MP_SKIP];
  a.aff_a = (const float*)p[MP_AFF_A];
  a.aff_b = (const float*)p[MP_AFF_B];
  a.w1_x3 = (const float*)p[MP_W1_X3];
  a.b1 = (const float*)p[MP_B1];
  a.w2_x3 = (const float*)p[MP_W2_X3];
  a.b2 = (const float*)p[MP_B2];
  a.pe = p[MP_PE];
  a.res = p[MP_RES];
  a.out = (void*)p[MP_OUT];
  a.h = (float*)p[MP_H];
  a.part_sum = (float*)p[MP_PART_SUM];
  a.part_sq = (float*)p[MP_PART_SQ];
  a.grp_sum = (float*)p[MP_GRP_SUM];
  a.grp_sq = (float*)p[MP_GRP_SQ];
  a.ssum = (float*)p[MP_SSUM];
  a.ssq = (float*)p[MP_SSQ];
  a.samples = (int)v[MI_SAMPLES];
  a.rps = v[MI_RPS];
  a.pe_rows = v[MI_PE_ROWS] > 0 ? v[MI_PE_ROWS] : 1;
  a.c_main = (int)v[MI_C_MAIN];
  a.c_skip = (int)v[MI_C_SKIP];
  a.hidden = (int)v[MI_HIDDEN];
  a.c_out = (int)v[MI_C_OUT];
  a.groups = (int)v[MI_GROUPS];
  a.x_bf16 = (int)v[MI_X_BF16];
  a.skip_bf16 = (int)v[MI_SKIP_BF16];
  a.pe_bf16 = (int)v[MI_PE_BF16];
  a.res_bf16 = (int)v[MI_RES_BF16];
  a.out_bf16 = (int)v[MI_OUT_BF16];
  a.k1_pad = v[MI_K1_PAD];
  a.hid_pad = v[MI_HID_PAD];
  return a;
}

// The statistics' tile partials (per 128-row tile of a sample), added in
// runs of tiles, then the runs: a fixed order.  Returns a CUDA error code.
inline int mlp_stats_reduce(const MlpF32& a, cudaStream_t st) {
  const long long tiles = (a.rps + TF3_BM - 1) / TF3_BM;
  const int per = (int)((tiles + a.groups - 1) / max(a.groups, 1));
  if (a.groups < 1 || (long long)per * (a.groups - 1) >= tiles) return (int)cudaErrorInvalidValue;
  dim3 rgrid((a.c_out + 31) / 32, (unsigned)a.samples);
  tile_reduce<<<dim3(rgrid.x, rgrid.y, a.groups), dim3(32, 8), 0, st>>>(
      a.part_sum, a.part_sq, (int)tiles, per, a.c_out, a.grp_sum, a.grp_sq);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  stats_reduce<<<rgrid, dim3(32, 8), 0, st>>>(a.grp_sum, a.grp_sq, a.groups, a.c_out, a.ssum,
                                              a.ssq);
  return (int)cudaGetLastError();
}

#ifndef TAIL_OUT_BN_OVERRIDE
#define TAIL_OUT_BN_OVERRIDE 80
#endif
// the second GEMM's column tile: 80, 112 or 128 (one tile of the tail's 73)
constexpr int TAIL_OUT_BN = TAIL_OUT_BN_OVERRIDE;

// The MLP on the split-precision core (see the note at the top): the
// first GEMM's A the functor `in` over K = k (zeros in W1^T's pad past its
// rows, k <= k1_pad), the second's h read as HRows (F32Matrix<float>'s
// layout; a type of its own names a caller's launches in a profile); out
// on OUT_BN-column tiles, with STATS (part_sum given; no residual; fp32
// out) the statistics' partials and reduces; at most one of b2, pe and the
// residual (OutAdd).  Returns a CUDA error code.
// (A template: the sources that include this header without calling it
// build none of its kernels.)
template <int OUT_BN = TAIL_OUT_BN, bool STATS = false, class HRows = F32Matrix<float>,
          class ALoad>
int mlp_tf32x3_run(const ALoad& in, int k, const MlpF32& a, cudaStream_t st) {
  // one addend (OutAdd), T read in pairs of 8 bytes
  const auto al8 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  if (a.samples < 1 || a.rps < 1 || k < 1 || a.hidden < 1 || a.c_out < 1 || !a.w1_x3 || !a.b1 ||
      !a.w2_x3 || !a.out || !a.h || STATS != (a.part_sum != nullptr) ||
      (STATS && (a.res || a.out_bf16)) || a.k1_pad < k || a.hid_pad < a.hidden ||
      !!a.b2 + !!a.pe + !!a.res > 1 || !al8(a.pe) || !al8(a.res) || !al8(a.out))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)a.samples * a.rps;
  int err = gemm_tf32x3_run<128>(in, a.w1_x3, a.w1_x3 + a.hidden * a.k1_pad, a.k1_pad, rows,
                                 a.hidden, k, 1, a.rps, HiddenGelu{a.h, a.b1, a.hidden}, st);
  if (err) return err;
  HRows h;
  h.p = a.h;
  h.ld = a.hidden;
  const float* w2_lo = a.w2_x3 + a.c_out * a.hid_pad;
  const OutAdd add{a.b2, a.pe ? a.pe : a.res, a.pe ? a.pe_rows : rows, a.c_out,
                   a.pe ? a.pe_bf16 : a.res_bf16};
  if constexpr (STATS) {
    const OutStats out{add, (float*)a.out, a.part_sum, a.part_sq, a.c_out,
                       (int)((a.rps + TF3_BM - 1) / TF3_BM)};
    err = gemm_tf32x3_run<OUT_BN>(h, a.w2_x3, w2_lo, a.hid_pad, rows, a.c_out, a.hidden, 1,
                                  a.rps, out, st);
    return err ? err : mlp_stats_reduce(a, st);
  } else {
    return gemm_tf32x3_run<OUT_BN>(h, a.w2_x3, w2_lo, a.hid_pad, rows, a.c_out, a.hidden, 1,
                                   a.rps, OutStore{add, a.out, a.c_out, a.out_bf16}, st);
  }
}

}  // namespace
