// The pointwise two-layer MLP on fp32 operands, shared by grid_mlp.cu, the
// head (grid_encoder_spectral.cu) and the tail (spectral_decoder.cu).  Per
// pixel row:
//
//   u = A_s * x + B_s                  (optional per-sample channel affine)
//   h = gelu_exact(u @ W1a [+ skip @ W1b] + b1)
//   y = h @ W2 [+ b2] [+ pe[row % pe_rows]] [+ res]
//   out = round(y, out dtype);  optionally per-sample sum(y), sum(y*y)
//
// in true fp32 FMA on the CUDA cores (no TF32, no rounding of any operand:
// the JAX kernels' "float32" and "tensorfloat" knobs).  x, the skip, pe and
// the residual are read as stored, fp32 or bf16.
//
// Bound on the H100: operations at 67 TFLOP/s, e.g. the encoder site
// (1,038,240 rows, 73 -> 256 -> 256) 1.75e11 FLOP, 2.6 ms; its bytes (x,
// pe, y: 2.6 GB fp32) 0.8 ms.
//
// Design: two launches of row_gemm.cuh:gemm_f32 (128 x 128 tiles, 8 x 8 a
// thread), h through device memory.  The first GEMM's A functor
// (MlpInput) reads a row's x (the affine applied) and then its skip, as one
// K = c_main + c_skip row against the unpadded fp32 W1; its epilogue adds
// b1, applies the exact GELU (chain_gemm.cuh:gelu_rational) and writes fp32
// h (rows x hidden).  The second GEMM reads h and W2; its epilogue adds b2,
// pe and the residual, writes y in the output dtype and, with statistics,
// sums y and y^2 over the tile's rows (each thread its 8 rows, then the 16
// row groups in order through shared memory) into one partial per (sample,
// 128-row tile, column), which tile_reduce and stats_reduce
// (tile_common.cuh) add in a fixed order: deterministic.  The GEMMs' row
// segments are the samples, so no tile crosses a sample.  h's round trip
// costs 2 x rows x hidden x 4 bytes (the encoder site: 2.1 GB, ~0.6 ms at
// the HBM rate), against an operations bound several times larger; a
// tile-resident h (the bf16 kernels' chain) is a later redesign.

#pragma once

#include "chain_gemm.cuh"

namespace {

static_assert(F32_BM == 128, "the wrappers count statistics tiles of 128 rows (TILE_ROWS)");

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
  // or of the skip, else four scalar loads; loads only, `finish` applies
  // the affine once they are needed
  __device__ __forceinline__ float4 quad(long long m, long long k, int) const {
    const auto al = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    if (k + 3 < c_main && !x_bf16 && (c_main & 3) == 0 && al(x))
      return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(x) +
                                                   m * c_main + k));
    if (k >= c_main && !skip_bf16 && (c_skip & 3) == 0 && al(skip))
      return __ldg(reinterpret_cast<const float4*>(static_cast<const float*>(skip) +
                                                   m * c_skip + (k - c_main)));
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

// the first GEMM's epilogue: h = gelu(acc + b1), fp32 rows of `hidden`
struct MlpHidden {
  float* h;
  const float* b1;
  int hidden;
  __device__ __forceinline__ void operator()(const float (&acc)[8][8], const F32Tile& t) const {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = t.m0 + t.row(i);
      if (m >= t.m_end) continue;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int n = t.n0 + t.col(4 * q);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[j] = n + j < hidden ? gelu_rational(acc[i][4 * q + j] + b1[n + j]) : 0.f;
        float* p = h + m * hidden + n;
        if (hidden % 4 == 0 && n < hidden) {
          *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < hidden) p[j] = v[j];
        }
      }
    }
  }
};

// the second GEMM's epilogue: y = acc + b2 + pe + res, out in fp32 or bf16,
// and the tile's column sums of y and y^2 into part_sum / part_sq
// (samples, tiles, c_out) when they are given
struct MlpOut {
  const float* b2;
  const void* pe;
  const void* res;
  void* out;
  float* part_sum;
  float* part_sq;
  long long pe_rows;
  int c_out, tiles, pe_bf16, res_bf16, out_bf16;
  __device__ __forceinline__ void operator()(const float (&acc)[8][8], const F32Tile& t) const {
    float s[8], q[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j] = q[j] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = t.m0 + t.row(i);
      if (m >= t.m_end) continue;
      const long long pe_row = pe ? m % pe_rows : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = t.n0 + t.col(j);
        if (n >= c_out) continue;
        float y = acc[i][j];
        if (b2) y += b2[n];
        if (pe) y += load_act(pe, pe_row * c_out + n, pe_bf16);
        if (res) y += load_act(res, m * c_out + n, res_bf16);
        if (out_bf16) reinterpret_cast<__nv_bfloat16*>(out)[m * c_out + n] = __float2bfloat16_rn(y);
        else reinterpret_cast<float*>(out)[m * c_out + n] = y;
        s[j] += y;
        q[j] = fmaf(y, y, q[j]);
      }
    }
    if (!part_sum) return;
    __shared__ float sh_s[16][F32_BN];
    __shared__ float sh_q[16][F32_BN];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sh_s[t.ty][t.col(j)] = s[j];
      sh_q[t.ty][t.col(j)] = q[j];
    }
    __syncthreads();
    const int c = threadIdx.x;
    if (c < F32_BN && t.n0 + c < c_out) {
      float ss = 0.f, qq = 0.f;
      for (int r = 0; r < 16; ++r) {
        ss += sh_s[r][c];
        qq += sh_q[r][c];
      }
      const long long i = ((long long)t.seg * tiles + t.tile) * c_out + t.n0 + c;
      part_sum[i] = ss;
      part_sq[i] = qq;
    }
  }
};

// The MLP's operands.  x, skip, pe, res: fp32 or bf16 (the *_bf16 flags);
// w1 (c_main + c_skip, hidden) and w2 (hidden, c_out) fp32 row-major; h
// (samples * rps, hidden) fp32 scratch; part_sum / part_sq (samples, tiles,
// c_out) and grp_sum / grp_sq (samples, groups, c_out) fp32 scratch, or
// null part_sum: no statistics; ssum / ssq (samples, c_out).
struct MlpF32 {
  const void* x;
  const void* skip;
  const float* aff_a;
  const float* aff_b;
  const float* w1;
  const float* b1;
  const float* w2;
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
  long long rps, pe_rows;
  int samples, c_main, c_skip, hidden, c_out, groups;
  int x_bf16, skip_bf16, pe_bf16, res_bf16, out_bf16;
};

// The pointer and integer layout of an MlpF32 in the C entry points'
// arrays (ops/kernels/mlp_f32.py:mlp_args builds it); a head or tail
// entry point appends its own after them.
enum MlpPtr { MP_X, MP_SKIP, MP_AFF_A, MP_AFF_B, MP_W1, MP_B1, MP_W2, MP_B2, MP_PE, MP_RES,
              MP_OUT, MP_H, MP_PART_SUM, MP_PART_SQ, MP_GRP_SUM, MP_GRP_SQ, MP_SSUM, MP_SSQ,
              MLP_PTRS };
enum MlpInt { MI_SAMPLES, MI_RPS, MI_PE_ROWS, MI_C_MAIN, MI_C_SKIP, MI_HIDDEN, MI_C_OUT,
              MI_GROUPS, MI_X_BF16, MI_SKIP_BF16, MI_PE_BF16, MI_RES_BF16, MI_OUT_BF16,
              MLP_INTS };

inline MlpF32 mlp_f32_args(const void* const* p, const long long* v) {
  MlpF32 a;
  a.x = p[MP_X];
  a.skip = p[MP_SKIP];
  a.aff_a = (const float*)p[MP_AFF_A];
  a.aff_b = (const float*)p[MP_AFF_B];
  a.w1 = (const float*)p[MP_W1];
  a.b1 = (const float*)p[MP_B1];
  a.w2 = (const float*)p[MP_W2];
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
  return a;
}

// The two GEMMs, then the statistics' reduces.  Returns a CUDA error code.
inline int mlp_f32_run(const MlpF32& a, cudaStream_t st) {
  if (a.samples < 1 || a.rps < 1 || a.c_main < 1 || a.c_skip < 0 || (a.c_skip > 0) != !!a.skip ||
      a.hidden < 1 || a.c_out < 1 || !a.x || !a.w1 || !a.b1 || !a.w2 || !a.out || !a.h ||
      (a.aff_a != nullptr) != (a.aff_b != nullptr))
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)a.samples * a.rps;
  const long long tiles = (a.rps + F32_BM - 1) / F32_BM;
  MlpInput in{a.x, a.skip, a.aff_a, a.aff_b, a.c_main, a.c_skip, a.x_bf16, a.skip_bf16};
  int err = gemm_f32_run<false, false>(in, a.w1, a.hidden, rows, a.hidden, a.c_main + a.c_skip,
                                       1, a.rps, MlpHidden{a.h, a.b1, a.hidden}, st);
  if (err) return err;
  MlpOut out{a.b2, a.pe, a.res, a.out, a.part_sum, a.part_sq, a.pe_rows, a.c_out, (int)tiles,
             a.pe_bf16, a.res_bf16, a.out_bf16};
  err = gemm_f32_run<false, false>(F32Matrix<false, float>{a.h, a.hidden}, a.w2, a.c_out, rows,
                                   a.c_out, a.hidden, 1, a.rps, out, st);
  if (err || !a.part_sum) return err;
  // the tiles' partials, added in runs, then the runs
  const int per = (int)((tiles + a.groups - 1) / max(a.groups, 1));
  if (a.groups < 1 || (long long)per * (a.groups - 1) >= tiles) return (int)cudaErrorInvalidValue;
  dim3 rgrid((a.c_out + 31) / 32, (unsigned)a.samples);
  tile_reduce<<<dim3(rgrid.x, rgrid.y, a.groups), dim3(32, 8), 0, st>>>(
      a.part_sum, a.part_sq, (int)tiles, per, a.c_out, a.grp_sum, a.grp_sq);
  if ((err = (int)cudaGetLastError())) return err;
  stats_reduce<<<rgrid, dim3(32, 8), 0, st>>>(a.grp_sum, a.grp_sq, a.groups, a.c_out, a.ssum,
                                              a.ssq);
  return (int)cudaGetLastError();
}

}  // namespace
