// Fused inverse longitude DFT + norm/FiLM affine + big-skip decoder MLP,
// bf16 wgmma GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/spectral_decoder.py:spectral_decoder (the
// Pallas `_spectral_decoder_call` TPU kernel).  Per latitude row (b, h):
//
//   t = bf16(hm[b, h] * a[b])                 (2M, C): scaled Legendre synthesis
//   x = Mt @ t + b[b]                          (W, C) fp32 grid row, Mt (W, 2M) bf16
//   y = gelu_exact(bf16(x) @ W1a + bf16(skip) @ W1b + b1) @ W2 [+ b2]
//   out = round(y, out dtype)
//
// with the GELU output rounded to bf16 before the second GEMM.  The grid-
// space field of the last block (721 x 1440 x 256) never reaches device
// memory.
//
// Bound on the H100 at the serving shapes: hm (1, 721, 242, 256) fp32 179
// MB + skip (1, 721, 1440, 73) fp32 303 MB + out (1, 721, 1440, 73) fp32
// 303 MB ~0.79 GB -> 0.23 ms; the least work folds the inverse DFT (half
// the dense product's operations; this kernel runs it dense): 2 *
// 1,038,240 * (329*256 + 256*73) + 1,038,240 * 242*256 = 2.78e11 FLOP ->
// 0.28 ms at 989 TFLOP/s bf16: operations.
//
// Design: a small first kernel writes t = bf16(hm * a) once, (B, H, m2p, C)
// with zero rows past 2M (94.5 MB at the serving shapes; folding a into Mt
// would move the rounding point).  The main kernel (persistent,
// chain_gemm.cuh) runs three chained wgmma GEMMs per tile of 128 longitudes
// of one latitude row (1440 = 11 * 128 + 32: TMA zero-fills the last
// tile's loads and its stores are masked), so each row's t is read by 12
// tiles:
//   (1) x = Mt[tile] @ t_row: Mt's tile (128 x m2p, K-major) comes by TMA
//       into K-chunks 0-3 of the A tile as soon as the previous tile's
//       GEMMs are done with them; t_row (m2p x C, MN-major boxes of 64 x
//       64) streams through the ring; the epilogue adds b and writes bf16 x
//       over Mt;
//   (2) h = [x | skip] @ W1 (K = C + 80): the tile's skip is one
//       contiguous run (128 x 73 x 4 B = 37 KB); each row half comes
//       through the ring as one bulk copy and is converted by its two
//       consumer warpgroups to bf16 columns [C, C + 80) of the A tile; the
//       epilogue adds b1, applies the exact GELU and writes bf16 h over x;
//   (3) y = h @ W2 + b2 (N = c_out <= 96, one m64n128 wgmma per K-step on
//       zero-filled columns); the fp32 tile goes through K-chunks 4-6 of
//       the A tile (rows of c_out, as in device memory, clear of the next
//       tile's Mt) and out as one contiguous run of coalesced 16-byte
//       stores.
// The ring carries t's boxes, the raw skip and the two weight matrices in
// one sequence of stages, so each arrives while the step before computes.
// L2 traffic per tile: Mt 64 KB + t 128 KB + W1 168 KB + W2 64 KB (8652
// tiles: ~3.7 GB per call).  The epilogues (the GELU of 32K values a
// tile, the skip conversion, the output) and the three GEMMs take turns
// within a block, and one block fills an SM (the A tile and the ring fill
// shared memory, the accumulators the registers): 1.41 ms on the H100
// (tools/kernel_variants.py --profile), 4.2x the operations bound.
//
// Tunables (tools/kernel_variants.py): DEC_STAGES (ring depth of 32 KB
// stages beside the 112 KB A tile; at most 3).
//
// fp32 operands (the "float32" and "tensorfloat" knobs): spectral_decoder_f32.
// The fp32 inverse DFT of dft_synthesis (dft_tiles.cuh:fold_rows, the
// even/odd fold, fp32 FMA on the CUDA cores) writes a * (Mt @ hm) + b (the
// affine in its epilogue: a per-channel scale commutes with the DFT, and
// where the plain version scales hm first the sums differ by rounding
// only; nothing is rounded to bf16 here) into the first C columns of the
// first GEMM's rows, fp32, lda = C + S rounded up to 4 floats (332); a
// small pass copies the skip into the next S and zeros the pad.  Then the
// decoder MLP of mlp_f32.cuh on the split-precision core (mlp_tf32x3_run:
// two gemm_tf32x3 launches, fp32-class products as three TF32 tensor-core
// passes over hi / lo splits, B the prepared halves of W1^T and W2^T)
// reads those rows by 16-byte loads.  (Read through mlp_f32.cuh's MlpInput
// instead, the affine and the 73-wide skip in the GEMM's loader, the first
// GEMM took 4.25 ms on the H100; the skip's copy and this GEMM take 0.37
// and 2.69, the fold 0.09 more.)  Bound on
// the H100: 2.78e11 FLOP (the DFT folded) at 165 TFLOP/s (an fp32-class
// product's least time on this card), 1.69 ms; the rows' round trip (2 x
// 1.38 GB) and h's (2 x 1.06 GB) are ~0.8 and ~0.64 ms at the HBM rate.

#include "chain_gemm.cuh"
#include "dft_tiles.cuh"
#include "mlp_f32.cuh"

namespace {

#ifndef DEC_STAGES_OVERRIDE
#define DEC_STAGES_OVERRIDE 3
#endif
constexpr int DEC_STAGES = DEC_STAGES_OVERRIDE;
constexpr int DEC_SLOT = 4 * CH_BOX;            // 32 KB: the B boxes of N <= 256
// 112 KB: Mt, then [x | skip] (K <= 384), then h; the fp32 output tile in
// K-chunks 4-6 (c_out <= 96)
constexpr int DEC_TILE = 7 * CH_CHUNK;
constexpr int DEC_BIAS = 3 * 256;                // b, b1, b2 in shared memory (floats)
constexpr int DEC_SMEM = 1024 + DEC_TILE + DEC_STAGES * DEC_SLOT + DEC_BIAS * 4 +
                         (2 * DEC_STAGES + 2) * 8;
static_assert(DEC_SMEM <= 232448, "the tail does not fit in shared memory");

struct DecArgs {
  const void* hm;         // (B, H, two_m, c)
  __nv_bfloat16* t;       // (B, H, m2p, c) scratch: bf16(hm * a), zero rows past two_m
  const float* aff_a;     // (B, c)
  const float* aff_b;     // (B, c)
  const void* skip;       // (B, H, W, s)
  const float* b1;        // (hidden,)
  const float* b2;        // (c_out,) or null
  void* out;              // (B, H, W, c_out)
  int H, W, tiles, rows, two_m, m2p, c, s, k1p, hidden, c_out, n2p;
  int hm_bf16, out_bf16;
};

// t = bf16(hm * a) per (sample, channel), rows [two_m, m2p) zero: 8
// channels per thread, one 16-byte store
__global__ void scale_to_bf16(DecArgs a, long long n_vec) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  const long long e0 = v * 8;
  const int col = (int)(e0 % a.c);
  const long long row = e0 / a.c;  // (b * H + h) * m2p + m
  const int m = (int)(row % a.m2p);
  const long long bh = row / a.m2p;
  const float* sa = a.aff_a + (bh / a.H) * a.c + col;
  __align__(16) __nv_bfloat16 out[8];
  const long long src = (bh * a.two_m + m) * a.c + col;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    out[e] = __float2bfloat16_rn(m < a.two_m ? load_act(a.hm, src + e, a.hm_bf16) * sa[e] : 0.f);
  *reinterpret_cast<uint4*>(a.t + e0) = *reinterpret_cast<const uint4*>(out);
}

template <typename IN_T>
CH_KERNEL
    spectral_decoder_tiles(const __grid_constant__ CUtensorMap mt_map,
                           const __grid_constant__ CUtensorMap t_map,
                           const __grid_constant__ CUtensorMap w1_map,
                           const __grid_constant__ CUtensorMap w2_map, DecArgs a) {
  extern __shared__ char smem_raw[];
  char* tile = smem_base_1024(smem_raw);
  float* bias = reinterpret_cast<float*>(tile + DEC_TILE + DEC_STAGES * DEC_SLOT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(bias + DEC_BIAS);
  const Ring ring{tile + DEC_TILE, bars, bars + DEC_STAGES, DEC_SLOT, DEC_STAGES};
  uint64_t* mt_full = bars + 2 * DEC_STAGES;  // a tile's Mt has landed in the A tile
  uint64_t* mt_free = mt_full + 1;            // every consumer warp is done with its h
  const int n1 = (a.m2p + CH_BK - 1) / CH_BK, n2 = (a.k1p + CH_BK - 1) / CH_BK;
  const int n3 = (a.hidden + CH_BK - 1) / CH_BK;
  const long long n_tiles = (long long)a.rows * a.tiles;
  if (threadIdx.x == 0) {
    ring_init(ring);
    mbar_init(mt_full, 1);
    mbar_init(mt_free, CH_CONSUMERS / 32);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CH_CONSUMERS) {  // the producer warpgroup: one warp works
    producer_regs();
    if (threadIdx.x >= CH_CONSUMERS + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_map(&mt_map);
      prefetch_map(&t_map);
      prefetch_map(&w1_map);
      prefetch_map(&w2_map);
    }
    // per tile: Mt's 128 x m2p tile into the A tile (once the last tile's
    // GEMMs are done with it), then ring stages: t's, the raw skip of the
    // two row halves, W1's, W2's
    int s = 0, it = 0;
    for (long long tl = blockIdx.x; tl < n_tiles; tl += gridDim.x, ++it) {
      const long long bh = tl / a.tiles;  // b * H + h
      const int w0 = (int)(tl % a.tiles) * CH_BM;
      const int n_valid = min(CH_BM, a.W - w0);
      const IN_T* ssrc = reinterpret_cast<const IN_T*>(a.skip) + (bh * a.W + w0) * a.s;
      if (it > 0) mbar_wait(mt_free, (it - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(mt_full, n1 * CH_CHUNK);
        for (int j = 0; j < n1; ++j)
          tma_load_2d(tile + j * CH_CHUNK, &mt_map, mt_full, CH_BK * j, w0);
      }
      for (int j = 0; j < n1 + 2 + n2 + n3; ++j, ++s) {
        char* sb = ring_acquire(ring, s);
        if (lane == 0) {
          uint64_t* full = ring.full + s % ring.stages;
          if (j < n1) {
            load_b_boxes(sb, &t_map, full, a.c, CH_BK * j, (int)bh);
          } else if (j < n1 + 2) {
            const int half = j - n1;
            load_raw(ring, s, sb, ssrc + 64 * half * a.s, min(64, n_valid - 64 * half),
                     a.s * (int)sizeof(IN_T));
          } else if (j < n1 + 2 + n2) {
            load_b_boxes(sb, &w1_map, full, a.hidden, CH_BK * (j - n1 - 2), -1);
          } else {
            load_b_boxes(sb, &w2_map, full, a.n2p, CH_BK * (j - n1 - 2 - n2), -1);
          }
        }
        __syncwarp();
      }
    }
    return;
  }

  // consumers: warpgroup (m, n) owns tile rows [64 m, 64 m + 64) and columns
  // [128 n, 128 n + 128)
  consumer_regs();
  const Role ro;
  if (threadIdx.x < 256) {  // b1 and b2 in shared memory; b per sample below
    bias[256 + threadIdx.x] = threadIdx.x < a.hidden ? a.b1[threadIdx.x] : 0.f;
    bias[512 + threadIdx.x] = threadIdx.x < a.c_out && a.b2 ? a.b2[threadIdx.x] : 0.f;
  }
  auto a_tile = [&](int j, char*) { return tile + j * CH_CHUNK; };
  auto add_b = [bias](float v, int col) { return v + bias[col]; };
  const float* b1 = bias + 256;
  auto gelu_b1 = [b1](float v, int col) { return gelu_rational(v + b1[col]); };
  const bool x_cols = 128 * ro.n < a.c, h_cols = 128 * ro.n < a.hidden;
  // the output tile goes through K-chunks 4-6, clear of the next tile's Mt
  float* ys = reinterpret_cast<float*>(tile + 4 * CH_CHUNK) + 64 * ro.m * a.c_out;
  float acc[64];
  int s = 0, it = 0;
  long long b_cur = -1;
  for (long long tl = blockIdx.x; tl < n_tiles; tl += gridDim.x, ++it) {
    const long long bh = tl / a.tiles;
    const int w0 = (int)(tl % a.tiles) * CH_BM;
    const int n_valid = min(CH_BM, a.W - w0);
    const IN_T* ssrc = reinterpret_cast<const IN_T*>(a.skip) + (bh * a.W + w0) * a.s;
    if (bh / a.H != b_cur) {  // this sample's b
      b_cur = bh / a.H;
      if (threadIdx.x < 256)
        bias[threadIdx.x] = threadIdx.x < a.c ? a.aff_b[b_cur * a.c + threadIdx.x] : 0.f;
    }
    consumers_sync();  // the biases; the last tile's output is out of the A tile
    // (1) x = Mt[tile] t_row; then, over the pair's rows of Mt, bf16(x + b)
    // into columns [0, c) and the bf16 skip into [c, c + s)
    mbar_wait(mt_full, it & 1);
    s = chain_gemm(acc, ring, s, a.m2p, a_tile, ro, x_cols);
    pair_sync(ro);  // the pair's wgmmas have read Mt
    if (x_cols) frag_to_a_tile(acc, tile, 64 * ro.m, 128 * ro.n, a.c, add_b);
    s = raw_to_a_tile<IN_T>(ring, s, ro, ssrc + 64 * ro.m * a.s, min(64, n_valid - 64 * ro.m),
                            a.s, tile, a.c);
    // finite A past k1p (the last tile's output went through these chunks)
    zero_cols(tile, 64 * ro.m, a.k1p, round_up(a.k1p, CH_BK), ro.n * 128 + ro.t, 256);
    fence_proxy_async();
    pair_sync(ro);

    // (2) h = bf16(gelu([x | skip] W1 + b1)) over x
    s = chain_gemm(acc, ring, s, a.k1p, a_tile, ro, h_cols);
    pair_sync(ro);  // the pair's wgmmas have read [x | skip]
    if (h_cols) frag_to_a_tile(acc, tile, 64 * ro.m, 128 * ro.n, a.hidden, gelu_b1);
    zero_cols(tile, 64 * ro.m, a.hidden, round_up(a.hidden, CH_BK), ro.n * 128 + ro.t, 256);
    fence_proxy_async();
    pair_sync(ro);

    // (3) y = h W2 + b2 (N = n2p <= 128: the n = 0 warpgroups), through
    // shared memory (rows of c_out fp32) to out
    s = chain_gemm(acc, ring, s, a.hidden, a_tile, ro, ro.n == 0);
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive(mt_free);  // the next tile's Mt may come
    consumers_sync();  // every warpgroup is done reading [x | skip] and h
    if (ro.n == 0) {
      const int r0 = acc_row0();
#pragma unroll
      for (int q = 0; q < 16; ++q) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = acc_col(q, e);
          if (col >= a.c_out) continue;
          const float b2 = bias[512 + col];
          ys[r0 * a.c_out + col] = acc[4 * q + e] + b2;
          ys[(r0 + 8) * a.c_out + col] = acc[4 * q + 2 + e] + b2;
        }
      }
    }
    pair_sync(ro);
    const int rows = min(64, n_valid - 64 * ro.m), t = ro.n * 128 + ro.t;
    if (rows > 0) {
      const int n = rows * a.c_out;
      const long long o = (bh * a.W + w0 + 64 * ro.m) * a.c_out;
      if (a.out_bf16) {
        __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(a.out) + o;
        for (int i = t; i < n; i += 256) dst[i] = __float2bfloat16_rn(ys[i]);
      } else {
        float* dst = reinterpret_cast<float*>(a.out) + o;
        if (reinterpret_cast<uintptr_t>(dst) % 16 == 0) {
          for (int i = t; i < n / 4; i += 256)
            reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(ys)[i];
          for (int i = n / 4 * 4 + t; i < n; i += 256) dst[i] = ys[i];
        } else {
          for (int i = t; i < n; i += 256) dst[i] = ys[i];
        }
      }
    }
  }
}

template <typename IN_T>
int launch_tiles(const CUtensorMap* maps, const DecArgs& a, long long blocks,
                 cudaStream_t stream) {
  static bool smem_set = false;  // once per kernel
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        spectral_decoder_tiles<IN_T>, cudaFuncAttributeMaxDynamicSharedMemorySize, DEC_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  spectral_decoder_tiles<IN_T><<<(unsigned)blocks, CH_THREADS, DEC_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

enum Ptr { P_HM, P_A, P_B, P_MT, P_SKIP, P_W1, P_B1, P_W2, P_B2, P_OUT, P_T, N_PTRS };
enum Int { I_B, I_H, I_W, I_TWO_M, I_M2P, I_W_PAD, I_C, I_S, I_CMP, I_K1P, I_HIDDEN,
           I_C_OUT, I_N2P, I_HM_BF16, I_SKIP_BF16, I_OUT_BF16, I_HAS_B2, N_INTS };

}  // namespace

// Rows of the Mt operand must be padded to a multiple of this (zero rows).
extern "C" int spectral_decoder_chunk() { return CH_BK; }

// The tiles that shape the fp32 path's fold operand (0: FOLD_K, 1:
// FOLD_TILE, 2: BF16_K, 3: BF16_TILE), as dft_synthesis_tile.
extern "C" int spectral_decoder_tile(int i) { return dft_tile(i); }

// ptrs and ints follow the Ptr and Int enums above.
extern "C" int spectral_decoder_bf16(const void* const* ptrs, const long long* ints,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  DecArgs a;
  a.hm = ptrs[P_HM];
  a.aff_a = (const float*)ptrs[P_A];
  a.aff_b = (const float*)ptrs[P_B];
  a.skip = ptrs[P_SKIP];
  a.b1 = (const float*)ptrs[P_B1];
  a.b2 = ints[I_HAS_B2] ? (const float*)ptrs[P_B2] : nullptr;
  a.out = (void*)ptrs[P_OUT];
  a.t = (__nv_bfloat16*)ptrs[P_T];
  const int b = (int)ints[I_B];
  a.H = (int)ints[I_H];
  a.W = (int)ints[I_W];
  a.two_m = (int)ints[I_TWO_M];
  a.m2p = (int)ints[I_M2P];
  const long long w_pad = ints[I_W_PAD];
  a.c = (int)ints[I_C];
  a.s = (int)ints[I_S];
  const int cmp = (int)ints[I_CMP];
  a.k1p = (int)ints[I_K1P];
  a.hidden = (int)ints[I_HIDDEN];
  a.c_out = (int)ints[I_C_OUT];
  a.n2p = (int)ints[I_N2P];
  a.hm_bf16 = (int)ints[I_HM_BF16];
  a.out_bf16 = (int)ints[I_OUT_BF16];
  const int skip_bf16 = (int)ints[I_SKIP_BF16];
  if (b < 1 || a.H < 1 || a.W < 1 || w_pad % CH_BK || w_pad < a.W || a.two_m < 1 ||
      a.m2p < a.two_m || a.m2p % 16 || a.c < 16 || a.c % 16 || a.c > 256 || cmp != a.c ||
      a.s < 1 || a.k1p < a.c + a.s || a.k1p % 16 || a.k1p > DEC_TILE / CH_CHUNK * CH_BK ||
      a.m2p > 4 * CH_BK || a.hidden < 16 || a.hidden % 16 || a.hidden > 256 || a.c_out < 1 ||
      a.n2p < a.c_out ||
      a.n2p % 16 || a.n2p > 96)
    return (int)cudaErrorInvalidValue;
  a.tiles = (a.W + CH_BM - 1) / CH_BM;
  a.rows = b * a.H;
  // persistent: one block per SM walks the tiles
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = min((long long)a.rows * a.tiles, (long long)max(sms, 1));
  CUtensorMap maps[4];
  int err = bf16_map(&maps[0], ptrs[P_MT], (int)w_pad, a.m2p, a.m2p, CH_BM, CH_BK);
  if (!err) err = bf16_map(&maps[1], a.t, a.m2p, a.c, a.c, CH_BK, 64, (long long)b * a.H);
  if (!err) err = bf16_map(&maps[2], ptrs[P_W1], a.k1p, a.hidden, a.hidden, CH_BK, 64);
  if (!err) err = bf16_map(&maps[3], ptrs[P_W2], a.hidden, a.n2p, a.n2p, CH_BK, 64);
  if (err) return err;
  const long long n_vec = (long long)b * a.H * a.m2p * a.c / 8;
  scale_to_bf16<<<(unsigned)((n_vec + 255) / 256), 256, 0, st>>>(a, n_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return skip_bf16 ? launch_tiles<__nv_bfloat16>(maps, a, blocks, st)
                   : launch_tiles<float>(maps, a, blocks, st);
}

namespace {

// The fp32 tail's skip (rows, s), fp32 or bf16, into columns [c, lda) of
// the first GEMM's rows (rows, lda) fp32, zeros past c + s
__global__ void skip_into_rows(const void* skip, int skip_bf16, long long rows, int c, int s,
                               int lda, float* __restrict__ xa) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int cols = lda - c;
  if (i >= rows * cols) return;
  const long long r = i / cols;
  const int j = (int)(i % cols);
  xa[r * lda + c + j] = j < s ? load_act(skip, r * s + j, skip_bf16) : 0.f;
}

}  // namespace

// The fp32-operand tail.  ptrs and ints begin with the decoder MLP's
// MlpPtr / MlpInt layouts (mlp_f32.cuh: x is the (B*H*W, lda) fp32
// scratch of the first GEMM's rows [a x + b | skip | 0], aff_a / aff_b are
// a and b, the skip its second input); then ptrs: the fp32 fold operand
// of dft_synthesis.prepare (at_rows, at_cols), hm (B, H, 2M, c); ints: B,
// H, W, the modes M, at_rows, at_cols, hm_bf16, lda (a multiple of 4, at
// least c + s).
extern "C" int spectral_decoder_f32(const void* const* ptrs, const long long* ints,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const MlpF32 mlp = mlp_f32_args(ptrs, ints);
  const long long* v = ints + MLP_INTS;
  const long long bsz = v[0], h = v[1], w = v[2], lda = v[7];
  const int m = (int)v[3], at_rows = (int)v[4], at_cols = (int)v[5];
  const int c = mlp.c_main, s = mlp.c_skip;
  if (bsz < 1 || h < 1 || w < 2 || m < 1 || mlp.x_bf16 || mlp.samples != bsz ||
      mlp.rps != h * w || !mlp.aff_a || !mlp.aff_b || s < 1 || !mlp.skip || lda < c + s ||
      lda % 4 || lda > INT_MAX || mlp.pe || mlp.res || mlp.part_sum)
    return (int)cudaErrorInvalidValue;
  const void* at = ptrs[MLP_PTRS];
  const void* hm = ptrs[MLP_PTRS + 1];
  float* xa = (float*)mlp.x;
  // 1. a (Mt @ hm) + b into columns [0, c) of the rows: the fold DFT with
  //    the affine in its epilogue
  int err = v[6] ? fold_launch<false, __nv_bfloat16, float, true>(
                       at, hm, xa, bsz * h, (int)w, m, c, at_rows, at_cols, st, lda, mlp.aff_a,
                       mlp.aff_b, h)
                 : fold_launch<false, float, float, true>(
                       at, hm, xa, bsz * h, (int)w, m, c, at_rows, at_cols, st, lda, mlp.aff_a,
                       mlp.aff_b, h);
  if (err) return err;
  // 2. the skip into columns [c, lda)
  const long long rows = bsz * h * w, n = rows * (lda - c);
  skip_into_rows<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(mlp.skip, mlp.skip_bf16, rows, c,
                                                                s, (int)lda, xa);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // 3. the MLP: 16-byte rows of K = lda against W1^T's zero-padded rows
  return mlp_tf32x3_run(F32Matrix<float>{xa, lda}, (int)lda, mlp, st);
}
