// Backward of the fused inverse longitude DFT + norm/FiLM affine + big-skip
// decoder MLP, bf16 wgmma GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/spectral_decoder.py:_spectral_decoder_bwd_call
// (the Pallas `_make_bwd_kernel` TPU kernel).  Per latitude row (b, h), with
// the row recomputed from the forward's inputs:
//
//   x_raw = Mt @ bf16(hm[b, h])               (W, C) fp32
//   xa = x_raw * a[b] + b[b];  z1 = bf16(xa) @ W1a + bf16(skip) @ W1b + b1
//   dz1 = (bf16(g) @ W2^T) * gelu'(z1)
//   dxa = bf16(dz1) @ W1a^T;   dskip = bf16(dz1) @ W1b^T
//   dhm[b, h] = a[b] * (Mt^T @ bf16(dxa))
//   da[b] = sum dxa * x_raw;  db[b] = sum dxa   (over the sample's pixels)
//   dW1 = [bf16(xa) | bf16(skip)]^T bf16(dz1);  db1 = sum dz1
//   dW2 = bf16(gelu(z1))^T bf16(g);            db2 = sum g
//
// at JAX's rounding points: da sums fp32 dxa against the fp32 x_raw.  GELU
// and its derivative use the forward kernels' branch-free rational erf
// (chain_gemm.cuh).
//
// Bound on the H100 at the serving shapes (g and skip (1, 721, 1440, 73)
// fp32, hm (1, 721, 242, 256) fp32), counting the least work, which folds
// both DFTs (half the dense products' operations; this kernel runs them
// dense).  Without the weight gradients, as the FiLM fine-tune step calls
// it: 2 * 1,038,240 * (2*329*256 + 256*73) + 2 * 1,038,240 * 242*256 =
// 5.17e11 FLOP -> 0.523 ms at 989 TFLOP/s bf16; with them (dW1, dW2 add 2 *
// 1,038,240 * (329*256 + 256*73)): 7.31e11 FLOP -> 0.74 ms.  Bytes: ~1.3
// GB (g, skip, dskip, hm, dhm) -> 0.38 ms.  Operations bound it;
// chip_smoke.py phase 3 divides by the first (0.523 ms), the call it times.
//
// Design: the TPU kernel recomputes one latitude row in VMEM and
// accumulates da, db and the weight gradients in output blocks revisited by
// every step of its sequential grid.  Here, in launches on the caller's
// stream:
//   0. a pre-pass writes t = bf16(hm), zero rows past 2M;
//   A. `decoder_bwd_tiles` (persistent, chain_gemm.cuh's tiles and GEMMs)
//      walks 128-pixel tiles of a row (1440 = 11 * 128 + 32: TMA zero-fills
//      the last tile's loads and clips its stores) with four consumer
//      warpgroups and no producer: a ring of DBW_STAGES stages of K = 128
//      (32 KB of B boxes) refills itself (SelfRefill, DBW_THREADS).  Two
//      m64n128 accumulator sets do not fit the 128 registers a thread has,
//      so every GEMM runs in column blocks of 128, a warpgroup's 64 columns
//      on m64n64, and two accumulators of 32 meet in one epilogue.
//      Per tile:
//      1. x_raw = Mt[tile] @ t_row (Mt's tile by TMA into K-chunks X0-X3
//         of the A tile, t through the ring), two blocks; the epilogue
//         writes bf16(x_raw * a + b) over Mt (block 0 waits in D while
//         block 1 reads Mt) and the fp32 x_raw fragments to the block's
//         scratch in device memory (128 KB a block, rewritten every tile:
//         it stays in L2); the raw skip and g rows, prefetched into L2
//         during the last tile's step 4, are converted to bf16 into X4-X5
//         and the g tile G;
//      2. per hidden block of 128: z1 = [xa | skip] @ W1 and dh1 = bf16(g)
//         @ W2^T (W2^T prepared once, like W1^T), dz1 = dh1 * gelu'(z1 +
//         b1) with the JAX kernel's gelu' (A&S 7.1.26's erf, whose exp is
//         phi's too), bf16 into the dz tile (block 0 into D; block 1 into
//         X0-X1, free once the last z1 has read them);
//      3. per channel block of 128: dxa = bf16(dz1) @ W1a^T meets the fp32
//         x_raw that each thread wrote in step 1 and reads back (the same
//         bits as a recompute: JAX's rounding point for da, route (a)) in
//         one epilogue: bf16(dxa) into X2-X5 and out by TMA for pass B,
//         and the fixed-order column sums of dxa * x_raw and dxa (halving
//         shuffle exchanges per warp, the 8 warps of a column in order
//         through shared memory: one partial row per tile, no atomics);
//      4. dskip = bf16(dz1) @ W1b^T, fp32, through shared memory (D and G)
//         out as one contiguous run of coalesced stores.
//      With weight gradients (need_w) pass A also writes the bf16 operands
//      [bf16(xa) | bf16(skip)], bf16(gelu(z1)), bf16(g) and bf16(dz1), and
//      per-warp partials of dz1.
//   B. dhm = a[b] * (Mt^T @ bf16(dxa)) per row: the transposed DFT has the
//      shape of the head's forward DFT, so it is dft_tiles.cuh's
//      analysis_wgmma in its DIRECT mode (TMA reads dxa's 64 x 64 boxes as
//      the B operand) on the prepared Mt^T, scaling by a[b] in its
//      epilogue.
//   C. da, db: the tiles' partials added per sample in a fixed order
//      (tile_reduce in runs, then stats_reduce); with need_w dW1 and dW2
//      are split-K GEMMs over the pixels into per-split partials added in a
//      fixed order, db1 the warps' partials and db2 the column sums of g in
//      fixed-order runs.  Deterministic.
// Shared memory: the A tile X (6 chunks of 128 x 64 bf16, 96 KB), D and G
// (32 KB each), the ring (DBW_STAGES x DBW_CHUNKS x 16 KB), b1: 226 KB.
//
// Measured on the H100 (tools/kernel_variants.py, ms a call): K = 128
// stages beat K = 64 ones (4.21 against 4.82-4.96, 2 to 4 stages), a second
// stage of prefetch gains 9%, a stage that runs all its K-steps beats one
// that switches over the count (3.84 against 4.57: the switch made ptxas
// serialize the wgmmas), reading x_raw back beats recomputing it (3.80
// against 3.89), dxa out by TMA beats fragment stores (3.64 against 3.81),
// the A&S gelu' and the halving exchanges beat the rational erf's and a
// shuffle tree per column (3.49 against 3.60).  Tried and slower: raw rows
// read a row per warp, dskip out by one bulk copy, the raw rows' conversion
// between a stage's wgmma issue and its wait (registers spilled).
// What bounds it (phase timers of an instrumented copy): a ring stage costs
// ~2.5x its tensor-core time (m64n64 reads A from shared memory for every
// 64 columns; 16 warps drain each stage in lockstep), and the tensor cores
// idle in the epilogues: the raw rows' conversion, the GELU derivative of
// 32K values a tile, dskip's staging.
//
// Tunable (tools/kernel_variants.py): DBW_STAGES, the ring's depth.
//
// fp32 operands ("float32", "tensorfloat"; spectral_decoder_bwd_f32): the
// same gradients with nothing rounded to bf16: the MLP's three products are
// fp32-class products in three TF32 tensor-core passes over hi / lo splits
// (row_gemm.cuh:gemm_tf32x3, fp32 accumulation), the rest fp32 on the CUDA
// cores, and the JAX kernel's gelu' (A&S 7.1.26).  The least time of an
// fp32-class product on this card is three TF32 tensor-core passes (495 /
// 3 = 165 TFLOP/s).  Bound at the serving shapes, film-only (no weight
// gradients), with the DFTs folded: recompute and dhm 2 * n * 2M * C / 2 =
// 1.29e11 FLOP, the MLP's recompute, dh1, dxa and dskip 2 * n * (2 (C + S)
// hidden + hidden C_out) = 3.89e11: 5.17e11 FLOP -> 3.13 ms at 165
// TFLOP/s (operations); with dW1 and dW2 7.31e11 -> 4.43 ms.  A 128-row x
// 512 fp32 tile does not fit a block's shared memory (the bf16 design's
// chain), so the passes go through device memory, each a launch of
// gemm_tf32x3 or of dft_tiles.cuh's fold:
//   1. x_raw = Mt @ hm: the synthesis fold into an fp32 scratch xg (n x C);
//   2. z1 = [a x_raw + b | skip] @ W1 + b1 (mlp_f32.cuh's MlpInput, the
//      rows' segments the samples) into a scratch z (n x hidden);
//   3. dz1 = (g @ W2^T) * gelu'(z1), over z1 in place;
//   4. [dxa | dskip] = dz1 @ [W1a | W1b]^T on DX_BN-column tiles: dskip
//      stored, the per-(sample, 128-row tile) partials of sum dxa * x_raw
//      and sum dxa (fp32 dxa against the fp32 x_raw: JAX's rounding point),
//      then a * dxa over x_raw in xg (a per-channel scale commutes with the
//      DFT);
//   5. da, db: tile_reduce in runs, then stats_reduce (fixed order);
//   6. dhm = Mt^T @ (a dxa): the analysis fold, whose operand is
//      dft_analysis.prepare of Mt's cos columns and its negated sin
//      columns (even and odd in longitude, as the fold needs).
// The three products' B operands are spectral_decoder.prepare's hi and lo
// K-major copies (W1^T, W2, W1, rows zero-padded to 16 floats); their A
// comes from the loader's functors (the affine [a x_raw + b | skip], g,
// dz1: the 73-wide skip and g rows are beyond TMA).  On the CUDA cores
// stay the two folds (dft_tiles.cuh), the fixed-order reduces, and the
// need_w weight gradients: with need_w, while z holds z1, dW2 = gelu(z1)^T
// g (the forward's GELU) and db2 = sum g; while xg holds x_raw, dW1 = [xa |
// skip]^T dz1 and db1 = sum dz1.  Each dW is gemm_f32 (true fp32 FMA) with
// a transposed A functor over pixel ranges (blockIdx.z) into partials
// added in order by sum_rows: its B (dz1 or g over the pixels) is MN-major,
// which tf32 wgmma cannot read, and the FiLM fine-tune step never asks for
// it.  Each bias gradient is the column sums of runs of rows, then the
// runs: no atomics, deterministic.  Scratch: xg and z, 2 x 1.06 GB at the
// serving shapes.  Tunable: DX_BN, the column tile of [dxa | dskip] (112
// or 128; z1 and dz1 take 128).

#include "chain_gemm.cuh"
#include "dft_tiles.cuh"
#include "mlp_f32.cuh"

namespace {

#ifndef DBW_STAGES_OVERRIDE
#define DBW_STAGES_OVERRIDE 2
#endif
#ifndef DX_BN_OVERRIDE
#define DX_BN_OVERRIDE 112
#endif
// 112 (3 x 112 = 336 >= 329): the pass took 3.67 ms against 4.36 at 128 on the H100
constexpr int DX_BN = DX_BN_OVERRIDE;
static_assert(TF3_BM == 128, "the wrapper counts da / db tiles of 128 rows (TILE_ROWS)");


constexpr int DBW_STAGES = DBW_STAGES_OVERRIDE;
// K-chunks of 64 per ring stage: a GEMM's K rounded up to whole stages
// stays inside its A tile (K <= 384 for [xa | skip], 128 for g)
constexpr int DBW_CHUNKS = 2;
// the two B boxes of a column block per K-chunk: 32 KB
constexpr int DBW_SLOT = DBW_CHUNKS * 2 * CH_BOX;
constexpr int DBW_X = 6 * CH_CHUNK;            // Mt / [xa | skip] / dz block 1 + Mt
constexpr int DBW_D = 2 * CH_CHUNK;            // xa block 0; dz block 0; dskip's rows
constexpr int DBW_G = 2 * CH_CHUNK;            // bf16 g; the column-sum rows; dskip's rows
constexpr int DBW_BIAS = 256;                  // b1 (floats)
// a tile's ring stages at most (4 + 8 + 4 + 2 at the largest widths taken)
constexpr int DBW_MAX_STAGES = 32;
// the ring's and Mt's barriers, the counts, the stage table
constexpr int DBW_BARS = DBW_STAGES + 1 + (DBW_STAGES + 2) / 2 + DBW_MAX_STAGES / 4;
constexpr int DBW_SMEM = 1024 + DBW_X + DBW_D + DBW_G + DBW_STAGES * DBW_SLOT + DBW_BIAS * 4 +
                         DBW_BARS * 8;
static_assert(DBW_SMEM <= 232448, "the backward tile kernel does not fit in shared memory");
// pass B's ring depth (0 fills 192 KB, as the head's DFT pass)
constexpr int DBW_DFT_STAGES = 0;
// a block's x_raw scratch: its consumer threads' fragments of both channel
// blocks (floats)
constexpr int DBW_XR = 2 * 32 * CH_CONSUMERS;

struct BwdArgs {
  const float* g;            // (B, H, W, c_out)
  const float* skip;         // (B, H, W, s)
  const float* aff_a;        // (B, c)
  const float* aff_b;        // (B, c)
  const float* b1;           // (hidden,)
  __nv_bfloat16* dxa;        // (B, H, W, c) scratch: bf16(dxa)
  float* dskip;              // (B, H, W, s)
  float* part_da;            // (B * H * tiles, c)
  float* part_db;
  __nv_bfloat16* xin;        // need_w: (B*H*W, k1p) [bf16(xa) | bf16(skip)]
  __nv_bfloat16* h1;         // need_w: (B*H*W, hidden) bf16(gelu(z1))
  __nv_bfloat16* gb;         // need_w: (B*H*W, n2p) bf16(g)
  __nv_bfloat16* dz;         // need_w: (B*H*W, hidden) bf16(dz1)
  float* part_db1;           // need_w: (B * H * tiles * 8, hidden)
  float* xr;                 // (blocks, DBW_XR) scratch: fp32 x_raw of the block's tile
  int H, W, tiles, rows, m2p, c, s, k1p, hidden, c_out, n2p, need_w;
};

// t = bf16(hm), rows [two_m, m2p) zero: 8 channels per thread
__global__ void hm_to_bf16(const void* hm, int hm_bf16, __nv_bfloat16* t, int two_m, int m2p,
                           int c, long long n_vec) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= n_vec) return;
  const long long e0 = v * 8;
  const int col = (int)(e0 % c);
  const long long row = e0 / c;  // (b * H + h) * m2p + m
  const int m = (int)(row % m2p);
  const long long src = ((row / m2p) * two_m + m) * c + col;
  __align__(16) __nv_bfloat16 out[8];
#pragma unroll
  for (int e = 0; e < 8; ++e)
    out[e] = __float2bfloat16_rn(m < two_m ? load_act(hm, src + e, hm_bf16) : 0.f);
  *reinterpret_cast<uint4*>(t + e0) = *reinterpret_cast<const uint4*>(out);
}

// Rows [row0, row0 + n_rows) x columns [0, width) of an A tile (K-chunks of
// 64 at tile + j * CH_CHUNK) to device rows of `width` bf16 values; width a
// multiple of 8.  Thread tid of n_threads takes every n_threads-th
// 16-byte unit.
__device__ __forceinline__ void a_tile_to_rows(const char* tile, int row0, int n_rows,
                                               int width, __nv_bfloat16* dst, int tid,
                                               int n_threads) {
  const int units = width / 8;
  for (int e = tid; e < n_rows * units; e += n_threads) {
    const int r = e / units, u = e % units;
    *reinterpret_cast<uint4*>(dst + (long long)r * width + 8 * u) =
        *reinterpret_cast<const uint4*>(tile + a_tile_offset(row0 + r, 8 * u));
  }
}

// The sum of a fragment column over this warp's 16 rows, given a thread's
// two values (rows r0 and r0 + 8, zero where not valid): a shuffle tree over
// the warp's 8 row groups, fixed order; every lane gets its column's sum.
__device__ __forceinline__ float warp_col_sum(float lo, float hi) {
  float x = lo + hi;
  x += __shfl_xor_sync(0xffffffffu, x, 4);
  x += __shfl_xor_sync(0xffffffffu, x, 8);
  x += __shfl_xor_sync(0xffffffffu, x, 16);
  return x;
}

// One halving step of a column-sum exchange: the lanes whose bit 2 H is set
// keep entries [H, 2 H) of v, the others [0, H); each adds its partner's
// copy of the entries it keeps into v[0, H).
template <int H>
__device__ __forceinline__ void halve(float (&v)[16], bool up) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = up ? v[H + i] : v[i], send = up ? v[i] : v[H + i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

// d/dv gelu(v) = Phi(v) + v phi(v) as the JAX backward kernel computes it:
// Phi on A&S 7.1.26's erf, whose exp(-v^2 / 2) is phi's too
__device__ __forceinline__ float gelu_grad_as(float v) {
  const float ax = fabsf(v) * 0.70710678118654752f;
  const float t = __fdividef(1.f, fmaf(0.3275911f, ax, 1.f));
  float p = fmaf(t, 1.061405429f, -1.453152027f);
  p = fmaf(t, p, 1.421413741f);
  p = fmaf(t, p, -0.284496736f);
  p = fmaf(t, p, 0.254829592f);
  const float e = __expf(-0.5f * v * v);
  const float half_tail = 0.5f * t * p * e;  // (1 - erf(|v| / sqrt 2)) / 2
  return (v >= 0.f ? 1.f - half_tail : half_tail) + v * 0.3989422804014327f * e;
}

// Four consumer warpgroups and no producer: 512 threads leave each 128
// registers (a sub-partition's 16K registers hold 4 warps of 128).  With a
// producer warp or warpgroup beside them (544 or 640 threads) ptxas has 96,
// too few for two live 64 x 64 accumulators: it spilled 5.7 KB.  So the
// ring refills itself: the last warp to release a stage issues the stage
// that takes its slot next (a shared-memory count per slot), and the last
// warp past a point of the tile issues Mt's next load.  No warp waits for a
// slot to free.
constexpr int DBW_THREADS = CH_CONSUMERS;

// The ring's stage order in a tile: 1. t's blocks (nq x n1); 2. per hidden
// block W1's then W2^T's (nj x (n2 + n3)); 3. per channel block W1a^T's
// (nq x n4); 4. W1b^T's (n4).  A block builds the table of
// one tile's stages once (stage_code); a refill looks its stage up, so that
// the warp that issues it (on the ring's critical path) spends few cycles.
enum MapId { MAP_T = 0, MAP_W1 = 1, MAP_W2T = 2, MAP_W1T = 3 };

struct Sched {
  int per_tile, n_tiles, tiles;
};

// K rows per ring stage
constexpr int DBW_SK = DBW_CHUNKS * CH_BK;

// stage j of a tile: map id, boxes - 1, first column / 16, first K row /
// DBW_SK
__device__ __forceinline__ uint16_t stage_code(int j, const BwdArgs& a) {
  const int n1 = (a.m2p + DBW_SK - 1) / DBW_SK, n2 = (a.k1p + DBW_SK - 1) / DBW_SK;
  const int n3 = (a.n2p + DBW_SK - 1) / DBW_SK, n4 = (a.hidden + DBW_SK - 1) / DBW_SK;
  const int nq = (a.c + 127) / 128, nj = (a.hidden + 127) / 128;
  auto code = [](int map, int col0, int n, int k) {
    const int boxes = col0 + 64 < n ? 2 : 1;
    return (uint16_t)(map | (boxes - 1) << 2 | (col0 / 16) << 3 | k << 9);
  };
  if (j < nq * n1) return code(MAP_T, 128 * (j / n1), a.c, j % n1);  // 1. t
  j -= nq * n1;
  if (j < nj * (n2 + n3)) {  // 2. W1, W2^T
    const int k = j % (n2 + n3), col0 = 128 * (j / (n2 + n3));
    return k < n2 ? code(MAP_W1, col0, a.hidden, k) : code(MAP_W2T, col0, a.hidden, k - n2);
  }
  j -= nj * (n2 + n3);
  if (j < nq * n4) return code(MAP_W1T, 128 * (j / n4), a.c, j % n4);  // 3. W1a^T
  return code(MAP_W1T, a.c, a.c + a.s, j - nq * n4);                   // 4. W1b^T
}

struct Maps {
  const CUtensorMap* m[4];  // by MapId
  const CUtensorMap* mt;
};

// One thread: Mt's tile of tile tl into n1 K-chunks at dst, on bar.
__device__ __forceinline__ void issue_mt(int tl, char* dst, uint64_t* bar, const Maps& m,
                                         int tiles, int n1) {
  const int w0 = (tl % tiles) * CH_BM;
  mbar_expect_tx(bar, n1 * CH_CHUNK);
  for (int j = 0; j < n1; ++j) tma_load_2d(dst + j * CH_CHUNK, m.mt, bar, CH_BK * j, w0);
}

// One thread: ring stage S of this block (its slot is free), nothing past
// the last tile.
__device__ __forceinline__ void issue_stage(int S, const Ring& ring, const Maps& m,
                                            const uint16_t* table, const Sched& sc) {
  const int it = S / sc.per_tile;
  const int tl = blockIdx.x + it * gridDim.x;
  if (tl >= sc.n_tiles) return;
  const uint32_t d = table[S - it * sc.per_tile];
  const int map = d & 3, boxes = 1 + ((d >> 2) & 1), col0 = 16 * ((d >> 3) & 63);
  const int z = map == MAP_T ? tl / sc.tiles : -1;
  char* dst = ring.slots + (S % DBW_STAGES) * DBW_SLOT;
  uint64_t* full = ring.full + S % DBW_STAGES;
  mbar_expect_tx(full, DBW_CHUNKS * boxes * CH_BOX);
  for (int c = 0; c < DBW_CHUNKS; ++c)  // K rows past the matrix come as zeros
    for (int b = 0; b < boxes; ++b) {
      const int k0 = DBW_SK * (d >> 9) + CH_BK * c;
      if (z >= 0) tma_load_3d(dst + (2 * c + b) * CH_BOX, m.m[map], full, col0 + 64 * b, k0, z);
      else tma_load_2d(dst + (2 * c + b) * CH_BOX, m.m[map], full, col0 + 64 * b, k0);
    }
}

// The ring's release (chain_gemm): lane 0 of a warp is done with stage st;
// the last of the 16 issues the stage that takes the slot next.
struct SelfRefill {
  static constexpr int chunks = DBW_CHUNKS;
  Ring ring;
  Maps maps;
  const uint16_t* table;
  Sched sc;
  uint32_t* cnt;
  __device__ __forceinline__ void operator()(int st) const {
    const int slot = st % DBW_STAGES;
    // the warp's reads of the slot are wgmma's, retired by now: the count
    // needs no fence (one waits for the warp's global stores too)
    if (atomicAdd(cnt + slot, 1u) + 1 == CH_CONSUMERS / 32) {
      cnt[slot] = 0;
      issue_stage(st + DBW_STAGES, ring, maps, table, sc);
    }
  }
};

template <bool NEED_W>
__global__ void __launch_bounds__(DBW_THREADS, 1)
    decoder_bwd_tiles(const __grid_constant__ CUtensorMap mt_map,
                      const __grid_constant__ CUtensorMap t_map,
                      const __grid_constant__ CUtensorMap w1_map,
                      const __grid_constant__ CUtensorMap w2t_map,
                      const __grid_constant__ CUtensorMap w1t_map,
                      const __grid_constant__ CUtensorMap dxa_map,
                      const __grid_constant__ BwdArgs a) {
  extern __shared__ char smem_raw[];
  char* xt = smem_base_1024(smem_raw);  // the A tile X
  char* dt = xt + DBW_X;                 // D
  char* gt = dt + DBW_D;                 // G
  char* slots = gt + DBW_G;
  float* bias = reinterpret_cast<float*>(slots + DBW_STAGES * DBW_SLOT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(bias + DBW_BIAS);
  const Ring ring{slots, bars, nullptr, DBW_SLOT, DBW_STAGES};
  uint64_t* mt_full = bars + DBW_STAGES;  // Mt's tile has landed in X0-X3
  // warps done with each slot; then with the tile
  uint32_t* cnt = reinterpret_cast<uint32_t*>(mt_full + 1);
  uint16_t* table = reinterpret_cast<uint16_t*>(cnt + DBW_STAGES + 1);
  const int n1 = round_up(a.m2p, DBW_SK) / CH_BK;  // Mt's K-chunks, whole stages
  const int nq = (a.c + 127) / 128, nj = (a.hidden + 127) / 128;
  const int s1 = (a.m2p + DBW_SK - 1) / DBW_SK, s4 = (a.hidden + DBW_SK - 1) / DBW_SK;
  Sched sc;
  sc.per_tile = nq * s1 + nj * ((a.k1p + DBW_SK - 1) / DBW_SK + (a.n2p + DBW_SK - 1) / DBW_SK) +
                nq * s4 + s4;
  sc.n_tiles = a.rows * a.tiles;
  sc.tiles = a.tiles;
  const Maps maps{{&t_map, &w1_map, &w2t_map, &w1t_map}, &mt_map};
  for (int j = threadIdx.x; j < sc.per_tile; j += blockDim.x) table[j] = stage_code(j, a);
  if (threadIdx.x == 0) {
    for (int s = 0; s < DBW_STAGES; ++s) mbar_init(ring.full + s, 1);
    mbar_init(mt_full, 1);
    for (int i = 0; i < DBW_STAGES + 1; ++i) cnt[i] = 0;
    fence_barrier_init();
    prefetch_map(&mt_map);
    prefetch_map(&t_map);
    prefetch_map(&w1_map);
    prefetch_map(&w2t_map);
    prefetch_map(&w1t_map);
  }
  __syncthreads();  // the barriers and the table
  if (threadIdx.x == 0) {
    if (blockIdx.x < sc.n_tiles) issue_mt(blockIdx.x, xt, mt_full, maps, sc.tiles, n1);
    for (int s = 0; s < DBW_STAGES; ++s) issue_stage(s, ring, maps, table, sc);
  }
  const SelfRefill release1{ring, maps, table, sc, cnt};
  // lane 0 of a warp: past the last read of the tile; the last of the 16
  // issues Mt's load into X0-X3 for tile tl
  auto pass_tile = [=](int tl) {
    __threadfence_block();
    if (atomicAdd(cnt + DBW_STAGES, 1u) + 1 == CH_CONSUMERS / 32) {
      cnt[DBW_STAGES] = 0;
      if (tl < sc.n_tiles) issue_mt(tl, xt, mt_full, maps, sc.tiles, n1);
    }
  };

  // consumers: warpgroup (m, n) owns tile rows [64 m, 64 m + 64) and, in a
  // block of 128 columns, columns [64 n, 64 n + 64)
  const Role ro;
  float* const b1_s = bias;
  if (threadIdx.x < 256) b1_s[threadIdx.x] = threadIdx.x < a.hidden ? a.b1[threadIdx.x] : 0.f;
  auto in_x = [xt](int j, char*) { return xt + j * CH_CHUNK; };
  auto in_g = [gt](int j, char*) { return gt + j * CH_CHUNK; };
  auto in_dz = [xt, dt](int j, char*) {
    return j < 2 ? dt + j * CH_CHUNK : xt + (j - 2) * CH_CHUNK;
  };
  // the column sums of dxa * x_raw and dxa per warp: row half m's in its
  // own rows of G (floats [2048 m, 2048 m + 1024) and the next 1024), which
  // only its pair reads as the g tile
  float* red = reinterpret_cast<float*>(gt) + 2048 * ro.m + 256 * ro.w;
  const int r0 = acc_row0(), lane = threadIdx.x % 32, tq = threadIdx.x % 4;
  const bool raw_early = a.c >= CH_BK * n1;  // the skip's columns clear of Mt's
  const int wrow = 4 * ro.m + ro.w;  // this warp's 16 rows of the tile
  // this thread's x_raw fragments of channel block q: 8 float4s, coalesced
  float4* const xr_own = reinterpret_cast<float4*>(a.xr + (long long)blockIdx.x * DBW_XR) +
                         threadIdx.x;
  // two fixed 64 x 64 accumulators for every GEMM of the tile: wgmma takes
  // its accumulator as a range of registers, and a variable per GEMM made
  // ptxas move them through local memory
  float acc0[32], acc1[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc0[i] = acc1[i] = 0.f;
  int s = 0, it = 0;
  for (int tl = blockIdx.x; tl < sc.n_tiles; tl += gridDim.x, ++it) {
    const long long bh = tl / a.tiles;
    const int w0 = (int)(tl % a.tiles) * CH_BM;
    const int n_valid = min(CH_BM, a.W - w0);
    const int my_valid = n_valid - 64 * ro.m;  // rows of this row half
    const long long px0 = bh * a.W + w0;
    consumers_sync();  // b1; the last tile's dskip is out of D and G

    // the raw skip and g rows of the pair's half from device memory (L2:
    // prefetched during the last tile's step 4), converted to bf16 [xa | skip] and the g tile;
    // before GEMM 1 where the skip's columns lie past Mt's (the serving
    // widths), so that the conversion overlaps Mt's load
    auto convert_raw = [&]() {
      rows_to_a_tile<float>(a.skip + (px0 + 64 * ro.m) * a.s, min(64, my_valid), a.s, xt,
                            64 * ro.m, a.c, ro.n * 128 + ro.t, 256);
      rows_to_a_tile<float>(a.g + (px0 + 64 * ro.m) * a.c_out, min(64, my_valid), a.c_out, gt,
                            64 * ro.m, 0, ro.n * 128 + ro.t, 256);
      zero_cols(xt, 64 * ro.m, a.c + round_up(a.s, 16), round_up(a.k1p, DBW_SK),
                ro.n * 128 + ro.t, 256);
      zero_cols(gt, 64 * ro.m, round_up(a.c_out, 16), round_up(a.n2p, DBW_SK),
                ro.n * 128 + ro.t, 256);
    };
    if (raw_early) convert_raw();

    // 1. x_raw = Mt[tile] t_row by blocks of 128 channels, then bf16(x_raw a
    // + b) over the pair's rows of Mt, the bf16 skip and g
    mbar_wait(mt_full, it & 1);
    {
      const float* a_b = a.aff_a + (bh / a.H) * a.c;  // this sample's a and b
      const float* b_b = a.aff_b + (bh / a.H) * a.c;
      auto affine = [a_b, b_b](float v, int col) {
        return v * __ldg(a_b + col) + __ldg(b_b + col);
      };
#pragma unroll 1
      for (int q = 0; q < nq; ++q) {
        const int c0 = 128 * q + 64 * ro.n;
        s = chain_gemm(acc0, ring, s, a.m2p, in_x, ro, c0 < a.c, release1);
        if (c0 < a.c)  // x_raw for step 3, past L1
#pragma unroll
          for (int i = 0; i < 8; ++i)
            __stcg(xr_own + (8 * q + i) * CH_CONSUMERS,
                   make_float4(acc0[4 * i], acc0[4 * i + 1], acc0[4 * i + 2], acc0[4 * i + 3]));
        // block 0 waits in D (chunks 0-1) while block 1 still reads Mt
        if (q + 1 == nq) pair_sync(ro);  // the pair's wgmmas have read Mt
        if (c0 < a.c) frag_to_a_tile(acc0, q + 1 < nq ? dt : xt, 64 * ro.m, c0, a.c, affine);
      }
      if (nq == 2) {  // the pair's rows of block 0 from D into X0-X1
        for (int i = ro.n * 128 + ro.t; i < 2 * 512; i += 256) {
          const int off = (i / 512) * CH_CHUNK + ro.m * 8192 + (i % 512) * 16;
          *reinterpret_cast<uint4*>(xt + off) = *reinterpret_cast<const uint4*>(dt + off);
        }
      }
    }
    if (!raw_early) convert_raw();
    fence_proxy_async();
    pair_sync(ro);
    if (NEED_W && my_valid > 0) {
      const int t = ro.n * 128 + ro.t, rows = min(64, my_valid);
      a_tile_to_rows(xt, 64 * ro.m, rows, a.k1p, a.xin + (px0 + 64 * ro.m) * a.k1p, t, 256);
      a_tile_to_rows(gt, 64 * ro.m, rows, a.n2p, a.gb + (px0 + 64 * ro.m) * a.n2p, t, 256);
    }

    // 2. per hidden block of 128: z1 and dh1, dz1 = dh1 gelu'(z1 + b1) into
    // the dz tile (block 0: D; block 1: X0-X1, once the last z1 is done)
#pragma unroll 1
    for (int j = 0; j < nj; ++j) {
      const int hc0 = 128 * j + 64 * ro.n;
      const bool act = hc0 < a.hidden;
      float(&z)[32] = acc0;
      float(&dh)[32] = acc1;
      s = chain_gemm(z, ring, s, a.k1p, in_x, ro, act, release1);
      s = chain_gemm(dh, ring, s, a.n2p, in_g, ro, act, release1);
      pair_sync(ro);  // the pair is done reading [xa | skip] (X0-X1 takes block 1)
      if (!act && hc0 < round_up(a.hidden, DBW_SK))  // finite dz past hidden
        zero_cols(j == 0 ? dt : xt, 64 * ro.m, 64 * ro.n, 64 * ro.n + 64, ro.t, 128);
      // the epilogue only reads the accumulators: ptxas serializes every
      // wgmma of a kernel whose accumulators other code redefines on a
      // divergent path (C7520)
      if (act) {
        char* base = j == 0 ? dt : xt;
        const bool lo = r0 < my_valid, hi = r0 + 8 < my_valid;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int col = hc0 + 8 * q + 2 * tq;  // and col + 1
          float d[2][2];  // rows r0, r0 + 8
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * q + 2 * h;
            const float v0 = z[i] + b1_s[col], v1 = z[i + 1] + b1_s[col + 1];
            d[h][0] = dh[i] * gelu_grad_as(v0);
            d[h][1] = dh[i + 1] * gelu_grad_as(v1);
            *reinterpret_cast<__nv_bfloat162*>(
                base + a_tile_offset(64 * ro.m + r0 + 8 * h, 64 * ro.n + 8 * q + 2 * tq)) =
                __floats2bfloat162_rn(d[h][0], d[h][1]);
            if (NEED_W && r0 + 8 * h < my_valid && col < a.hidden) {  // h1, dz1 rows
              const long long o = (px0 + 64 * ro.m + r0 + 8 * h) * a.hidden + col;
              *reinterpret_cast<__nv_bfloat162*>(a.h1 + o) =
                  __floats2bfloat162_rn(gelu_rational(v0), gelu_rational(v1));
              *reinterpret_cast<__nv_bfloat162*>(a.dz + o) =
                  __floats2bfloat162_rn(d[h][0], d[h][1]);
            }
          }
          if (NEED_W) {  // dz1's column sums over this warp's rows
            float* p = a.part_db1 + (tl * 8 + wrow) * a.hidden + hc0 + 8 * q;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float v = warp_col_sum(lo ? d[0][e] : 0.f, hi ? d[1][e] : 0.f);
              if (lane < 4 && col - 2 * tq + 2 * lane + e < a.hidden) p[2 * lane + e] = v;
            }
          }
        }
      }
    }
    fence_proxy_async();
    pair_sync(ro);  // the pair's dz rows are complete

    // 3. per channel block of 128: dxa and step 1's x_raw; bf16(dxa) out,
    // the column sums of dxa x_raw and dxa into this warp's rows of red
#pragma unroll 1
    for (int q = 0; q < nq; ++q) {
      const int c0 = 128 * q + 64 * ro.n;
      const bool act = c0 < a.c;
      float(&dx)[32] = acc0;
      float(&xr)[32] = acc1;
      // every thread loads (an inactive one reads what it did not write,
      // unused), before the GEMM that hides the latency: acc1 is dh's
      // accumulator, which code on a divergent path must not redefine
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 v = __ldcg(xr_own + (8 * q + i) * CH_CONSUMERS);
        xr[4 * i] = v.x;
        xr[4 * i + 1] = v.y;
        xr[4 * i + 2] = v.z;
        xr[4 * i + 3] = v.w;
      }
      s = chain_gemm(dx, ring, s, a.hidden, in_dz, ro, act, release1);
      if (!act) continue;
      float* rd = red + c0;
      const bool lo = r0 < my_valid, hi = r0 + 8 < my_valid;
      // each sum's 16 column values over the warp's 8 row groups by halving
      // exchanges (lane bits 4, 3, 2; fixed order): 14 shuffles, after
      // which lane l holds columns 8 (l / 4) + 2 tq + {0, 1}
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        float v[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int i = 4 * (j / 2) + j % 2;  // columns 8 (j / 2) + 2 tq + j % 2
          const float u0 = which ? dx[i] : dx[i] * xr[i];
          const float u1 = which ? dx[i + 2] : dx[i + 2] * xr[i + 2];
          v[j] = (lo ? u0 : 0.f) + (hi ? u1 : 0.f);
        }
        halve<8>(v, lane & 16);
        halve<4>(v, lane & 8);
        halve<2>(v, lane & 4);
#pragma unroll
        for (int e = 0; e < 2; ++e) rd[1024 * which + 8 * (lane / 4) + 2 * tq + e] = v[e];
      }
      // bf16(dxa) into X2-X5 (free since step 2) and out by TMA, clipped at W
      char* dxs = xt + 2 * CH_CHUNK;
      frag_to_a_tile(dx, dxs, 64 * ro.m, c0, a.c, [](float v, int) { return v; });
      fence_proxy_async();
      wg_sync(ro);
      if (ro.t == 0 && my_valid > 0) {
        tma_store_3d(&dxa_map, dxs + (c0 / 64) * CH_CHUNK + ro.m * 8192, c0, w0 + 64 * ro.m,
                     (int)bh);
        bulk_commit();
      }
    }
    consumers_sync();  // every warp's rows of red
    {
      const int t = threadIdx.x;  // 512: da's columns, then db's
      const int col = t % 256, which = t / 256;
      if (col < a.c) {  // the 8 warps of the tile in order
        const float* rr = reinterpret_cast<const float*>(gt) + 1024 * which + col;
        float sum = 0.f;
        for (int w = 0; w < 8; ++w) sum += rr[2048 * (w / 4) + 256 * (w % 4)];
        (which ? a.part_db : a.part_da)[tl * a.c + col] = sum;
      }
    }

    // 4. dskip = bf16(dz1) W1b^T (columns [64 n, 64 n + 64) of s), fp32
    // through D and G (rows of s, as in device memory) out
    {
      const bool act = 64 * ro.n < a.s;
      float(&ds)[32] = acc0;
      // the next tile's raw skip and g rows into L2, 128-byte lines: this
      // late, as a whole tile ahead they were evicted before use (3.28
      // against 3.48 ms a call)
      const int tn = tl + gridDim.x;
      if (tn < sc.n_tiles) {
        const long long pn = (tn / a.tiles) * a.W + (tn % a.tiles) * CH_BM;
        const int rows = min(CH_BM, a.W - (int)(tn % a.tiles) * CH_BM);
        const int ls = (rows * a.s * 4 + 127) / 128, lg = (rows * a.c_out * 4 + 127) / 128;
        for (int i = threadIdx.x; i < ls + lg; i += DBW_THREADS)
          prefetch_l2(i < ls ? reinterpret_cast<const char*>(a.skip + pn * a.s) + 128 * i
                             : reinterpret_cast<const char*>(a.g + pn * a.c_out) + 128 * (i - ls));
      }
      s = chain_gemm(ds, ring, s, a.hidden, in_dz, ro, act, release1);
      if (ro.t == 0) bulk_wait_read();  // dxa is out of X2-X5
      __syncwarp();
      if (lane == 0) pass_tile(tl + gridDim.x);  // the next tile's Mt
      consumers_sync();  // every warpgroup is done reading D, and red
      float* ys = reinterpret_cast<float*>(dt) + 64 * ro.m * a.s;
      if (act) {
#pragma unroll
        for (int q = 0; q < 8; ++q)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = 64 * ro.n + 8 * q + 2 * tq + e;
            if (col >= a.s) continue;
            ys[r0 * a.s + col] = ds[4 * q + e];
            ys[(r0 + 8) * a.s + col] = ds[4 * q + 2 + e];
          }
      }
      pair_sync(ro);
      const int rows = min(64, my_valid), t = ro.n * 128 + ro.t;
      if (rows > 0) {
        const int n = rows * a.s;
        float* dst = a.dskip + (px0 + 64 * ro.m) * a.s;
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

template <bool NEED_W>
int launch_tiles(const CUtensorMap* maps, const BwdArgs& a, long long blocks,
                 cudaStream_t stream) {
  static bool smem_set = false;  // once per kernel
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        decoder_bwd_tiles<NEED_W>, cudaFuncAttributeMaxDynamicSharedMemorySize, DBW_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  decoder_bwd_tiles<NEED_W><<<(unsigned)blocks, DBW_THREADS, DBW_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a);
  return (int)cudaGetLastError();
}

// the column sums of x (n_rows, c) fp32 in runs of `run` rows: part[p, j] =
// sum over rows [p run, (p + 1) run) in order
__global__ void col_sums(const float* x, long long n_rows, int c, int run, float* part) {
  const int j = threadIdx.x;
  if (j >= c) return;
  const long long r0 = (long long)blockIdx.x * run;
  const long long r1 = min(r0 + run, n_rows);
  float sum = 0.f;
  for (long long r = r0; r < r1; ++r) sum += x[r * c + j];
  part[(long long)blockIdx.x * c + j] = sum;
}

enum Ptr { P_G, P_HM, P_SKIP, P_A, P_B, P_MT, P_W1, P_B1, P_W2T, P_W1T, P_MTT, P_DHM, P_DSKIP,
           P_DA, P_DB, P_DW1, P_DB1, P_DW2, P_DB2, P_T, P_DXA, P_PART_DA, P_PART_DB, P_XIN,
           P_H1, P_GB, P_DZ, P_PART_DB1, P_PART_DB2, P_PART_W, P_GRP_DA, P_GRP_DB, P_XR, N_PTRS };
enum Int { I_B, I_H, I_W, I_TWO_M, I_M2P, I_W_PAD, I_C, I_S, I_K1P, I_HIDDEN, I_C_OUT, I_N2P,
           I_MTT_ROWS, I_MTT_COLS, I_HM_BF16, I_NEED_W, I_SPLITS, I_SUM_RUN,
           I_GROUPS, I_BLOCKS, N_INTS };

// ---------------------------------------------------------------------------
// fp32 operands: a chain of passes on row_gemm.cuh:gemm_tf32x3 (see the note
// at the top)

// The epilogues below load all they read (b1, z1, x_raw, a) before they
// store anything: loads that follow stores to the same array would wait
// for each other, and at one block an SM nothing hides that latency.

// pass 2's epilogue: z1 = acc + b1, fp32 rows of `hidden` (a fragment's
// column pair as one 8-byte store where `hidden` is even)
struct Z1Store {
  float* z;
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
      float* p = z + m * hidden + n;
      if (hidden % 2 == 0) {
        *reinterpret_cast<float2*>(p) = make_float2(acc[v] + bias[u], acc[v + 1] + bias[u + 1]);
      } else {
        p[0] = acc[v] + bias[u];
        if (n + 1 < hidden) p[1] = acc[v + 1] + bias[u + 1];
      }
    }
  }
};

// pass 3's epilogue: dz1 = acc * gelu'(z1), over z1 in place (each element
// is read and written by one thread; pairs as 8-byte accesses where
// `hidden` is even)
struct DzStore {
  float* z;
  int hidden;
  template <int NV>
  __device__ __forceinline__ void operator()(const float (&acc)[NV], const TcTile& t) const {
    float z1[NV];
#pragma unroll
    for (int v = 0; v < NV; v += 2) {
      const long long m = t.m0 + t.row(v);
      const int n = t.n0 + t.col(v);
      z1[v] = z1[v + 1] = 0.f;
      if (m >= t.m_end || n >= hidden) continue;
      const float* p = z + m * hidden + n;
      if (hidden % 2 == 0) {
        const float2 w = *reinterpret_cast<const float2*>(p);
        z1[v] = w.x;
        z1[v + 1] = w.y;
      } else {
        z1[v] = p[0];
        if (n + 1 < hidden) z1[v + 1] = p[1];
      }
    }
#pragma unroll
    for (int v = 0; v < NV; v += 2) {
      const long long m = t.m0 + t.row(v);
      const int n = t.n0 + t.col(v);
      if (m >= t.m_end || n >= hidden) continue;
      float* p = z + m * hidden + n;
      const float d0 = acc[v] * gelu_grad_as(z1[v]), d1 = acc[v + 1] * gelu_grad_as(z1[v + 1]);
      if (hidden % 2 == 0) {
        *reinterpret_cast<float2*>(p) = make_float2(d0, d1);
      } else {
        p[0] = d0;
        if (n + 1 < hidden) p[1] = d1;
      }
    }
  }
};

// pass 4's epilogue, [dxa | dskip] = acc: columns n < c are dxa, read
// against x_raw (the grid field, fp32) into the tile's column sums of dxa *
// x_raw and of dxa (each thread its two rows, the warp's 8 row groups by
// xor shuffles, then the 8 consumer warps in order through shared memory:
// one partial per (sample, tile, column)), then stored as a[sample] * dxa
// over x_raw (each element read and written by one thread); columns c <= n
// < c + s are dskip
struct DxStore {
  float* xg;
  float* dskip;
  const float* aff_a;
  float* part_da;
  float* part_db;
  int c, s, tiles;
  template <int NV>
  __device__ __forceinline__ void operator()(const float (&acc)[NV], const TcTile& t) const {
    constexpr int BN = 2 * NV;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    float x_raw[NV], scale[NV / 2];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const long long m = t.m0 + t.row(v);
      const int n = t.n0 + t.col(v);
      x_raw[v] = m < t.m_end && n < c ? xg[m * c + n] : 0.f;
      if (v % 4 < 2)  // a[sample] of the thread's columns
        scale[2 * (v / 4) + v % 2] = n < c ? __ldg(aff_a + (long long)t.seg * c + n) : 0.f;
    }
    float* sh_a = t.smem;  // (8 warps, BN)
    float* sh_b = t.smem + 8 * BN;
    const bool sums = t.n0 < c;  // else the tile's columns are all dskip's
    if (sums) t.sync();  // the block's last tile has read sh_a and sh_b
#pragma unroll
    for (int q = 0; q < NV / 4; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = t.n0 + t.col(4 * q + e);
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = 4 * q + 2 * h + e;
          const long long m = t.m0 + t.row(v);
          if (m >= t.m_end) continue;
          const float d = acc[v];
          if (n < c) {
            sa = fmaf(d, x_raw[v], sa);
            sb += d;
            xg[m * c + n] = d * scale[2 * q + e];
          } else if (n < c + s) {
            dskip[m * s + (n - c)] = d;
          }
        }
        if (!sums) continue;
#pragma unroll
        for (int x = 4; x < 32; x <<= 1) {
          sa += __shfl_xor_sync(0xffffffffu, sa, x);
          sb += __shfl_xor_sync(0xffffffffu, sb, x);
        }
        if (lane < 4) {
          sh_a[warp * BN + t.col(4 * q + e)] = sa;
          sh_b[warp * BN + t.col(4 * q + e)] = sb;
        }
      }
    }
    if (!sums) return;  // uniform over the tile
    t.sync();
    const int col = threadIdx.x;
    if (col < BN && t.n0 + col < c) {
      float ta = 0.f, tb = 0.f;
      for (int w = 0; w < TF3_CONSUMERS / 32; ++w) {
        ta += sh_a[w * BN + col];
        tb += sh_b[w * BN + col];
      }
      const long long i = ((long long)t.seg * tiles + t.tile) * c + t.n0 + col;
      part_da[i] = ta;
      part_db[i] = tb;
    }
  }
};

// dW1's A (with A_T: element (j, k) of [xa | skip]^T): channel j of pixel
// k, the affine of pixel k's sample applied to the main channels
struct XinT {
  const float* x;
  const void* skip;
  const float* aff_a;
  const float* aff_b;
  int rps, c_main, c_skip, skip_bf16;
  __device__ __forceinline__ float operator()(long long j, long long k, int) const {
    if (j < c_main) {
      const long long i = (long long)((int)k / rps) * c_main + j;
      return fmaf(aff_a[i], x[k * c_main + j], aff_b[i]);
    }
    return load_act(skip, k * c_skip + (j - c_main), skip_bf16);
  }
};

// dW2's A (with A_T): gelu(z1) of hidden unit j at pixel k, the forward
// kernels' GELU
struct GeluT {
  const float* z;
  int hidden;
  __device__ __forceinline__ float operator()(long long j, long long k, int) const {
    return gelu_rational(z[k * hidden + j]);
  }
};

// dW = A^T-functor x B over the pixels, split into `splits` ranges of
// pixels whose partial products (splits, rows, cols) are then added in
// order: deterministic
template <class ALoad>
int weight_grad(const ALoad& a, const float* b, int rows, int cols, long long n_px, int splits,
                float* part, float* out, cudaStream_t st) {
  int err = gemm_f32_run<true>(a, b, cols, rows, cols, n_px, splits, 0,
                                      F32Store{part, cols, rows, cols, nullptr, 0}, st);
  if (err) return err;
  sum_rows<<<(rows * cols + 255) / 256, 256, 0, st>>>(part, splits, rows * cols, out);
  return (int)cudaGetLastError();
}

// the column sums of x (n_rows, c) fp32: runs of `run` rows, then the runs
// in order
int column_sums(const float* x, long long n_rows, int c, int run, float* part, float* out,
                cudaStream_t st) {
  const long long runs = (n_rows + run - 1) / run;
  if (runs > INT_MAX || c > 1024) return (int)cudaErrorInvalidValue;
  col_sums<<<(unsigned)runs, (c + 31) / 32 * 32, 0, st>>>(x, n_rows, c, run, part);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sum_rows<<<(c + 255) / 256, 256, 0, st>>>(part, (int)runs, c, out);
  return (int)cudaGetLastError();
}

enum F32Ptr { Q_G, Q_HM, Q_SKIP, Q_A, Q_B, Q_AT_SYN, Q_AT_ANA, Q_W1T_X3, Q_B1, Q_W2_X3, Q_W1_X3,
              Q_DHM, Q_DSKIP, Q_DA, Q_DB, Q_DW1, Q_DB1, Q_DW2, Q_DB2, Q_XG, Q_Z, Q_PART_DA,
              Q_PART_DB, Q_GRP_DA, Q_GRP_DB, Q_PART_W, Q_PART_DB1, Q_PART_DB2, N_F32_PTRS };
enum F32Int { J_B, J_H, J_W, J_M, J_C, J_S, J_HIDDEN, J_C_OUT, J_SYN_ROWS, J_SYN_COLS,
              J_ANA_ROWS, J_ANA_COLS, J_HM_BF16, J_SKIP_BF16, J_NEED_W, J_GROUPS, J_SPLITS_W1,
              J_SPLITS_W2, J_SUM_RUN, J_K1_PAD, J_C_OUT_PAD, J_HIDDEN_PAD, N_F32_INTS };

}  // namespace

// Rows of the Mt operand must be padded to a multiple of this (zero rows).
extern "C" int spectral_decoder_bwd_chunk() { return CH_BK; }

// Pixels per tile of pass A: the da / db partials are B * H * ceil(W / this)
// rows, db1's 8 times as many.
extern "C" int spectral_decoder_bwd_tile_rows() { return CH_BM; }

// Floats of the x_raw scratch per block of the tile pass.
extern "C" int spectral_decoder_bwd_xr_floats() { return DBW_XR; }

// The tiles that shape the prepared Mt^T operand of pass B (those of
// dft_analysis: 2: BF16_K, 3: BF16_TILE).
extern "C" int spectral_decoder_bwd_tile(int i) { return dft_tile(i); }

// ptrs and ints follow the Ptr and Int enums above.  g and skip fp32.
// Operands: mt (w_pad, m2p) bf16; w1 (k1p, hidden) and its
// transpose w1t (hidden, k1p), w2t (n2p, hidden): the transpose of the
// forward's (hidden, n2p) W2; mtt (mtt_rows, mtt_cols): Mt^T as
// dft_analysis prepares a bf16 operand.  Outputs: dhm (B, H, two_m, c),
// dskip (B, H, W, s), da, db (B, c) fp32; with need_w also dw1p (k1p,
// hidden) in the w1 operand's row layout, db1 (hidden), dw2p (hidden,
// n2p), db2 (c_out).  Scratch: t (B*H*m2p*c bf16), dxa (B*H*W*c bf16),
// part_da, part_db (B*H*tiles*c floats); with need_w xin, h1, gb, dz
// (B*H*W rows of k1p, hidden, n2p, hidden bf16), part_db1 (B*H*tiles*8
// rows of hidden), part_db2 (ceil(B*H*W / sum_run) rows of c_out),
// part_w (splits * max(k1p, n2p) * hidden floats); grp_da, grp_db (B *
// groups * c floats: the first level of da's and db's fixed-order sums);
// xr (blocks * spectral_decoder_bwd_xr_floats() floats, blocks the
// persistent pass's most blocks: one per SM).
extern "C" int spectral_decoder_bwd_bf16(const void* const* ptrs, const long long* ints,
                                         void* stream) {
  BwdArgs a;
  a.g = (const float*)ptrs[P_G];
  a.skip = (const float*)ptrs[P_SKIP];
  a.aff_a = (const float*)ptrs[P_A];
  a.aff_b = (const float*)ptrs[P_B];
  a.b1 = (const float*)ptrs[P_B1];
  a.dxa = (__nv_bfloat16*)ptrs[P_DXA];
  a.dskip = (float*)ptrs[P_DSKIP];
  a.part_da = (float*)ptrs[P_PART_DA];
  a.part_db = (float*)ptrs[P_PART_DB];
  a.xin = (__nv_bfloat16*)ptrs[P_XIN];
  a.h1 = (__nv_bfloat16*)ptrs[P_H1];
  a.gb = (__nv_bfloat16*)ptrs[P_GB];
  a.dz = (__nv_bfloat16*)ptrs[P_DZ];
  a.part_db1 = (float*)ptrs[P_PART_DB1];
  a.xr = (float*)ptrs[P_XR];
  const int b = (int)ints[I_B];
  a.H = (int)ints[I_H];
  a.W = (int)ints[I_W];
  const int two_m = (int)ints[I_TWO_M];
  a.m2p = (int)ints[I_M2P];
  const long long w_pad = ints[I_W_PAD];
  a.c = (int)ints[I_C];
  a.s = (int)ints[I_S];
  a.k1p = (int)ints[I_K1P];
  a.hidden = (int)ints[I_HIDDEN];
  a.c_out = (int)ints[I_C_OUT];
  a.n2p = (int)ints[I_N2P];
  a.need_w = (int)ints[I_NEED_W];
  const int hm_bf16 = (int)ints[I_HM_BF16];
  const int splits = (int)ints[I_SPLITS], sum_run = (int)ints[I_SUM_RUN];
  const int groups = (int)ints[I_GROUPS];
  const long long max_blocks = ints[I_BLOCKS];
  const int mtt_rows = (int)ints[I_MTT_ROWS], mtt_cols = (int)ints[I_MTT_COLS];
  if (b < 1 || b > 65535 || a.H < 1 || a.W < 1 || w_pad % CH_BK || w_pad < a.W ||
      two_m < 2 || two_m % 2 || a.m2p < two_m || a.m2p % 16 || a.m2p > 4 * CH_BK ||
      a.c < 16 || a.c % 16 || a.c > 256 || a.s < 1 || a.s > 128 || a.k1p < a.c + a.s ||
      a.k1p % 16 || a.k1p > DBW_X / CH_CHUNK * CH_BK || a.hidden < 16 || a.hidden % 16 ||
      a.hidden > 256 || a.c_out < 1 || a.n2p < a.c_out || a.n2p % 16 || a.n2p > 2 * CH_BK ||
      CH_BM * a.s * 4 > DBW_D + DBW_G || splits < 1 || sum_run < 1 || groups < 1 ||
      max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  a.tiles = (a.W + CH_BM - 1) / CH_BM;
  a.rows = b * a.H;
  if ((long long)a.rows * a.tiles * 8 > INT_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  __nv_bfloat16* t = (__nv_bfloat16*)ptrs[P_T];
  CUtensorMap maps[6];
  int err = bf16_map(&maps[0], ptrs[P_MT], (int)w_pad, a.m2p, a.m2p, CH_BM, CH_BK);
  if (!err) err = bf16_map(&maps[1], t, a.m2p, a.c, a.c, CH_BK, 64, (long long)b * a.H);
  if (!err) err = bf16_map(&maps[2], ptrs[P_W1], a.k1p, a.hidden, a.hidden, CH_BK, 64);
  if (!err) err = bf16_map(&maps[3], ptrs[P_W2T], a.n2p, a.hidden, a.hidden, CH_BK, 64);
  if (!err) err = bf16_map(&maps[4], ptrs[P_W1T], a.hidden, a.k1p, a.k1p, CH_BK, 64);
  if (!err) err = bf16_map(&maps[5], a.dxa, a.W, a.c, a.c, 64, 64, a.rows);
  if (err) return err;

  // 0. t = bf16(hm)
  const long long n_vec = (long long)b * a.H * a.m2p * a.c / 8;
  hm_to_bf16<<<(unsigned)((n_vec + 255) / 256), 256, 0, st>>>(ptrs[P_HM], hm_bf16, t, two_m,
                                                             a.m2p, a.c, n_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // A. the tiles; persistent: at most max_blocks (one per SM)
  const long long blocks = min((long long)a.rows * a.tiles, max_blocks);
  err = a.need_w ? launch_tiles<true>(maps, a, blocks, st)
                 : launch_tiles<false>(maps, a, blocks, st);
  if (err) return err;
  // B. dhm = a[b] * (Mt^T @ bf16(dxa)) per row
  err = launch_analysis_direct<float, DBW_DFT_STAGES>(
      ptrs[P_MTT], a.dxa, (float*)ptrs[P_DHM], (long long)a.rows, a.W, two_m / 2, a.c, mtt_rows,
      mtt_cols, a.aff_a, a.H, st);
  if (err) return err;
  // C. da, db: each sample's partials in runs of `per`, then the runs
  const int n_part = a.H * a.tiles;
  const int per = (n_part + groups - 1) / groups, n_runs = (n_part + per - 1) / per;
  float* grp_da = (float*)ptrs[P_GRP_DA];
  float* grp_db = (float*)ptrs[P_GRP_DB];
  tile_reduce<<<dim3((a.c + 31) / 32, b, n_runs), dim3(32, 8), 0, st>>>(
      a.part_da, a.part_db, n_part, per, a.c, grp_da, grp_db);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  stats_reduce<<<dim3((a.c + 31) / 32, b), dim3(32, 8), 0, st>>>(
      grp_da, grp_db, n_runs, a.c, (float*)ptrs[P_DA], (float*)ptrs[P_DB]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (!a.need_w) return (int)cudaSuccess;

  const long long n_px = (long long)b * a.H * a.W;
  const long long k_split = (n_px + splits - 1) / splits;
  float* part_w = (float*)ptrs[P_PART_W];
  // dW1 (k1p x hidden) = xin^T dz
  gemm_bf16<true, false><<<dim3((a.hidden + GEMM_BN - 1) / GEMM_BN,
                                (a.k1p + GEMM_BM - 1) / GEMM_BM, splits),
                           GEMM_THREADS, 0, st>>>(a.xin, a.k1p, a.dz, a.hidden, part_w, a.k1p,
                                                  a.hidden, n_px, k_split);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_rows<<<(a.k1p * a.hidden + 255) / 256, 256, 0, st>>>(part_w, splits, a.k1p * a.hidden,
                                                           (float*)ptrs[P_DW1]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // dW2 (hidden x n2p) = h1^T gb
  gemm_bf16<true, false><<<dim3((a.n2p + GEMM_BN - 1) / GEMM_BN,
                                (a.hidden + GEMM_BM - 1) / GEMM_BM, splits),
                           GEMM_THREADS, 0, st>>>(a.h1, a.hidden, a.gb, a.n2p, part_w, a.hidden,
                                                  a.n2p, n_px, k_split);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_rows<<<(a.hidden * a.n2p + 255) / 256, 256, 0, st>>>(part_w, splits, a.hidden * a.n2p,
                                                           (float*)ptrs[P_DW2]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  sum_rows<<<(a.hidden + 255) / 256, 256, 0, st>>>(a.part_db1, a.rows * a.tiles * 8, a.hidden,
                                                   (float*)ptrs[P_DB1]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // db2: the column sums of g
  return column_sums(a.g, n_px, a.c_out, sum_run, (float*)ptrs[P_PART_DB2], (float*)ptrs[P_DB2],
                     st);
}

// The fp32-operand backward.  ptrs and ints follow the F32Ptr and F32Int
// enums above.  g (B, H, W, c_out) fp32; hm (B, H, 2M, c) and skip (B, H,
// W, s) fp32 or bf16 (hm_bf16, skip_bf16); a, b (B, c); at_syn, at_ana: the
// fp32 fold operands of dft_synthesis.prepare of Mt's (Ci, Si) and of
// dft_analysis.prepare of (Mt's cos columns, its negated sin columns); b1
// (hidden); the hi and lo halves (2, rows, row length) of the three
// products' K-major B: w1t_x3 (2, hidden, k1_pad) of W1^T, w2_x3 (2,
// hidden, c_out_pad) of W2 and w1_x3 (2, c + s, hidden_pad) of W1, each
// row zero-padded to its length, a multiple of 4.  Outputs: dhm (B, H, 2M,
// c), dskip (B, H, W, s), da, db (B, c); with need_w dw1 (c + s, hidden),
// db1 (hidden), dw2 (hidden, c_out), db2 (c_out; null: none).  Scratch:
// xg (B*H*W, c) and z (B*H*W, hidden) fp32; part_da, part_db (B, tiles, c)
// with tiles = ceil(H*W / 128), grp_da, grp_db (B, groups, c); with
// need_w part_w (max(splits_w1 * (c + s) * hidden, splits_w2 * hidden *
// c_out) floats), part_db1 (ceil(B*H*W / sum_run), hidden), part_db2
// (ceil(B*H*W / sum_run), c_out).
extern "C" int spectral_decoder_bwd_f32(const void* const* ptrs, const long long* ints,
                                        void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const long long bsz = ints[J_B], h = ints[J_H], w = ints[J_W];
  const int m = (int)ints[J_M], c = (int)ints[J_C], s = (int)ints[J_S];
  const int hidden = (int)ints[J_HIDDEN], c_out = (int)ints[J_C_OUT];
  const int hm_bf16 = (int)ints[J_HM_BF16], skip_bf16 = (int)ints[J_SKIP_BF16];
  const int need_w = (int)ints[J_NEED_W], groups = (int)ints[J_GROUPS];
  const int splits_w1 = (int)ints[J_SPLITS_W1], splits_w2 = (int)ints[J_SPLITS_W2];
  const int sum_run = (int)ints[J_SUM_RUN];
  const long long k1_pad = ints[J_K1_PAD], c_out_pad = ints[J_C_OUT_PAD];
  const long long hidden_pad = ints[J_HIDDEN_PAD];
  const long long rps = h * w, n_px = bsz * rps;
  const long long tiles = (rps + TF3_BM - 1) / TF3_BM;
  if (bsz < 1 || h < 1 || w < 2 || m < 1 || c < 1 || s < 1 || hidden < 1 || c_out < 1 ||
      n_px > INT_MAX - TF3_BM || groups < 1 || (need_w && (splits_w1 < 1 || splits_w2 < 1 ||
                                                           sum_run < 1)))
    return (int)cudaErrorInvalidValue;
  const float* g = (const float*)ptrs[Q_G];
  const float* aff_a = (const float*)ptrs[Q_A];
  const float* aff_b = (const float*)ptrs[Q_B];
  // the hi and lo halves of the three products' K-major B operands
  const float* w1t = (const float*)ptrs[Q_W1T_X3];
  const float* w2k = (const float*)ptrs[Q_W2_X3];
  const float* w1k = (const float*)ptrs[Q_W1_X3];
  const long long w1t_half = hidden * k1_pad, w2k_half = hidden * c_out_pad;
  const long long w1k_half = (c + s) * hidden_pad;
  float* xg = (float*)ptrs[Q_XG];
  float* z = (float*)ptrs[Q_Z];
  float* part_w = (float*)ptrs[Q_PART_W];
  // 1. x_raw = Mt @ hm, the folded inverse DFT, into xg
  int err = hm_bf16 ? fold_launch<false, __nv_bfloat16, float>(
                          ptrs[Q_AT_SYN], ptrs[Q_HM], xg, bsz * h, (int)w, m, c,
                          (int)ints[J_SYN_ROWS], (int)ints[J_SYN_COLS], st)
                    : fold_launch<false, float, float>(
                          ptrs[Q_AT_SYN], ptrs[Q_HM], xg, bsz * h, (int)w, m, c,
                          (int)ints[J_SYN_ROWS], (int)ints[J_SYN_COLS], st);
  if (err) return err;
  // 2. z1 = [a x_raw + b | skip] @ W1 + b1 into z
  const MlpInput xin{xg, ptrs[Q_SKIP], aff_a, aff_b, c, s, 0, skip_bf16};
  err = gemm_tf32x3_run<128>(xin, w1t, w1t + w1t_half, k1_pad, n_px, hidden, c + s, 1, rps,
                             Z1Store{z, (const float*)ptrs[Q_B1], hidden}, st);
  if (err) return err;
  if (need_w) {  // dW2 = gelu(z1)^T g and db2 = sum g, while z holds z1
    err = weight_grad(GeluT{z, hidden}, g, hidden, c_out, n_px, splits_w2, part_w,
                      (float*)ptrs[Q_DW2], st);
    if (!err && ptrs[Q_DB2])
      err = column_sums(g, n_px, c_out, sum_run, (float*)ptrs[Q_PART_DB2], (float*)ptrs[Q_DB2],
                        st);
    if (err) return err;
  }
  // 3. dz1 = (g @ W2^T) * gelu'(z1) over z (W2^T's K-major form is W2)
  err = gemm_tf32x3_run<128>(F32Matrix<float>{g, c_out}, w2k, w2k + w2k_half,
                             c_out_pad, n_px, hidden, c_out, 1, rps, DzStore{z, hidden}, st);
  if (err) return err;
  if (need_w) {  // dW1 = [xa | skip]^T dz1 and db1 = sum dz1, while xg holds x_raw
    err = weight_grad(XinT{xg, ptrs[Q_SKIP], aff_a, aff_b, (int)rps, c, s, skip_bf16}, z,
                      c + s, hidden, n_px, splits_w1, part_w, (float*)ptrs[Q_DW1], st);
    if (!err)
      err = column_sums(z, n_px, hidden, sum_run, (float*)ptrs[Q_PART_DB1], (float*)ptrs[Q_DB1],
                        st);
    if (err) return err;
  }
  // 4. [dxa | dskip] = dz1 @ [W1a | W1b]^T (the K-major form of W1^T is W1);
  //    da / db partials, a * dxa over xg
  float* part_da = (float*)ptrs[Q_PART_DA];
  float* part_db = (float*)ptrs[Q_PART_DB];
  err = gemm_tf32x3_run<DX_BN>(
      F32Matrix<float>{z, hidden}, w1k, w1k + w1k_half, hidden_pad, n_px, c + s, hidden,
      1, rps, DxStore{xg, (float*)ptrs[Q_DSKIP], aff_a, part_da, part_db, c, s, (int)tiles}, st);
  if (err) return err;
  // 5. da, db: each sample's partials in runs, then the runs
  const int per = (int)((tiles + groups - 1) / groups);
  if ((long long)per * (groups - 1) >= tiles) return (int)cudaErrorInvalidValue;
  float* grp_da = (float*)ptrs[Q_GRP_DA];
  float* grp_db = (float*)ptrs[Q_GRP_DB];
  const dim3 rgrid((c + 31) / 32, (unsigned)bsz);
  tile_reduce<<<dim3(rgrid.x, rgrid.y, groups), dim3(32, 8), 0, st>>>(
      part_da, part_db, (int)tiles, per, c, grp_da, grp_db);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stats_reduce<<<rgrid, dim3(32, 8), 0, st>>>(grp_da, grp_db, groups, c, (float*)ptrs[Q_DA],
                                              (float*)ptrs[Q_DB]);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // 6. dhm = Mt^T @ (a dxa), the folded forward DFT
  return fold_launch<true, float, float>(ptrs[Q_AT_ANA], xg, (void*)ptrs[Q_DHM], bsz * h,
                                         (int)w, m, c, (int)ints[J_ANA_ROWS],
                                         (int)ints[J_ANA_COLS], st);
}
