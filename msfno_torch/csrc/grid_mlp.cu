// Pointwise two-layer grid MLP with fused epilogues, bf16 wgmma GEMMs
// (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/grid_mlp.py:grid_mlp (the Pallas
// `_grid_mlp_call` TPU kernel, also reached through `_grid_mlp_with_stats`).
// Per pixel row:
//
//   u = A_s * x + B_s                  (optional per-sample channel affine, fp32)
//   h = gelu_exact(u @ W1a [+ skip @ W1b] + b1)
//   y = h @ W2 [+ b2] [+ pe[row % pe_rows]] [+ res]
//   out = round(y, out dtype);  optionally per-sample sum(y), sum(y*y)
//
// with u, the skip, W1, W2 and h rounded to bf16 before their GEMMs.  One
// kernel covers the call sites of the serving step: the encoder (73 -> 256
// -> 256, + pe, + stats; unfused path), the inner block MLPs (256 -> 512 ->
// 256, + b2; with fuse_inner_mlp also the affine and the residual) and the
// big-skip decoder (256 + 73 -> 256 -> 73; unfused path).
//
// Bound on the H100: the encoder and decoder move ~1.37 GB and ~1.14 GB for
// ~1.7e11 FLOP each: bytes (~0.41 and ~0.34 ms at 3.35 TB/s); the inner MLP
// 28,800 x (256 x 512 x 2) x 2 = 1.5e10 FLOP (0.015 ms at 989 TFLOP/s) on
// 30 MB: operations.  The hidden activation never leaves the chip.
//
// Design: the head's encoder-MLP pass (grid_encoder_spectral.cu) without the
// DFT, on chain_gemm.cuh.  A persistent block per SM walks tiles of 128
// consecutive rows of one sample (the last one ragged); four consumer
// warpgroups own m64n128 accumulators and one producer warp streams, through
// one ring of 32 KB stages, each tile's raw rows (x and the skip, each row
// half as one bulk copy) and the weights W1 and W2 as 64 x 64 MN-major
// boxes.  The raw rows enter the bf16 A tile through rows_to_a_tile (the
// affine applied in fp32 before the rounding, where the TPU kernel applies
// it).  The first GEMM's epilogue adds b1, applies the exact GELU
// (gelu_rational) and writes bf16 h into the A tile; the second GEMM's adds
// b2, pe and the residual in fp32, takes the statistics and writes y back
// into the A tile: bf16 y of a width that is a multiple of 8 into the row
// half's rows in the A tile's layout, stored by TMA as 64 x 64 boxes
// (OUT_BOX, as the head stores its y); any other y, once every warpgroup is
// done with the A tile, as the tile's dense rows, copied out as one
// contiguous run of 16-byte stores (OUT_ROWS_F32 / _BF16, as the tail stores
// its output).  Storing each accumulator fragment straight to device memory
// instead took 1.3 of the encoder site's 3.0 ms on the H100 (4-byte stores
// scattered over 8 rows: many partial-sector L2 writes); dense rows staged
// in each row half's share of the A tile took the decoder site 2.2 ms
// against 1.06 with no epilogue.  The output mode, the statistics and the
// TMA pe are template parameters: with them as runtime flags the epilogue
// spilled (380 bytes) and ran 2.2 ms of the encoder site's 3.0.
//   Hidden widths above 256 (the inner MLP's 512) exceed one chained GEMM's
//   N: the first GEMM runs in two passes of N <= 256 over x in K-chunks 0-3,
//   the first writing h[:, :256] into chunks 4-7, the second h[:, 256:]
//   over x once its wgmmas have read it; the second GEMM reads h's K-chunks
//   in order from chunks 4-7, then 0-3 (8 chunks, 128 KB: the ring then fits
//   2 stages of 32 KB, the smem budget below).
//   The encoder's bf16 pe comes by TMA into 64 KB of its own while the
//   GEMMs run, as in the head; other pe and the residual are read in the
//   epilogue.  The statistics: each warp's column sums over its 16 rows (a
//   fixed shuffle tree, valid rows only), then over the tile's 8 row warps
//   in order, into a (samples, tiles, C) array, added in a fixed order by
//   tile_reduce and stats_reduce (tile_common.cuh): deterministic.
//   An output width of at most 128 (the decoder's 73, padded to 80) runs
//   the second GEMM on m64n64 accumulators, so both warpgroups of a row
//   half share it and its epilogue (NARROW: the decoder site 1.19 ms on the
//   H100, against 1.64 with one m64n128 warpgroup a row half).
//
// Tunables (tools/kernel_variants.py): GM_STAGES (the most ring stages; as
// many as fit below it: 4 left the encoder and decoder sites within 1% of 3).
//
// fp32 operands (the "float32" and "tensorfloat" knobs): grid_mlp_f32, every
// option of the bf16 kernel with fp32-class products, as mlp_f32.cuh's
// mlp_tf32x3_run: two gemm_tf32x3 launches (three TF32 tensor-core passes
// over hi / lo splits; B the prepared halves of W1^T and W2^T) with h
// through device memory.  The first GEMM's A is GmInput: x's rows, then
// the skip's, each as 16-byte loads of fp32 rows whose width is a multiple
// of 4 (x and the skip as stored where they are such rows, else copied
// into them by pad_rows first: the encoder's 73-wide x, the decoder's
// 73-wide skip, a bf16 input; W1^T's rows are laid out to match,
// grid_mlp.py:prepare_weights), the affine applied once a quad is loaded.
// The second GEMM's epilogue adds one table (b2, pe or the residual; the
// host adds them into one where a call has more) and writes y (OutStore,
// on 80-column tiles for C_out <= 80), with statistics also the tiles'
// partials (OutStats, fp32 y) and the fixed-order reduces.  Bound on the
// H100 at 165 TFLOP/s (an fp32-class product's least time on this card):
// the inner MLP 1.51e10 FLOP, 0.092 ms; encoder 1.75e11, 1.06 ms; decoder
// 2.14e11, 1.30 ms: operations.

#include "chain_gemm.cuh"
#include "mlp_f32.cuh"

namespace {

#ifndef GM_STAGES_OVERRIDE
#define GM_STAGES_OVERRIDE 3
#endif
constexpr int GM_MAX_STAGES = GM_STAGES_OVERRIDE;
constexpr int GM_SLOT = 4 * CH_BOX;     // 32 KB: the B boxes of N <= 256
constexpr int GM_HALF = 256;            // the first GEMM's N a pass
constexpr int GM_PE_HALF = 4 * CH_BOX;  // 32 KB: a row half's bf16 pe (c_out <= 256)
constexpr int GM_SMEM_MAX = 232448;

enum PeMode { PE_NONE = 0, PE_TMA = 1, PE_LOAD = 2 };
enum OutMode { OUT_BOX = 0, OUT_ROWS_F32 = 1, OUT_ROWS_BF16 = 2 };

struct MlpArgs {
  const void* x;         // (samples * rps, c_main)
  const void* skip;      // (samples * rps, c_skip) or null
  const float* aff_a;    // (samples, c_main) or null
  const float* aff_b;
  const float* b1;       // (hidden,)
  const float* b2;       // (c_out,) or null
  const void* pe;        // (pe_rows, c_out) or null
  const void* res;       // (samples * rps, c_out) or null
  void* out;             // (samples * rps, c_out)
  float* part_sum;       // (samples, tiles, c_out), or null: no statistics
  float* part_sq;
  long long rps;         // rows per sample
  long long pe_rows;
  int c_main, c_skip, cmp, k1p, hidden, c_out, n2p, tiles, samples;
  int x_bf16, skip_bf16, pe_mode, pe_bf16, res_bf16, out_bf16;
  int a_chunks, stages;  // the A tile's K-chunks, the ring's depth
};

// the dynamic shared memory: the A tile, the pe buffer (PE_TMA), the ring,
// b1 and b2, the barriers; 1024 bytes of slack for the alignment
__host__ __device__ inline int mlp_smem(const MlpArgs& a) {
  return 1024 + a.a_chunks * CH_CHUNK + (a.pe_mode == PE_TMA ? 2 * GM_PE_HALF : 0) +
         a.stages * GM_SLOT + 4 * (a.hidden + (a.b2 ? a.n2p : 0)) + (2 * a.stages + 2) * 8;
}
// Budget at the serving sites: inner 8 chunks (128 KB) + 2 stages (64 KB) +
// b1, b2 (3 KB) = 196 KB (a third stage would need 233,536 bytes);
// encoder 4 chunks + pe 64 KB + 3 stages + b1 = 226 KB; decoder 6 chunks
// (x and the skip: K = 336) + 3 stages + b1 = 194 KB.
static_assert(1024 + 8 * CH_CHUNK + 2 * GM_SLOT + 4 * (512 + 256) + 6 * 8 <= GM_SMEM_MAX,
              "the inner MLP's tile and two ring stages do not fit");
static_assert(1024 + 4 * CH_CHUNK + 2 * GM_PE_HALF + 3 * GM_SLOT + 4 * 256 + 8 * 8 <=
                  GM_SMEM_MAX,
              "the encoder's tile, pe and three ring stages do not fit");

template <typename T>
__device__ __forceinline__ T to_out(float v) {
  if constexpr (sizeof(T) == 2) return __float2bfloat16_rn(v);
  else return v;
}

// Raw rows of type bf16 (is_bf16) or fp32 through raw_to_a_tile
__device__ __forceinline__ int raw_rows(const Ring& r, int s, const Role& ro, int is_bf16,
                                        const void* base, long long row0, int n_rows,
                                        int width, char* tile, int k_off, const float* aa,
                                        const float* ab) {
  if (is_bf16)
    return raw_to_a_tile<__nv_bfloat16>(
        r, s, ro, reinterpret_cast<const __nv_bfloat16*>(base) + row0 * width, n_rows, width,
        tile, k_off, aa, ab);
  return raw_to_a_tile<float>(r, s, ro, reinterpret_cast<const float*>(base) + row0 * width,
                              n_rows, width, tile, k_off, aa, ab);
}

template <int OUT, bool STATS, bool PE_SMEM, bool NARROW>
CH_KERNEL mlp_tiles(const __grid_constant__ CUtensorMap w1_map,
                    const __grid_constant__ CUtensorMap w2_map,
                    const __grid_constant__ CUtensorMap pe_map,
                    const __grid_constant__ CUtensorMap out_map, MlpArgs a) {
  extern __shared__ char smem_raw[];
  constexpr bool pe_tma = PE_SMEM;
  char* tile = smem_base_1024(smem_raw);
  char* pe_s = tile + a.a_chunks * CH_CHUNK;
  char* slots = pe_s + (pe_tma ? 2 * GM_PE_HALF : 0);
  float* b1_s = reinterpret_cast<float*>(slots + a.stages * GM_SLOT);
  float* b2_s = a.b2 ? b1_s + a.hidden : nullptr;
  uint64_t* bars = reinterpret_cast<uint64_t*>(b1_s + a.hidden + (a.b2 ? a.n2p : 0));
  const Ring ring{slots, bars, bars + a.stages, GM_SLOT, a.stages};
  uint64_t* pe_full = bars + 2 * a.stages;  // a tile's pe has landed
  uint64_t* pe_free = pe_full + 1;          // every consumer warp is done with it
  const int h0 = min(a.hidden, GM_HALF), h1 = a.hidden - h0;  // the first GEMM's passes
  const int n1 = (a.k1p + CH_BK - 1) / CH_BK, n2 = (a.hidden + CH_BK - 1) / CH_BK;
  const int n_tiles = a.tiles * a.samples;
  if (threadIdx.x == 0) {
    ring_init(ring);
    mbar_init(pe_full, 1);
    mbar_init(pe_free, CH_CONSUMERS / 32);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= CH_CONSUMERS) {  // the producer warpgroup: one warp works
    producer_regs();
    if (threadIdx.x >= CH_CONSUMERS + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      prefetch_map(&w1_map);
      prefetch_map(&w2_map);
      if (pe_tma) prefetch_map(&pe_map);
      if (OUT == OUT_BOX) prefetch_map(&out_map);
    }
    // per tile, ring stages: the raw x of the two row halves, the skip's,
    // W1's (a pass of columns at a time), then (after the tile's pe) W2's
    int s = 0;
    for (int tl = blockIdx.x, it = 0; tl < n_tiles; tl += gridDim.x, ++it) {
      const long long p0 = (long long)(tl % a.tiles) * CH_BM;
      const int n_valid = (int)min((long long)CH_BM, a.rps - p0);
      const long long g0 = (long long)(tl / a.tiles) * a.rps + p0;
      auto next = [&](auto&& fill) {
        char* sb = ring_acquire(ring, s);
        if (lane == 0) fill(sb, ring.full + s % ring.stages);
        __syncwarp();
        ++s;
      };
      const int x_row = a.c_main * (a.x_bf16 ? 2 : 4);
      const int s_row = a.c_skip * (a.skip_bf16 ? 2 : 4);
      for (int h = 0; h < 2; ++h)
        next([&](char* sb, uint64_t*) {
          load_raw(ring, s, sb, reinterpret_cast<const char*>(a.x) + (g0 + 64 * h) * x_row,
                   min(64, n_valid - 64 * h), x_row);
        });
      if (a.skip)
        for (int h = 0; h < 2; ++h)
          next([&](char* sb, uint64_t*) {
            load_raw(ring, s, sb,
                     reinterpret_cast<const char*>(a.skip) + (g0 + 64 * h) * s_row,
                     min(64, n_valid - 64 * h), s_row);
          });
      for (int pass = 0; pass < (h1 > 0 ? 2 : 1); ++pass)
        for (int j = 0; j < n1; ++j)
          next([&](char* sb, uint64_t* full) {
            load_b_boxes(sb, &w1_map, full, pass ? h1 : h0, CH_BK * j, -1, pass * GM_HALF);
          });
      if (pe_tma) {  // the tile's pe, zeros past the table's end
        if (it > 0) mbar_wait(pe_free, (it - 1) & 1);
        if (lane == 0) {
          const int halves = n_valid > 64 ? 2 : 1, boxes = (a.c_out + 63) / 64;
          mbar_expect_tx(pe_full, halves * boxes * CH_BOX);
          for (int h = 0; h < halves; ++h)
            for (int k = 0; k < boxes; ++k)
              tma_load_2d(pe_s + h * GM_PE_HALF + k * CH_BOX, &pe_map, pe_full, 64 * k,
                          (int)(p0 + 64 * h));
        }
        __syncwarp();
      }
      for (int j = 0; j < n2; ++j)
        next([&](char* sb, uint64_t* full) {
          load_b_boxes(sb, &w2_map, full, a.n2p, CH_BK * j, -1);
        });
    }
    return;
  }

  // consumers: warpgroup (m, n) owns tile rows [64 m, 64 m + 64) and columns
  // [128 n, 128 n + 128)
  consumer_regs();
  const Role ro;
  const int lane = threadIdx.x % 32, tid = ro.n * 128 + ro.t;
  for (int i = threadIdx.x; i < a.hidden; i += CH_CONSUMERS) b1_s[i] = a.b1[i];
  if (b2_s)
    for (int i = threadIdx.x; i < a.n2p; i += CH_CONSUMERS)
      b2_s[i] = i < a.c_out ? a.b2[i] : 0.f;
  consumers_sync();
  auto a_tile = [&](int j, char*) { return tile + j * CH_CHUNK; };
  // the second GEMM's K-chunk j of h: with two passes h[:, :256] is in
  // chunks 4-7 and h[:, 256:] in chunks 0-3
  auto h_tile = [&](int j, char*) { return tile + (h1 > 0 ? (j + 4) % 8 : j) * CH_CHUNK; };
  const int h0_col = h1 > 0 ? GM_HALF : 0;  // where h[:, :256] goes in the A tile
  auto gelu_h0 = [b1_s, h0_col](float v, int col) {
    return gelu_rational(v + b1_s[col - h0_col]);
  };
  auto gelu_h1 = [b1_s](float v, int col) { return gelu_rational(v + b1_s[GM_HALF + col]); };
  const char* my_pe = pe_s + ro.m * GM_PE_HALF;
  const int r0 = acc_row0();  // the warpgroup's rows r0 and r0 + 8
  float acc[64];
  // the second GEMM: a warpgroup's m64n128 accumulator, or with NARROW (N <=
  // 128) the m64n64 first half of it, so both warpgroups of a row half work
  constexpr int QN = NARROW ? 8 : 16, COLS = 8 * QN;
  float(&acc2)[4 * QN] = *reinterpret_cast<float(*)[4 * QN]>(&acc[0]);
  const bool y_cols = COLS * ro.n < a.n2p;
  int s = 0;
  for (int tl = blockIdx.x, it = 0; tl < n_tiles; tl += gridDim.x, ++it) {
    const int smp = tl / a.tiles, ti = tl % a.tiles;
    const long long p0 = (long long)ti * CH_BM;
    const int n_valid = (int)min((long long)CH_BM, a.rps - p0);
    const long long g0 = (long long)smp * a.rps + p0;
    const int my_rows = min(64, n_valid - 64 * ro.m);
    const float* aa = a.aff_a ? a.aff_a + (long long)smp * a.c_main : nullptr;
    const float* ab = a.aff_a ? a.aff_b + (long long)smp * a.c_main : nullptr;
    s = raw_rows(ring, s, ro, a.x_bf16, a.x, g0 + 64 * ro.m, my_rows, a.c_main, tile, 0, aa,
                 ab);
    if (a.skip)
      s = raw_rows(ring, s, ro, a.skip_bf16, a.skip, g0 + 64 * ro.m, my_rows, a.c_skip, tile,
                   a.cmp, nullptr, nullptr);
    // finite A past k1p (chain_gemm runs whole stages)
    zero_cols(tile, 64 * ro.m, a.k1p, round_up(a.k1p, CH_BK), tid, 256);
    fence_proxy_async();
    pair_sync(ro);

    // the first GEMM: h = bf16(gelu(u W1 + b1)), in passes of N <= 256
    s = chain_gemm(acc, ring, s, a.k1p, a_tile, ro, 128 * ro.n < h0);
    if (h1 > 0) {
      // h[:, :256] into chunks 4-7, clear of x, which the second pass reads
      if (128 * ro.n < h0) frag_to_a_tile(acc, tile, 64 * ro.m, h0_col + 128 * ro.n,
                                          h0_col + h0, gelu_h0);
      s = chain_gemm(acc, ring, s, a.k1p, a_tile, ro, 128 * ro.n < h1);
      pair_sync(ro);  // the pair's wgmmas have read x
      if (128 * ro.n < h1) frag_to_a_tile(acc, tile, 64 * ro.m, 128 * ro.n, h1, gelu_h1);
      zero_cols(tile, 64 * ro.m, h1, round_up(h1, CH_BK), tid, 256);
    } else {
      pair_sync(ro);  // the pair's wgmmas have read x
      if (128 * ro.n < h0) frag_to_a_tile(acc, tile, 64 * ro.m, 128 * ro.n, h0, gelu_h0);
      zero_cols(tile, 64 * ro.m, h0, round_up(h0, CH_BK), tid, 256);
    }
    fence_proxy_async();
    pair_sync(ro);

    // the second GEMM: y = h W2 + b2 + pe + res in fp32 (the plain
    // version's order), the statistics of the valid rows, y into the pair's
    // rows of the A tile
    s = chain_gemm(acc2, ring, s, a.hidden, h_tile, ro, y_cols);
    if (OUT == OUT_BOX) pair_sync(ro);  // the pair's wgmmas have read h
    else consumers_sync();              // every warpgroup's wgmmas have read the A tile
    using OutT = typename std::conditional<OUT == OUT_ROWS_F32, float, __nv_bfloat16>::type;
    OutT* ys = reinterpret_cast<OutT*>(tile);  // OUT_ROWS: the tile's y as dense rows
    if (pe_tma) mbar_wait(pe_full, it & 1);
    float keep[QN / 8][4];  // lane l keeps the column sums of q = l / 4 + 8 i
    if (y_cols) {
#pragma unroll
      for (int q = 0; q < QN; ++q) {
        const int col = COLS * ro.n + acc_col(q, 0);
        const bool c0 = col < a.c_out, c1 = col + 1 < a.c_out;
        float y[4];  // rows r0, r0 + 8; columns col, col + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + 8 * h, row = 64 * ro.m + r;
          const bool rv = row < n_valid;
          float y0 = acc2[4 * q + 2 * h], y1 = acc2[4 * q + 2 * h + 1];
          if (b2_s) {
            y0 += b2_s[col];
            y1 += b2_s[col + 1];
          }
          if (pe_tma) {
            // bf16 pe past the valid rows and columns is not used
            const float2 pv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(my_pe + box_offset(r, col)));
            y0 += pv.x;
            y1 += pv.y;
          } else if (a.pe && rv) {
            const long long pr = ((g0 + row) % a.pe_rows) * a.c_out + col;
            if (c0) y0 += load_act(a.pe, pr, a.pe_bf16);
            if (c1) y1 += load_act(a.pe, pr + 1, a.pe_bf16);
          }
          if (a.res && rv) {
            const long long o = (g0 + row) * a.c_out + col;
            if (c0) y0 += load_act(a.res, o, a.res_bf16);
            if (c1) y1 += load_act(a.res, o + 1, a.res_bf16);
          }
          y[2 * h] = y0;
          y[2 * h + 1] = y1;
          if (OUT == OUT_BOX) {
            if (c0)  // c_out % 8 == 0: the pair is whole
              *reinterpret_cast<__nv_bfloat162*>(tile + a_tile_offset(row, col)) =
                  __floats2bfloat162_rn(y0, y1);
          } else {
            if (c0) ys[row * a.c_out + col] = to_out<OutT>(y0);
            if (c1) ys[row * a.c_out + col + 1] = to_out<OutT>(y1);
          }
        }
        if (STATS) {  // this warp's column sums over its 16 rows
          const bool v0 = 64 * ro.m + r0 < n_valid, v1 = 64 * ro.m + r0 + 8 < n_valid;
          float st[4] = {(v0 ? y[0] : 0.f) + (v1 ? y[2] : 0.f),
                         (v0 ? y[1] : 0.f) + (v1 ? y[3] : 0.f),
                         (v0 ? y[0] * y[0] : 0.f) + (v1 ? y[2] * y[2] : 0.f),
                         (v0 ? y[1] * y[1] : 0.f) + (v1 ? y[3] * y[3] : 0.f)};
#pragma unroll
          for (int sh = 4; sh < 32; sh *= 2)
#pragma unroll
            for (int e = 0; e < 4; ++e) st[e] += __shfl_xor_sync(0xffffffffu, st[e], sh);
          if (q % 8 == lane / 4) {
#pragma unroll
            for (int e = 0; e < 4; ++e) keep[q / 8][e] = st[e];
          }
        }
      }
    }
    if (pe_tma) {
      __syncwarp();
      if (lane == 0) mbar_arrive(pe_free);  // the next tile's pe may come
    }
    // y out of the A tile
    bool store = false;
    if (OUT == OUT_BOX) {
      // the warpgroup's 64 x 64 boxes, clipped at the sample's end
      fence_proxy_async();
      wg_sync(ro);
      store = ro.t == 0 && y_cols && my_rows > 0;
      if (store) {
        for (int j = COLS / 64 * ro.n; j < min(COLS / 64 * (ro.n + 1), (a.c_out + 63) / 64); ++j)
          tma_store_3d(&out_map, tile + j * CH_CHUNK + ro.m * 8192, 64 * j,
                       (int)(p0 + 64 * ro.m), smp);
        bulk_commit();
      }
    } else {
      // the tile's valid rows, one contiguous run
      consumers_sync();
      const int bytes = n_valid * a.c_out * (int)sizeof(OutT);
      char* dst = reinterpret_cast<char*>(a.out) + g0 * a.c_out * (long long)sizeof(OutT);
      const char* src = reinterpret_cast<const char*>(ys);
      const int vec = reinterpret_cast<uintptr_t>(dst) % 16 == 0 ? bytes / 16 : 0;
      for (int u = threadIdx.x; u < vec; u += CH_CONSUMERS)
        reinterpret_cast<uint4*>(dst)[u] = reinterpret_cast<const uint4*>(src)[u];
      for (int e = 16 * vec / (int)sizeof(OutT) + threadIdx.x; e < bytes / (int)sizeof(OutT);
           e += CH_CONSUMERS)
        reinterpret_cast<OutT*>(dst)[e] = ys[e];
      consumers_sync();
    }
    if (store) bulk_wait_read();  // the TMA store has read the tile
    pair_sync(ro);                // the pair is done with its rows of the A tile
    if (STATS) {
      // the warps' sums, (4 warps, 2, 256 columns) a row half, over the
      // pair's rows of K-chunk 0
      float* wpart = reinterpret_cast<float*>(tile + ro.m * 8192);
      if (y_cols) {
#pragma unroll
        for (int i = 0; i < QN / 8; ++i) {
          const int col = COLS * ro.n + 8 * (8 * i + lane / 4) + 2 * (lane % 4);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            wpart[(2 * ro.w) * 256 + col + e] = keep[i][e];
            wpart[(2 * ro.w + 1) * 256 + col + e] = keep[i][2 + e];
          }
        }
      }
      consumers_sync();
      // the tile's column sums: the 8 row warps (4 m + w) in order
      for (int col = threadIdx.x; col < a.c_out; col += CH_CONSUMERS) {
        float ps = 0.f, pq = 0.f;
        for (int r = 0; r < 8; ++r) {
          const float* src = reinterpret_cast<const float*>(tile + (r / 4) * 8192) +
                             (r % 4) * 512 + col;
          ps += src[0];
          pq += src[256];
        }
        const long long o = ((long long)smp * a.tiles + ti) * a.c_out + col;
        a.part_sum[o] = ps;
        a.part_sq[o] = pq;
      }
      consumers_sync();  // the A tile takes the next tile's x
    }
  }
}

template <int OUT, bool STATS, bool PE_SMEM, bool NARROW>
int launch_mode(const CUtensorMap* maps, const MlpArgs& a, cudaStream_t stream) {
  const int smem = mlp_smem(a);
  static int smem_set = 0;  // the largest size set so far, per kernel
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        mlp_tiles<OUT, STATS, PE_SMEM, NARROW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  // persistent: one block per SM walks the tiles
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = min((long long)a.tiles * a.samples, (long long)max(sms, 1));
  mlp_tiles<OUT, STATS, PE_SMEM, NARROW><<<(unsigned)blocks, CH_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], a);
  return (int)cudaGetLastError();
}

template <int OUT, bool NARROW>
int launch_narrow(const CUtensorMap* maps, const MlpArgs& a, cudaStream_t stream) {
  const bool stats = a.part_sum != nullptr, pe_tma = a.pe_mode == PE_TMA;
  return stats ? (pe_tma ? launch_mode<OUT, true, true, NARROW>(maps, a, stream)
                         : launch_mode<OUT, true, false, NARROW>(maps, a, stream))
               : (pe_tma ? launch_mode<OUT, false, true, NARROW>(maps, a, stream)
                         : launch_mode<OUT, false, false, NARROW>(maps, a, stream));
}

template <int OUT>
int launch_tiles(const CUtensorMap* maps, const MlpArgs& a, cudaStream_t stream) {
  return a.n2p <= 128 ? launch_narrow<OUT, true>(maps, a, stream)
                      : launch_narrow<OUT, false>(maps, a, stream);
}

// grid_mlp's first GEMM's A on fp32 operands: row m is x's row (lx fp32
// wide, its first c_main columns x's channels, with AFF the affine applied
// to them), then with SKIP the skip's (ls wide); lx and ls multiples of 4
// and both 16-byte aligned, so that K = lx + ls comes in whole quads, each
// one 16-byte load from one of the two.  (With the dtype and the alignment
// of each input decided per quad, GEMM 1 took 1.31 ms at the encoder site
// on the H100, against 0.89 for the head's same rows: an input that is not
// such rows is copied into them first.  With AFF and SKIP runtime choices
// it took 1.04, 0.91 as template parameters; the decoder's 3.02 against
// 2.93.)
template <bool AFF, bool SKIP>
struct GmInput {
  const float* x;
  const float* skip;
  const float* aff_a;  // (samples, c_main) or null
  const float* aff_b;
  int c_main, lx, ls;
  // raw elements (m, k .. k + 3), k a multiple of 4: a load only (with the
  // skip, the matrix and its row width chosen by k alone, the same for the
  // 8 rows a loader thread fetches at once)
  __device__ __forceinline__ float4 quad(long long m, long long k, int) const {
    if constexpr (!SKIP) {
      return __ldg(reinterpret_cast<const float4*>(x + m * lx + k));
    } else {
      const bool main = k < lx;
      const float* p = main ? x + k : skip + (k - lx);
      return __ldg(reinterpret_cast<const float4*>(p + m * (main ? lx : ls)));
    }
  }
  // the affine on a quad's main channels
  __device__ __forceinline__ float4 finish(float4 v, long long k, int seg) const {
    if (!AFF || k >= c_main) return v;
    float r[4] = {v.x, v.y, v.z, v.w};
    const long long i = (long long)seg * c_main + k;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (k + e < c_main) r[e] = fmaf(__ldg(aff_a + i + e), r[e], __ldg(aff_b + i + e));
    return make_float4(r[0], r[1], r[2], r[3]);
  }
  // element (m, k) (gemm_tf32x3 reads whole quads here: K = lx + ls)
  __device__ __forceinline__ float operator()(long long m, long long k, int seg) const {
    const float v = !SKIP || k < lx ? x[m * lx + k] : skip[m * ls + k - lx];
    if (!AFF || k >= c_main) return v;
    const long long i = (long long)seg * c_main + k;
    return fmaf(aff_a[i], v, aff_b[i]);
  }
};

// grid_mlp's h as the second GEMM's A: F32Matrix under a name of its own,
// so that a profile tells grid_mlp's second GEMM from the head's and the
// tail's; and the name of grid_mlp's copies into 16-byte rows
// (pad_rows<GmRows>)
struct GmHidden : F32Matrix<float> {};
struct GmRows {};

// the two GEMMs and the statistics' reduces, A = GmInput<AFF, SKIP> over x
// and the skip as 16-byte rows
template <bool AFF, bool SKIP>
int gm_run(const MlpF32& a, const float* x, const float* skip, int lx, int ls, cudaStream_t st) {
  const GmInput<AFF, SKIP> in{x, skip, a.aff_a, a.aff_b, a.c_main, lx, ls};
  if (a.part_sum) return mlp_tf32x3_run<128, true, GmHidden>(in, lx + ls, a, st);
  return a.c_out <= TAIL_OUT_BN ? mlp_tf32x3_run<TAIL_OUT_BN, false, GmHidden>(in, lx + ls, a, st)
                                : mlp_tf32x3_run<128, false, GmHidden>(in, lx + ls, a, st);
}

enum Ptr { P_X, P_SKIP, P_AFF_A, P_AFF_B, P_W1, P_B1, P_W2, P_B2, P_PE, P_RES, P_OUT,
           P_PART_SUM, P_PART_SQ, P_GRP_SUM, P_GRP_SQ, P_SSUM, P_SSQ, N_PTRS };
enum Int { I_SAMPLES, I_ROWS_PER_SAMPLE, I_PE_ROWS, I_C_MAIN, I_C_SKIP, I_CMP, I_K1P,
           I_HIDDEN, I_C_OUT, I_N2P, I_X_BF16, I_SKIP_BF16, I_PE_BF16, I_RES_BF16,
           I_OUT_BF16, I_GROUPS, N_INTS };

}  // namespace

// ptrs and ints follow the Ptr and Int enums above.  Null skip, aff_a /
// aff_b, b2, pe, res: not used; null part_sum: no statistics, else
// part_sum/part_sq hold samples * tiles * c_out floats and grp_sum/grp_sq
// samples * groups * c_out (the partials are added in `groups` runs of
// ceil(tiles / groups)).  w1: (k1p, hidden) bf16, the main rows padded to
// cmp, then the skip rows; w2: (hidden, n2p) bf16, zero columns past c_out.
extern "C" int grid_mlp_bf16(const void* const* ptrs, const long long* ints, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  MlpArgs a;
  a.x = ptrs[P_X];
  a.skip = ptrs[P_SKIP];
  a.aff_a = (const float*)ptrs[P_AFF_A];
  a.aff_b = (const float*)ptrs[P_AFF_B];
  a.b1 = (const float*)ptrs[P_B1];
  a.b2 = (const float*)ptrs[P_B2];
  a.pe = ptrs[P_PE];
  a.res = ptrs[P_RES];
  a.out = (void*)ptrs[P_OUT];
  a.part_sum = (float*)ptrs[P_PART_SUM];
  a.part_sq = (float*)ptrs[P_PART_SQ];
  a.samples = (int)ints[I_SAMPLES];
  a.rps = ints[I_ROWS_PER_SAMPLE];
  a.pe_rows = ints[I_PE_ROWS] > 0 ? ints[I_PE_ROWS] : 1;
  a.c_main = (int)ints[I_C_MAIN];
  a.c_skip = (int)ints[I_C_SKIP];
  a.cmp = (int)ints[I_CMP];
  a.k1p = (int)ints[I_K1P];
  a.hidden = (int)ints[I_HIDDEN];
  a.c_out = (int)ints[I_C_OUT];
  a.n2p = (int)ints[I_N2P];
  a.x_bf16 = (int)ints[I_X_BF16];
  a.skip_bf16 = (int)ints[I_SKIP_BF16];
  a.pe_bf16 = (int)ints[I_PE_BF16];
  a.res_bf16 = (int)ints[I_RES_BF16];
  a.out_bf16 = (int)ints[I_OUT_BF16];
  if (a.samples < 1 || a.rps < 1 || a.rps > INT_MAX || a.c_main < 1 || a.cmp < a.c_main ||
      a.cmp % 16 || (a.skip && a.c_skip < 1) || a.k1p < a.cmp + (a.skip ? a.c_skip : 0) ||
      a.k1p % 16 || a.hidden < 16 || a.hidden % 16 || a.hidden > 2 * GM_HALF ||
      (a.hidden > GM_HALF && a.k1p > GM_HALF) || a.k1p > 7 * CH_BK || a.c_out < 1 ||
      a.n2p < a.c_out || a.n2p % 16 || a.n2p > 256)
    return (int)cudaErrorInvalidValue;
  a.tiles = (int)((a.rps + CH_BM - 1) / CH_BM);
  if ((long long)a.tiles * a.samples > INT_MAX) return (int)cudaErrorInvalidValue;
  // bf16 pe whose table is the sample (each tile's rows one run of it) comes
  // by TMA
  a.pe_mode = a.pe == nullptr ? PE_NONE
              : a.pe_bf16 && a.pe_rows == a.rps && a.c_out % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(a.pe) % 16 == 0
                  ? PE_TMA
                  : PE_LOAD;
  // bf16 y of a width that is a multiple of 8 goes out by TMA, any other as
  // dense rows (which must fit the A tile)
  const bool box = a.out_bf16 && a.c_out % 8 == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const int nx = (a.k1p + CH_BK - 1) / CH_BK;
  const int out_bytes = CH_BM * a.c_out * (a.out_bf16 ? 2 : 4);  // OUT_ROWS: the tile's y
  const int out_chunks = box ? (a.c_out + 63) / 64 : (out_bytes + CH_CHUNK - 1) / CH_CHUNK;
  a.a_chunks = a.hidden > GM_HALF ? 8 : max(nx, (a.hidden + CH_BK - 1) / CH_BK);
  a.a_chunks = max(a.a_chunks, out_chunks);
  for (a.stages = GM_MAX_STAGES; a.stages > 2 && mlp_smem(a) > GM_SMEM_MAX; --a.stages) {
  }
  if (a.stages < 2 || mlp_smem(a) > GM_SMEM_MAX) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  memset(&maps[2], 0, 2 * sizeof(maps[2]));
  int err = bf16_map(&maps[0], ptrs[P_W1], a.k1p, a.hidden, a.hidden, CH_BK, 64);
  if (!err) err = bf16_map(&maps[1], ptrs[P_W2], a.hidden, a.n2p, a.n2p, CH_BK, 64);
  if (!err && a.pe_mode == PE_TMA)
    err = bf16_map(&maps[2], a.pe, (int)a.pe_rows, a.c_out, a.c_out, 64, 64);
  if (!err && box)
    err = bf16_map(&maps[3], a.out, (int)a.rps, a.c_out, a.c_out, 64, 64, a.samples);
  if (err) return err;
  err = box ? launch_tiles<OUT_BOX>(maps, a, st)
      : a.out_bf16 ? launch_tiles<OUT_ROWS_BF16>(maps, a, st)
                   : launch_tiles<OUT_ROWS_F32>(maps, a, st);
  if (err || !a.part_sum) return err;
  // the tiles' partials, added in runs, then the runs
  const int groups = (int)ints[I_GROUPS], per = (a.tiles + groups - 1) / groups;
  if (groups < 1 || (long long)per * (groups - 1) >= a.tiles) return (int)cudaErrorInvalidValue;
  float* grp_sum = (float*)ptrs[P_GRP_SUM];
  float* grp_sq = (float*)ptrs[P_GRP_SQ];
  dim3 rgrid((a.c_out + 31) / 32, (unsigned)a.samples);
  tile_reduce<<<dim3(rgrid.x, rgrid.y, groups), dim3(32, 8), 0, st>>>(
      a.part_sum, a.part_sq, a.tiles, per, a.c_out, grp_sum, grp_sq);
  if ((err = (int)cudaGetLastError())) return err;
  stats_reduce<<<rgrid, dim3(32, 8), 0, st>>>(grp_sum, grp_sq, groups, a.c_out,
                                              (float*)ptrs[P_SSUM], (float*)ptrs[P_SSQ]);
  return (int)cudaGetLastError();
}

// The fp32-operand MLP.  ptrs and ints begin with the MlpPtr / MlpInt
// layouts of mlp_f32.cuh (W1^T's rows: x's c_main rows, zeros to a
// multiple of 4, then the skip's c_skip rows); then ptrs: an fp32 scratch
// (rows, c_main rounded up to 4) for x's rows where x is not already such
// rows (bf16, a width that is no multiple of 4, not 16-byte aligned), else
// null, and the same (rows, c_skip rounded up to 4) for the skip's.
extern "C" int grid_mlp_f32(const void* const* ptrs, const long long* ints, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const MlpF32 a = mlp_f32_args(ptrs, ints);
  float* xp = (float*)ptrs[MLP_PTRS];
  float* sp = (float*)ptrs[MLP_PTRS + 1];
  const int lx = (a.c_main + 3) / 4 * 4, ls = (a.c_skip + 3) / 4 * 4;
  const long long rows = (long long)a.samples * a.rps;
  const auto rows16 = [](const void* p, int bf16, int c) {
    return !bf16 && c % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  if (a.c_main < 1 || a.c_skip < 0 || (a.c_skip > 0) != (a.skip != nullptr) ||
      (a.aff_a != nullptr) != (a.aff_b != nullptr) || !a.x ||
      (!xp && !rows16(a.x, a.x_bf16, a.c_main)) ||
      (a.skip && !sp && !rows16(a.skip, a.skip_bf16, a.c_skip)))
    return (int)cudaErrorInvalidValue;
  int err = 0;
  if (xp) err = pad_rows_launch<GmRows>(a.x, a.x_bf16, rows, a.c_main, lx, xp, st);
  if (!err && sp) err = pad_rows_launch<GmRows>(a.skip, a.skip_bf16, rows, a.c_skip, ls, sp, st);
  if (err) return err;
  const float* xr = xp ? xp : (const float*)a.x;
  const float* sr = sp ? sp : (const float*)a.skip;
  if (a.aff_a) return a.skip ? gm_run<true, true>(a, xr, sr, lx, ls, st)
                             : gm_run<true, false>(a, xr, sr, lx, ls, st);
  return a.skip ? gm_run<false, true>(a, xr, sr, lx, ls, st)
                : gm_run<false, false>(a, xr, sr, lx, ls, st);
}
