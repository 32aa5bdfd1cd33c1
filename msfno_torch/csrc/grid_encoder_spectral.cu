// Fused encoder MLP + positional embedding + instance-norm statistics +
// truncated forward longitude DFT, bf16 wgmma GEMMs (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/grid_mlp.py:grid_encoder_spectral (the
// Pallas `_grid_encoder_spectral_call` TPU kernel).  Per pixel row of a
// latitude (b, h):
//
//   y[w] = gelu_exact(x[w] @ W1 + b1) @ W2 [+ pe[h, w]]     (fp32)
//   ssum += y, ssq += y*y                                    (fp32, pre-rounding)
//   f[b, h, m, :] = sum_w cs[w, m] * bf16(y[w])              (fp32 accumulation)
//
// with x, h and y rounded to bf16 before each GEMM, cs (W, 2M) the merged
// [C | -S] analysis matrix in bf16, and f rounded to the output dtype at
// the write.
//
// Bound on the H100 at the serving shapes: x (1, 721, 1440, 73) fp32 303 MB
// + pe (721, 1440, 256) bf16 531 MB + f (1, 721, 242, 256) bf16 89 MB ~0.92
// GB -> 0.28 ms; the least work folds the DFT (half the dense product's
// operations; this kernel runs it dense): 2 * 1,038,240 * (73*256 +
// 256*256) + 1,038,240 * 242*256 = 2.39e11 FLOP -> 0.24 ms at 989 TFLOP/s
// bf16: bytes, with the operations nearly as large.
//
// Design: two passes, both on wgmma.  The TPU kernel keeps a latitude row
// of y in VMEM; 227 KB of shared memory cannot hold one beside the weights,
// so y (bf16, the DFT's operand) goes through device memory: 531 MB written
// and read back, ~0.32 ms of bytes, for a pass-2 GEMM that streams its
// operand once per block instead of once per 64 pixels.
//
// 1. Encoder MLP (enc_mlp, persistent): a tile is 128 consecutive pixels of
//    one sample (chain_gemm.cuh; the last tile of a sample is ragged).  The
//    tile's x is one contiguous run (128 x 73 x 4 B = 37 KB at the serving
//    shapes): each row half comes through the TMA ring as one bulk copy and
//    is converted by its two consumer warpgroups to the bf16 A tile (K = 73
//    -> 80).  Layer 1 (73 -> 256) on wgmma; its epilogue adds b1,
//    applies the exact GELU and writes bf16 h over x in the A tile.  Layer
//    2 (256 -> 256) on wgmma; W1 and W2 stream through the same ring.  The
//    tile's pe (bf16) comes by TMA into 64 KB of its own while the GEMMs
//    run; layer 2's epilogue adds it (y = h W2 + pe in fp32), takes the fp32
//    column sums of y and y^2 over each warp's 16 rows (valid rows only, a
//    fixed-order shuffle tree), then over the 8 warps in order, into a (B,
//    tiles, C) array (through its pe boxes once they are read), and writes
//    bf16 y over h, stored to a (B, H*W, C) scratch by TMA (the ragged edge
//    is clipped).  Two small kernels (tile_common.cuh's tile_reduce, then
//    stats_reduce) add each sample's partials in a fixed
//    order: deterministic, no atomics.
// 2. Forward DFT: dft_tiles.cuh's analysis_wgmma (the dft_analysis kernel's
//    bf16 path) on the bf16 y, whose 64 x 64 boxes TMA writes as the wgmma
//    B operand itself (DIRECT), writing f in the output dtype.
//
// Measured on the H100 (tools/kernel_variants.py --profile): the DFT pass
// took 0.39 ms converting raw slabs, 0.28 ms with DIRECT.  Pass 1 runs at
// 2.6x its byte bound: its epilogues' CUDA-core work (the GELU of 32K
// values a tile, the statistics, the conversions) and its two GEMMs take
// turns within a block.
//
// Tunables (tools/kernel_variants.py): ENC_STAGES (ring depth of pass 1),
// ENC_DFT_STAGES (ring depth of pass 2; 0 fills 192 KB).
//
// fp32 operands (the "float32" and "tensorfloat" knobs):
// grid_encoder_spectral_f32, nothing rounded before f.  Also two passes: the
// encoder MLP of mlp_f32.cuh on the split-precision core (mlp_tf32x3_run
// with statistics: two gemm_tf32x3 launches, fp32-class products as three
// TF32 tensor-core passes over hi / lo splits, B the prepared halves of W1^T
// and W2^T, h through device memory; the first GEMM's A x's rows, the
// second's epilogue OutStats adding pe and writing the statistics' tile
// partials; then the fixed-order reduces) writes fp32 y, and the fp32
// forward DFT of dft_analysis (dft_tiles.cuh:fold_rows, the even/odd fold:
// half the dense multiply-adds) reads it.  x's 73-wide rows are first
// copied into rows of 76 (pad_rows): the first GEMM's loader then reads A
// by 16-byte loads, and took 0.87 ms against 1.90 with four scalar loads a
// quad on the H100 (the copy: 0.20).  Bound on the H100: 2.39e11 FLOP (the
// DFT folded) at 165 TFLOP/s (an fp32-class product's least time on this
// card), 1.45 ms.  y's round trip, 2 x 1.06 GB, is ~0.64 ms at the HBM
// rate, and h's the same.

#include "chain_gemm.cuh"
#include "dft_tiles.cuh"
#include "mlp_f32.cuh"

namespace {

#ifndef ENC_STAGES_OVERRIDE
#define ENC_STAGES_OVERRIDE 3
#endif
#ifndef ENC_DFT_STAGES_OVERRIDE
#define ENC_DFT_STAGES_OVERRIDE 0
#endif
constexpr int ENC_STAGES = ENC_STAGES_OVERRIDE;
constexpr int ENC_SLOT = 4 * CH_BOX;        // 32 KB: the B boxes of N <= 256
constexpr int ENC_TILE = 4 * CH_CHUNK;      // 64 KB: x (K <= 256), then h, then y
constexpr int ENC_PE_HALF = 4 * CH_BOX;     // 32 KB: a warpgroup's 64 rows of bf16 pe
constexpr int ENC_SMEM = 1024 + ENC_TILE + 2 * ENC_PE_HALF + ENC_STAGES * ENC_SLOT +
                         256 * 4 + (2 * ENC_STAGES + 2) * 8;
static_assert(ENC_SMEM <= 232448, "pass 1 does not fit in shared memory");

struct EncArgs {
  const void* x;        // (B, hw, c_in)
  const float* b1;      // (hidden,)
  const void* pe;       // (hw, c) or null
  float* part_sum;      // (B, tiles, c): each tile's column sums
  float* part_sq;
  long long hw;         // pixels per sample
  int c_in, k1p, hidden, c, tiles, bsz;
};

enum PeMode { PE_NONE = 0, PE_BF16 = 1, PE_F32 = 2 };  // bf16 pe comes by TMA

template <typename IN_T, int PE>
CH_KERNEL
    enc_mlp(const __grid_constant__ CUtensorMap w1_map,
            const __grid_constant__ CUtensorMap w2_map,
            const __grid_constant__ CUtensorMap pe_map,
            const __grid_constant__ CUtensorMap y_map, EncArgs a) {
  extern __shared__ char smem_raw[];
  char* tile = smem_base_1024(smem_raw);
  char* pe_s = tile + ENC_TILE;
  float* b1_s = reinterpret_cast<float*>(pe_s + 2 * ENC_PE_HALF + ENC_STAGES * ENC_SLOT);
  uint64_t* bars = reinterpret_cast<uint64_t*>(b1_s + 256);
  const Ring ring{pe_s + 2 * ENC_PE_HALF, bars, bars + ENC_STAGES, ENC_SLOT, ENC_STAGES};
  uint64_t* pe_full = bars + 2 * ENC_STAGES;  // a tile's pe has landed
  uint64_t* pe_free = pe_full + 1;            // every consumer warp is done with it
  const int n1 = (a.k1p + CH_BK - 1) / CH_BK, n2 = (a.hidden + CH_BK - 1) / CH_BK;
  const int n_tiles = a.tiles * a.bsz;
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
      prefetch_map(&y_map);
      if (PE == PE_BF16) prefetch_map(&pe_map);
    }
    // per tile, ring stages: the raw x of the two row halves, W1's, then
    // (after the tile's pe) W2's
    int s = 0;
    for (int tl = blockIdx.x, it = 0; tl < n_tiles; tl += gridDim.x, ++it) {
      const long long p0 = (long long)(tl % a.tiles) * CH_BM;
      const int n_valid = (int)min((long long)CH_BM, a.hw - p0);
      const IN_T* xsrc =
          reinterpret_cast<const IN_T*>(a.x) + ((long long)(tl / a.tiles) * a.hw + p0) * a.c_in;
      for (int j = 0; j < 2 + n1 + n2; ++j, ++s) {
        if (PE == PE_BF16 && j == 2 + n1) {  // the tile's pe, zeros past the sample's end
          if (it > 0) mbar_wait(pe_free, (it - 1) & 1);
          if (lane == 0) {
            const int halves = n_valid > 64 ? 2 : 1, boxes = (a.c + 63) / 64;
            mbar_expect_tx(pe_full, halves * boxes * CH_BOX);
            for (int h = 0; h < halves; ++h)
              for (int k = 0; k < boxes; ++k)
                tma_load_2d(pe_s + h * ENC_PE_HALF + k * CH_BOX, &pe_map, pe_full, 64 * k,
                            (int)(p0 + 64 * h));
          }
        }
        char* sb = ring_acquire(ring, s);
        if (lane == 0) {
          uint64_t* full = ring.full + s % ring.stages;
          if (j < 2) {
            load_raw(ring, s, sb, xsrc + 64 * j * a.c_in, min(64, n_valid - 64 * j),
                     a.c_in * (int)sizeof(IN_T));
          } else {
            const bool l1 = j < 2 + n1;
            const int n = l1 ? a.hidden : a.c;
            load_b_boxes(sb, l1 ? &w1_map : &w2_map, full, n,
                         CH_BK * (l1 ? j - 2 : j - 2 - n1), -1);
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
  const int lane = threadIdx.x % 32;
  for (int i = threadIdx.x; i < a.hidden; i += CH_CONSUMERS) b1_s[i] = a.b1[i];
  auto a_tile = [&](int j, char*) { return tile + j * CH_CHUNK; };
  auto gelu_b1 = [b1_s](float v, int col) { return gelu_rational(v + b1_s[col]); };
  const bool h_cols = 128 * ro.n < a.hidden, y_cols = 128 * ro.n < a.c;
  const char* my_pe = pe_s + ro.m * ENC_PE_HALF;
  const int r0 = acc_row0();  // the warpgroup's rows r0 and r0 + 8
  float acc[64];
  int s = 0;
  for (int tl = blockIdx.x, it = 0; tl < n_tiles; tl += gridDim.x, ++it) {
    const int ti = tl % a.tiles, b = tl / a.tiles;
    const long long p0 = (long long)ti * CH_BM;
    const int n_valid = (int)min((long long)CH_BM, a.hw - p0);
    const IN_T* xsrc = reinterpret_cast<const IN_T*>(a.x) + ((long long)b * a.hw + p0) * a.c_in;
    s = raw_to_a_tile<IN_T>(ring, s, ro, xsrc + 64 * ro.m * a.c_in,
                            min(64, n_valid - 64 * ro.m), a.c_in, tile, 0);
    // finite A past k1p and hidden (chain_gemm runs whole stages)
    zero_cols(tile, 64 * ro.m, a.k1p, round_up(a.k1p, CH_BK), ro.n * 128 + ro.t, 256);
    fence_proxy_async();
    consumers_sync();  // the A tile's x (and, the first time, b1 in shared memory)

    // layer 1, then h = bf16(gelu(x W1 + b1)) over x
    s = chain_gemm(acc, ring, s, a.k1p, a_tile, ro, h_cols);
    pair_sync(ro);  // the pair's layer-1 wgmmas have read x
    if (h_cols) frag_to_a_tile(acc, tile, 64 * ro.m, 128 * ro.n, a.hidden, gelu_b1);
    zero_cols(tile, 64 * ro.m, a.hidden, round_up(a.hidden, CH_BK), ro.n * 128 + ro.t, 256);
    fence_proxy_async();
    pair_sync(ro);

    // layer 2: y = h W2 + pe; column sums of the fp32 y over the valid rows,
    // bf16 y over h
    s = chain_gemm(acc, ring, s, a.hidden, a_tile, ro, y_cols);
    pair_sync(ro);  // the pair's layer-2 wgmmas have read h
    if (PE == PE_BF16) mbar_wait(pe_full, it & 1);
    // this warp's column sums over its 16 rows: after the shuffle tree every
    // lane holds its column pair's; lane l keeps those of q = l / 4 + 8 i
    float keep[2][4];
    if (y_cols) {
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const int col = 128 * ro.n + acc_col(q, 0);
        const bool col_ok = col < a.c;
        float y[4];  // rows r0, r0 + 8; columns col, col + 1
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          // bf16 pe past the valid rows and columns is not used
          float2 pe = make_float2(0.f, 0.f);
          if (PE == PE_BF16)
            pe = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(my_pe + box_offset(row, col)));
          else if (PE == PE_F32 && col_ok && 64 * ro.m + row < n_valid)
            pe = *reinterpret_cast<const float2*>(reinterpret_cast<const float*>(a.pe) +
                                                  (p0 + 64 * ro.m + row) * a.c + col);
          y[2 * h] = acc[4 * q + 2 * h] + pe.x;
          y[2 * h + 1] = acc[4 * q + 2 * h + 1] + pe.y;
        }
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
        if (col_ok) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<__nv_bfloat162*>(
                tile + a_tile_offset(64 * ro.m + r0 + 8 * h, col)) =
                __floats2bfloat162_rn(y[2 * h], y[2 * h + 1]);
        }
      }
    }
    fence_proxy_async();
    wg_sync(ro);  // the warpgroup is done with its pe
    // the warpgroup's bf16 y: its two 64 x 64 boxes, clipped at the edges
    const bool store = ro.t == 0 && y_cols && p0 + 64 * ro.m < a.hw;
    if (store) {
      for (int j = 2 * ro.n; j < min(2 * ro.n + 2, (a.c + 63) / 64); ++j)
        tma_store_3d(&y_map, tile + j * CH_CHUNK + ro.m * 8192, 64 * j, (int)(p0 + 64 * ro.m),
                     b);
      bulk_commit();
    }
    // the warps' sums over the warpgroup's pe boxes, (4 warps, 2, 128)
    float* wpart = reinterpret_cast<float*>(pe_s + ro.m * ENC_PE_HALF + ro.n * 2 * CH_BOX);
    if (y_cols) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int cl = 8 * (8 * i + lane / 4) + 2 * (lane % 4);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          wpart[(2 * ro.w) * 128 + cl + e] = keep[i][e];
          wpart[(2 * ro.w + 1) * 128 + cl + e] = keep[i][2 + e];
        }
      }
    }
    consumers_sync();
    // the tile's column sums: the 8 row warps (4 m + w) in order
    for (int col = threadIdx.x; col < a.c; col += CH_CONSUMERS) {
      float ps = 0.f, pq = 0.f;
      for (int r = 0; r < 8; ++r) {
        const float* src = reinterpret_cast<const float*>(pe_s + (r / 4) * ENC_PE_HALF +
                                                          (col / 128) * 2 * CH_BOX) +
                           (r % 4) * 256 + col % 128;
        ps += src[0];
        pq += src[128];
      }
      const long long o = ((long long)b * a.tiles + ti) * a.c + col;
      a.part_sum[o] = ps;
      a.part_sq[o] = pq;
    }
    fence_proxy_async();  // before TMA overwrites the partials with the next tile's pe
    __syncwarp();
    if (PE == PE_BF16 && lane == 0) mbar_arrive(pe_free);
    if (store) bulk_wait_read();
    consumers_sync();  // the A tile takes the next tile's x
  }
}

template <typename IN_T, int PE>
int launch_enc_mlp(const void* w1, const void* w2, void* y, EncArgs a, int bsz,
                   cudaStream_t stream) {
  CUtensorMap w1_map, w2_map, pe_map, y_map;
  memset(&pe_map, 0, sizeof(pe_map));
  int err = bf16_map(&w1_map, w1, a.k1p, a.hidden, a.hidden, CH_BK, 64);
  if (!err) err = bf16_map(&w2_map, w2, a.hidden, a.c, a.c, CH_BK, 64);
  if (!err) err = bf16_map(&y_map, y, (int)a.hw, a.c, a.c, 64, 64, bsz);
  if (!err && PE == PE_BF16) err = bf16_map(&pe_map, a.pe, (int)a.hw, a.c, a.c, 64, 64);
  if (err) return err;
  static bool smem_set = false;  // once per kernel
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        enc_mlp<IN_T, PE>, cudaFuncAttributeMaxDynamicSharedMemorySize, ENC_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  // persistent: one block per SM walks the tiles
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = min((long long)bsz * a.tiles, (long long)max(sms, 1));
  enc_mlp<IN_T, PE><<<(unsigned)blocks, CH_THREADS, ENC_SMEM, stream>>>(w1_map, w2_map, pe_map,
                                                                       y_map, a);
  return (int)cudaGetLastError();
}

template <typename IN_T>
int launch_enc(int pe, const void* w1, const void* w2, void* y, const EncArgs& a, int bsz,
               cudaStream_t stream) {
  return pe == PE_BF16  ? launch_enc_mlp<IN_T, PE_BF16>(w1, w2, y, a, bsz, stream)
         : pe == PE_F32 ? launch_enc_mlp<IN_T, PE_F32>(w1, w2, y, a, bsz, stream)
                        : launch_enc_mlp<IN_T, PE_NONE>(w1, w2, y, a, bsz, stream);
}

// the first GEMM's A, x's padded rows: F32Matrix under a name of its own,
// so that a profile tells the head's first GEMM from the tail's
struct EncRows : F32Matrix<float> {};

enum Ptr { P_X, P_W1, P_B1, P_W2, P_PE, P_CST, P_Y, P_F, P_PART_SUM, P_PART_SQ, P_GRP_SUM,
           P_GRP_SQ, P_SSUM, P_SSQ, N_PTRS };
enum Int { I_B, I_H, I_W, I_C_IN, I_K1P, I_HIDDEN, I_C, I_TWO_M, I_CST_ROWS, I_CST_COLS,
           I_X_BF16, I_PE_BF16, I_F_BF16, I_GROUPS, N_INTS };

}  // namespace

// The tiles that shape the prepared DFT operand (those of dft_analysis:
// 2: BF16_K, 3: BF16_TILE).
extern "C" int grid_encoder_spectral_tile(int i) { return dft_tile(i); }

// ptrs and ints follow the Ptr and Int enums above: y is the (B, H*W, c)
// bf16 scratch, part_sum/part_sq hold B * tiles * c floats (tiles =
// ceil(H*W / 128)), grp_sum/grp_sq B * groups * c (the partials are added
// in `groups` runs of ceil(tiles / groups)), cst is the (cst_rows,
// cst_cols) bf16 DFT operand [C | -S]^T of dft_analysis.
extern "C" int grid_encoder_spectral_bf16(const void* const* ptrs, const long long* ints,
                                          void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  EncArgs a;
  a.x = ptrs[P_X];
  a.b1 = (const float*)ptrs[P_B1];
  a.pe = ptrs[P_PE];
  a.part_sum = (float*)ptrs[P_PART_SUM];
  a.part_sq = (float*)ptrs[P_PART_SQ];
  const long long bsz = ints[I_B], h = ints[I_H], w = ints[I_W];
  a.hw = h * w;
  a.c_in = (int)ints[I_C_IN];
  a.k1p = (int)ints[I_K1P];
  a.hidden = (int)ints[I_HIDDEN];
  a.c = (int)ints[I_C];
  const int two_m = (int)ints[I_TWO_M];
  if (bsz < 1 || bsz > 65535 || h < 1 || w < 1 || a.hw > INT_MAX || a.c_in < 1 ||
      a.k1p < a.c_in || a.k1p % 16 || a.k1p > 4 * CH_BK || a.hidden < 16 || a.hidden % 16 ||
      a.hidden > 256 || a.c < 16 || a.c % 16 || a.c > 256 || two_m < 2 || two_m % 2)
    return (int)cudaErrorInvalidValue;
  a.tiles = (int)((a.hw + CH_BM - 1) / CH_BM);
  a.bsz = (int)bsz;
  void* y = (void*)ptrs[P_Y];
  const int pe = a.pe == nullptr ? PE_NONE : ints[I_PE_BF16] ? PE_BF16 : PE_F32;
  int err = ints[I_X_BF16]
                ? launch_enc<__nv_bfloat16>(pe, ptrs[P_W1], ptrs[P_W2], y, a, (int)bsz, st)
                : launch_enc<float>(pe, ptrs[P_W1], ptrs[P_W2], y, a, (int)bsz, st);
  if (err) return err;
  const int rows = (int)(bsz * h), cr = (int)ints[I_CST_ROWS], cc = (int)ints[I_CST_COLS];
  using bf = __nv_bfloat16;
  err = ints[I_F_BF16]
            ? launch_analysis_direct<bf, ENC_DFT_STAGES_OVERRIDE>(
                  ptrs[P_CST], y, (bf*)ptrs[P_F], rows, (int)w, two_m / 2, a.c, cr, cc, nullptr,
                  1, st)
            : launch_analysis_direct<float, ENC_DFT_STAGES_OVERRIDE>(
                  ptrs[P_CST], y, (float*)ptrs[P_F], rows, (int)w, two_m / 2, a.c, cr, cc,
                  nullptr, 1, st);
  if (err) return err;
  // the tiles' partials, added in runs, then the runs
  const int n_part = a.tiles;
  const int groups = (int)ints[I_GROUPS], per = (n_part + groups - 1) / groups;
  if (groups < 1 || (long long)per * (groups - 1) >= n_part) return (int)cudaErrorInvalidValue;
  float* grp_sum = (float*)ptrs[P_GRP_SUM];
  float* grp_sq = (float*)ptrs[P_GRP_SQ];
  dim3 rgrid((a.c + 31) / 32, (unsigned)bsz);
  tile_reduce<<<dim3(rgrid.x, rgrid.y, groups), dim3(32, 8), 0, st>>>(
      a.part_sum, a.part_sq, n_part, per, a.c, grp_sum, grp_sq);
  if ((err = (int)cudaGetLastError())) return err;
  stats_reduce<<<rgrid, dim3(32, 8), 0, st>>>(grp_sum, grp_sq, groups, a.c,
                                              (float*)ptrs[P_SSUM], (float*)ptrs[P_SSQ]);
  return (int)cudaGetLastError();
}

// The fp32-operand head.  ptrs and ints begin with the encoder MLP's
// MlpPtr / MlpInt layouts (mlp_f32.cuh: out is the (B, H*W, c) fp32 y
// scratch, with statistics); then ptrs: the fp32 fold operand of
// dft_analysis.prepare (at_rows, at_cols), f (B, H, 2M, c), and for fp32 x
// whose width c_in is no multiple of 4 an fp32 scratch (B*H*W, c_in
// rounded up to 4) for x's padded rows, else null; ints: B, H, W, the
// modes M, at_rows, at_cols, f_bf16.
extern "C" int grid_encoder_spectral_f32(const void* const* ptrs, const long long* ints,
                                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const MlpF32 mlp = mlp_f32_args(ptrs, ints);
  const long long* v = ints + MLP_INTS;
  const long long bsz = v[0], h = v[1], w = v[2];
  const int m = (int)v[3], at_rows = (int)v[4], at_cols = (int)v[5];
  if (bsz < 1 || h < 1 || w < 2 || m < 1 || mlp.out_bf16 || mlp.samples != bsz ||
      mlp.rps != h * w || !mlp.part_sum || mlp.skip || mlp.aff_a || mlp.b2 || mlp.res)
    return (int)cudaErrorInvalidValue;
  int err;
  float* xp = (float*)ptrs[MLP_PTRS + 2];
  if (xp) {  // fp32 x of a width that is no multiple of 4: 16-byte rows first
    if (mlp.x_bf16) return (int)cudaErrorInvalidValue;
    const int ld = (mlp.c_main + 3) / 4 * 4;
    err = pad_rows_launch<EncRows>(mlp.x, 0, mlp.samples * mlp.rps, mlp.c_main, ld, xp, st);
    if (!err) err = mlp_tf32x3_run<128, true>(EncRows{{xp, ld}}, ld, mlp, st);
  } else {
    const MlpInput in{mlp.x, nullptr, nullptr, nullptr, mlp.c_main, 0, mlp.x_bf16, 0};
    err = mlp_tf32x3_run<128, true>(in, mlp.c_main, mlp, st);
  }
  if (err) return err;
  const void* at = ptrs[MLP_PTRS];
  void* f = (void*)ptrs[MLP_PTRS + 1];
  return v[6] ? fold_launch<true, float, __nv_bfloat16>(at, mlp.out, f, bsz * h, (int)w, m,
                                                        mlp.c_out, at_rows, at_cols, st)
              : fold_launch<true, float, float>(at, mlp.out, f, bsz * h, (int)w, m, mlp.c_out,
                                                at_rows, at_cols, st);
}
