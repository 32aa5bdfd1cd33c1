// Row GEMMs shared by spectral_mlp.cu, spectral_mlp_bwd.cu, gcn_layer.cu,
// gcn_layer_bwd.cu and (gemm_f32, through mlp_f32.cuh) the fp32 paths of
// grid_mlp.cu, grid_encoder_spectral.cu and spectral_decoder.cu;
// gemm_tf32x3 runs the fp32 paths of spectral_mlp.cu and
// spectral_decoder_bwd.cu.
//
// wgmma_gemm: C = epi(A @ B), A (M x K) and B (K x N) bf16, row-major, fp32
// accumulation on wgmma (sm_90a).  A block owns a WGM_BM x WGM_BN tile.  A
// producer warp keeps a ring of WGM_STAGES stages in flight by TMA: the A
// tile (128 rows x 64 K, K-major, one box) and the B tile (64 K x WGM_BN,
// MN-major, boxes of 64 x 64), both in the 128-byte swizzle that wgmma
// reads.  With B_T, B is given as its (N x K) row-major transpose and read
// K-major (boxes of 128 N x 64 K, the A tile's layout): the product with a
// stored matrix's transpose needs no transposed copy.  With A_T, A is given
// as its (K x M) row-major transpose and read MN-major (boxes of 64 M x 64
// K, the B tile's layout): x^T dsup of the GCN backward needs no copy of
// x^T.  blockIdx.z splits K into ranges of k_split (a multiple of WGM_BK):
// split z writes its partial product through the epilogue, which reads
// blockIdx.z.  Two consumer warpgroups own 64 rows each and
// issue WGM_BN / 128 m64n128k16 wgmmas per K-step of 16, keeping one
// stage's wgmmas in flight while they wait for the next (a stage is
// released one stage late).  The
// epilogue functor `epi(d, row0, rows, col0)` gets each 64 x 128 fp32
// accumulator fragment in registers.  TMA fills boxes past M, N and K with
// zeros, so any shape whose rows are 16-byte multiples works.
//
// gemm_f32: epi(A @ B) in true fp32 FMA on the CUDA cores (no TF32).  A is
// a functor of (m, k) (a stored fp32 or bf16 matrix, either way round, or
// rows assembled from several inputs), B a stored fp32 or bf16 matrix,
// either way round; the epilogue functor gets each thread's 8 x 8
// accumulators (gemm_f32_launch: C = A @ B, rows optionally scaled).  A
// block owns a 128 x 128 tile of one row segment (a sample), 8 x 8 per
// thread, K in double-buffered slabs of 8 (the next slab's loads in
// registers while the current one is multiplied); blockIdx.z splits K into
// partial products.
//
// gemm_tf32x3: epi(A @ B) with fp32 operands and fp32 accumulation as three
// TF32 wgmma passes (split precision).  The least time of an fp32-class
// product on the H100 is three TF32 tensor-core passes (495 / 3 = 165
// TFLOP/s, against 67 TFLOP/s of fp32 FMA on the CUDA cores): x = hi + lo
// with hi = rna_tf32(x) and lo = rna_tf32(x - hi) (|x - hi - lo| <= 2^-22
// |x|), and a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first;
// only a_lo b_lo (< 2^-22 |a b|) is dropped, about 21 of fp32's 24
// significand bits kept.  Its contract is gemm_f32's: A a functor of (m, k,
// seg), rows in segments that no tile crosses, split z taking a range of
// K.  B is a prepared weight: the hi and lo halves of its (N x K)
// transpose, fp32 rows padded with zeros to a 16-byte multiple (tf32 wgmma
// has no transpose: both operands are read K-major).
//   Persistent: a block a multiprocessor walks output tiles of 128 rows x
// BN columns (112 or 128) with two consumer warpgroups of 64 rows each and
// a loader warpgroup.  The loader fills a ring of TF3_STAGES stages of K =
// 32 (one 128-byte swizzled row): A_hi, A_lo, B_hi, B_lo, and runs on into
// the next tile while the consumers run a tile's epilogue (the tail
// backward's passes have 3 to 11 stages a tile; as one block a tile, each
// paid its prologue and epilogue with the tensor cores idle).  B comes by
// TMA.  A comes from the loader's threads, which evaluate the functor
// (16-byte loads where the rows allow), split each value and store both
// halves K-major in the 128-byte swizzle.  A does not come by TMA: the tail
// backward assembles its A from several tensors, some 73 fp32 wide, a row
// stride TMA cannot take, and no split copy of an activation goes to
// device memory.  The functor gives `quad(m, k, seg)`, four raw values
// (loads only, so that a stage's loads are in flight together), and
// `finish(v, k, seg)`, which turns them into A's values once they are
// needed, besides its scalar call.
//   Each consumer issues, per stage, lo.hi and hi.lo of its four k8 steps,
// then their hi.hi, into an m64nBN accumulator that each stage starts
// afresh, and adds it to a second one on the CUDA cores once the stage's
// wgmmas are done.  The tensor cores add into their accumulator with
// truncation: over a K = 1024 product's 384 wgmmas into one accumulator
// that cost 1.9e-5 rel-L2 against true fp32 on the H100 (the spectral_mlp
// block); a stage of 12 wgmmas from zero, then one round-to-nearest fp32
// add, keeps the fp32 class.  The second set of accumulators is why BN
// stops at 128.  The epilogue functor gets the summed fragment (TcTile).
// Tunables: WGM_BN, WGM_STAGES (wgmma_gemm); TF3_STAGES (gemm_tf32x3).

#pragma once

#include <climits>

#include "tile_common.cuh"

namespace {

#ifndef WGM_BN_OVERRIDE
#define WGM_BN_OVERRIDE 256
#endif
#ifndef WGM_STAGES_OVERRIDE
#define WGM_STAGES_OVERRIDE 0
#endif

constexpr int WGM_BM = 128;                       // rows per block
constexpr int WGM_BN = WGM_BN_OVERRIDE;           // columns per block
constexpr int WGM_NB = WGM_BN / 128;              // m64n128 accumulators per consumer
constexpr int WGM_BK = 64;                        // K per stage: one 128-byte bf16 row
constexpr int WGM_A_BYTES = WGM_BM * WGM_BK * 2;  // 16 KB
constexpr int WGM_B_BYTES = WGM_BK * WGM_BN * 2;  // WGM_BN / 64 boxes of 8 KB
constexpr int WGM_SLOT = WGM_A_BYTES + WGM_B_BYTES;
constexpr int WGM_STAGES = WGM_STAGES_OVERRIDE ? WGM_STAGES_OVERRIDE : 200 * 1024 / WGM_SLOT;
constexpr int WGM_SMEM = 1024 + WGM_STAGES * WGM_SLOT + 2 * WGM_STAGES * 8;
constexpr int WGM_CONSUMERS = 256;                // two consumer warpgroups
constexpr int WGM_THREADS = WGM_CONSUMERS + 128;  // and a producer warpgroup (one warp works)
static_assert(WGM_BN % 128 == 0 && WGM_BN <= 256, "WGM_BN is 128 or 256");
static_assert(WGM_SMEM <= 232448, "the ring does not fit in shared memory");

// Stores a warpgroup's 64 x 128 (NACC 64) or 64 x 64 (NACC 32) accumulator
// fragment (the layout of wgmma_m64n128k16 / m64n64k16): element (r, c), c
// = col0 + fragment column, goes to
// lo[(row0 + r) * ld + c] for c < split, else hi[(row0 + r) * ld + c - split],
// for r < n_rows and c < n_cols.  With `vec` (ld, split and n_cols multiples
// of 4, 16-byte aligned fp32 or 8-byte aligned bf16 rows) lane pairs trade
// halves so that each thread writes 4 consecutive columns as one vector.
template <typename OUT_T, int NACC>
__device__ __forceinline__ void store_acc(const float (&d)[NACC], OUT_T* lo, OUT_T* hi,
                                          int split, long long ld, long long row0, int n_rows,
                                          int col0, int n_cols, bool vec) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;
  const bool odd = lane & 1;
#pragma unroll
  for (int q = 0; q < NACC / 4; ++q) {
    const float* dq = d + 4 * q;
    if (vec) {
      // even lanes: row r0, odd lanes: row r0 + 8; 4 channels each
      const float s0 = odd ? dq[0] : dq[2], s1 = odd ? dq[1] : dq[3];
      const float g0 = __shfl_xor_sync(0xffffffffu, s0, 1);
      const float g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      float v[4] = {dq[0], dq[1], g0, g1};
      if (odd) {
        v[0] = g0; v[1] = g1; v[2] = dq[2]; v[3] = dq[3];
      }
      const int row = r0 + (odd ? 8 : 0);
      const int col = col0 + 8 * q + 4 * ((lane % 4) / 2);
      if (row >= n_rows || col >= n_cols) continue;
      OUT_T* p = col < split ? lo + (row0 + row) * ld + col : hi + (row0 + row) * ld + (col - split);
      if constexpr (sizeof(OUT_T) == 4) {
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
        alignas(8) __nv_bfloat16 packed[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) packed[j] = __float2bfloat16_rn(v[j]);
        *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(packed);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + 8 * (e / 2);
        const int col = col0 + 8 * q + 2 * (lane % 4) + (e % 2);
        if (row >= n_rows || col >= n_cols) continue;
        OUT_T* p = col < split ? lo + (row0 + row) * ld + col
                               : hi + (row0 + row) * ld + (col - split);
        if constexpr (sizeof(OUT_T) == 4) *p = dq[e];
        else *p = __float2bfloat16_rn(dq[e]);
      }
    }
  }
}

// the fragment's rows of this thread: r0 (d[4q + e], e < 2) and r0 + 8
__device__ __forceinline__ int acc_row0() {
  const int t = threadIdx.x % 128;
  return 16 * (t / 32) + (t % 32) / 4;
}
// the fragment's column of d[4q + 2h + e]
__device__ __forceinline__ int acc_col(int q, int e) {
  return 8 * q + 2 * (threadIdx.x % 4) + e;
}

// The consumer warpgroups of wgmma_gemm: warpgroup g owns rows [m0 + 64 g,
// m0 + 64 g + 64) of the tile; hands each accumulator fragment to `epi`.
template <bool B_T, bool A_T, class Epi>
__device__ __forceinline__ void consume(char* smem, uint64_t* full, uint64_t* empty, int m,
                                        int n, int n_k, int m0, int n0, int warp, int lane,
                                        const Epi& epi) {
  reg_alloc<232>();
  const int g = warp / 4;
  float acc[WGM_NB][64];
#pragma unroll
  for (int i = 0; i < WGM_NB; ++i)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[i][j] = 0.f;
  for (int s = 0; s < n_k; ++s) {
    const int slot = s % WGM_STAGES;
    char* sb = smem + slot * WGM_SLOT;
    mbar_wait(full + slot, (s / WGM_STAGES) & 1);
    wgmma_fence();
#pragma unroll
    for (int i = 0; i < WGM_NB; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int ks = 0; ks < WGM_BK / 16; ++ks) {
      const uint64_t da = A_T ? wgmma_desc(sb + g * 8192 + ks * 2048, 8192, 1024)
                              : wgmma_desc(sb + g * 8192 + ks * 32, 16, 1024);
#pragma unroll
      for (int i = 0; i < WGM_NB; ++i) {
        const uint64_t db =
            B_T ? wgmma_desc(sb + WGM_A_BYTES + i * 16384 + ks * 32, 16, 1024)
                : wgmma_desc(sb + WGM_A_BYTES + 2 * i * 8192 + ks * 2048, 8192, 1024);
        wgmma_m64n128k16<B_T ? 0 : 1, A_T ? 1 : 0>(acc[i], da, db, (s > 0 || ks > 0) ? 1 : 0);
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's wgmmas are done: release its slot
#pragma unroll
    for (int i = 0; i < WGM_NB; ++i) fence_operand(acc[i]);
    if (s > 0 && lane == 0) mbar_arrive(empty + (s - 1) % WGM_STAGES);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < WGM_NB; ++i) fence_operand(acc[i]);
  const long long row0 = (long long)m0 + 64 * g;
  const int rows = (int)min(64LL, (long long)m - row0);
  if (rows <= 0) return;
#pragma unroll
  for (int i = 0; i < WGM_NB; ++i)
    if (n0 + 128 * i < n) epi(acc[i], row0, rows, n0 + 128 * i);
}

template <class Epi, bool B_T, bool A_T>
__global__ void __launch_bounds__(WGM_THREADS, 1)
    wgmma_gemm(const __grid_constant__ CUtensorMap a_map,
               const __grid_constant__ CUtensorMap b_map, int m, int n, int k, int k_split,
               Epi epi) {
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + WGM_STAGES * WGM_SLOT);
  uint64_t* empty = full + WGM_STAGES;
  const int n0 = blockIdx.x * WGM_BN;
  const int m0 = blockIdx.y * WGM_BM;
  const int k0 = blockIdx.z * k_split;  // this split's K range: [k0, k0 + k_split)
  const int n_k = (max(min(k_split, k - k0), 0) + WGM_BK - 1) / WGM_BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < WGM_STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, WGM_CONSUMERS / 32);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= WGM_CONSUMERS / 32) {  // the producer warpgroup
    reg_dealloc<40>();
    if (warp == WGM_CONSUMERS / 32) {
      for (int s = 0; s < n_k; ++s) {
        const int slot = s % WGM_STAGES;
        char* sb = smem + slot * WGM_SLOT;
        if (s >= WGM_STAGES) mbar_wait(empty + slot, (s / WGM_STAGES - 1) & 1);
        if (lane == 0) {
          mbar_expect_tx(full + slot, WGM_SLOT);
          const int kk = k0 + s * WGM_BK;
          if (A_T) {
            tma_load_2d(sb, &a_map, full + slot, m0, kk);
            tma_load_2d(sb + 8192, &a_map, full + slot, m0 + 64, kk);
          } else {
            tma_load_2d(sb, &a_map, full + slot, kk, m0);
          }
          if (B_T) {
#pragma unroll
            for (int b = 0; b < WGM_BN / 128; ++b)
              tma_load_2d(sb + WGM_A_BYTES + b * 16384, &b_map, full + slot, kk, n0 + 128 * b);
          } else {
#pragma unroll
            for (int b = 0; b < WGM_BN / 64; ++b)
              tma_load_2d(sb + WGM_A_BYTES + b * 8192, &b_map, full + slot, n0 + 64 * b, kk);
          }
        }
        __syncwarp();
      }
    }
  } else {
    consume<B_T, A_T>(smem, full, empty, m, n, n_k, m0, n0, warp, lane, epi);
  }
}

// C = epi(A @ B): a (m x k, leading dimension lda; with A_T its transpose,
// k x m), b (k x n, ldb; with B_T its transpose, n x k), bf16, 16-byte
// aligned, lda and ldb multiples of 8.  `splits` > 1 splits K into that
// many ranges of whole stages (blockIdx.z; a split past the end writes
// zeros).  Returns a CUDA error code.
template <class Epi, bool B_T = false, bool A_T = false>
int wgmma_gemm_launch(const void* a, long long lda, const void* b, long long ldb, int m, int n,
                      int k, const Epi& epi, cudaStream_t stream, int splits = 1) {
  if (m < 1 || n < 1 || k < 1 || lda % 8 || ldb % 8 || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16 || (m + WGM_BM - 1) / WGM_BM > 65535 || splits < 1 ||
      splits > 65535)
    return (int)cudaErrorInvalidValue;
  const int k_split = ((k + splits - 1) / splits + WGM_BK - 1) / WGM_BK * WGM_BK;
  CUtensorMap a_map, b_map;
  const uint64_t a_dims[2] = {(uint64_t)(A_T ? m : k), (uint64_t)(A_T ? k : m)};
  const uint64_t a_strides[1] = {(uint64_t)lda * 2};
  const uint32_t a_box[2] = {A_T ? 64u : (uint32_t)WGM_BK, A_T ? (uint32_t)WGM_BK : WGM_BM};
  int err = make_tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, a_dims, a_strides,
                            a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const uint64_t b_dims[2] = {(uint64_t)(B_T ? k : n), (uint64_t)(B_T ? n : k)};
  const uint64_t b_strides[1] = {(uint64_t)ldb * 2};
  const uint32_t b_box[2] = {B_T ? (uint32_t)WGM_BK : 64u, B_T ? 128u : (uint32_t)WGM_BK};
  err = make_tensor_map(&b_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, b_dims, b_strides, b_box,
                        CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  static bool smem_set = false;  // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(wgmma_gemm<Epi, B_T, A_T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               WGM_SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 grid((n + WGM_BN - 1) / WGM_BN, (m + WGM_BM - 1) / WGM_BM, splits);
  wgmma_gemm<Epi, B_T, A_T><<<grid, WGM_THREADS, WGM_SMEM, stream>>>(a_map, b_map, m, n, k,
                                                                     k_split, epi);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32 FMA GEMM

// two blocks per SM: one (255 registers, no spill) ran 27% slower on the
// H100 at the generator's 512 -> 512 layer (tools/kernel_variants.py)
constexpr int F32_BM = 128, F32_BN = 128, F32_BK = 8, F32_THREADS = 256, F32_MINB = 2;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// A's element (m, k) from a stored matrix of T: row-major (m, k), or with
// A_T its (K x M) transpose, rows of ld elements.  gemm_f32's A operand is
// any functor `a(m, k, seg)` (seg: the block's row segment).
template <bool A_T, typename T>
struct F32Matrix {
  const T* p;
  long long ld;
  __device__ __forceinline__ float operator()(long long m, long long k, int) const {
    return to_float(__ldg(A_T ? p + k * ld + m : p + m * ld + k));
  }
  // elements (m, k .. k + 3), k a multiple of 4 (gemm_tf32x3's loader): one
  // 16-byte load where the rows are 16-byte aligned fp32 rows; `finish`
  // turns a quad into A's values (here: as it is)
  __device__ __forceinline__ float4 quad(long long m, long long k, int seg) const {
    if constexpr (!A_T && std::is_same<T, float>::value) {
      if ((ld & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0)
        return __ldg(reinterpret_cast<const float4*>(p + m * ld + k));
    }
    const F32Matrix& a = *this;
    return make_float4(a(m, k, seg), a(m, k + 1, seg), a(m, k + 2, seg), a(m, k + 3, seg));
  }
  __device__ __forceinline__ float4 finish(float4 v, long long, int) const { return v; }
};

// A block's output tile: rows [m0, m_end) of row segment `seg` (its tile
// `tile`), columns [n0, n0 + F32_BN), K split z.  Thread (ty, tx) holds
// acc[i][j] for row m0 + row(i) and column n0 + col(j).
struct F32Tile {
  int m0, m_end, n0, seg, tile, z, ty, tx;
  __device__ __forceinline__ int row(int i) const { return i < 4 ? ty * 4 + i : 60 + ty * 4 + i; }
  __device__ __forceinline__ int col(int j) const { return 64 * (j / 4) + tx * 4 + j % 4; }
};

// The plain epilogue: acc to C + z M ldc (split z's partial product), each
// row m multiplied by row_scale[m] (fp32 or bf16, rs_bf16) when given
struct F32Store {
  float* C;
  long long ldc, M;
  int N;
  const void* row_scale;
  int rs_bf16;
  __device__ __forceinline__ void operator()(const float (&acc)[8][8], const F32Tile& t) const {
    float* out = C + (long long)t.z * M * ldc;
    const bool vec = ldc % 4 == 0 && reinterpret_cast<uintptr_t>(C) % 16 == 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const long long m = t.m0 + t.row(i);
      if (m >= t.m_end) continue;
      float sc = 1.f;
      if (row_scale) sc = load_act(row_scale, m, rs_bf16);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = t.n0 + t.col(4 * h);
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = row_scale ? acc[i][4 * h + j] * sc : acc[i][4 * h + j];
        float* p = out + m * ldc + n;
        if (vec && n + 3 < N) {
          *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (n + j < N) p[j] = v[j];
        }
      }
    }
  }
};

// epi(A @ B) with A (M x K) given by the functor `a` and B (K x N, ldb;
// B_T: its (N x K) transpose) of TB.  The rows fall into segments of
// seg_rows each (samples); a block's tile never crosses a segment's end,
// so an epilogue can reduce over a tile of one sample.  A_T chooses
// the threads' load pattern (k fastest, or m fastest, for a transposed
// A).  blockIdx.x walks (row tile, column tile), columns fastest, so the
// blocks of one row tile run side by side and share its rows in L2; split
// z of blockIdx.z takes K range [z k_split, (z + 1) k_split).
template <bool A_T, bool B_T, class ALoad, typename TB, class Epi>
__global__ void __launch_bounds__(F32_THREADS, F32_MINB)
    gemm_f32(ALoad a_of, const TB* __restrict__ B, long long ldb, int N, long long K,
             long long k_split, int seg_rows, int seg_tiles, int n_tiles, Epi epi) {
  __shared__ __align__(16) float as[2][F32_BK][F32_BM];
  __shared__ __align__(16) float bs[2][F32_BK][F32_BN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  // 32-bit row indices (the launcher checks M), and only m0, seg and the
  // tile's valid rows live through the K loop (the epilogue's F32Tile is
  // built after it): registers are at the 128 of two blocks an SM
  const int row_tile = blockIdx.x / n_tiles;
  const int seg = row_tile / seg_tiles, tile = row_tile % seg_tiles;
  const int m0 = seg * seg_rows + tile * F32_BM;
  const int rows = min(F32_BM, (seg + 1) * seg_rows - m0);
  const int n0 = (int)(blockIdx.x % n_tiles) * F32_BN;
  const long long kb = (long long)blockIdx.z * k_split;
  const long long ke = kb + k_split < K ? kb + k_split : K;
  // this thread's 4 values of each slab: (m or n, 4 consecutive k) where K
  // is the stored rows' contiguous extent, else (k, 4 consecutive m or n)
  const int a_i = A_T ? tid / 32 : tid / 2, a_j = A_T ? (tid % 32) * 4 : (tid % 2) * 4;
  const int b_i = B_T ? tid / 2 : tid / 32, b_j = B_T ? (tid % 2) * 4 : (tid % 32) * 4;
  float ra[4], rb[4];
  auto load = [&](long long k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!A_T) {
        const long long kk = k0 + a_j + j;
        ra[j] = (a_i < rows && kk < ke) ? a_of(m0 + a_i, kk, seg) : 0.f;
      } else {
        const long long kk = k0 + a_i;
        ra[j] = (kk < ke && a_j + j < rows) ? a_of(m0 + a_j + j, kk, seg) : 0.f;
      }
      if (!B_T) {
        const long long kk = k0 + b_i;
        rb[j] = (kk < ke && n0 + b_j + j < N) ? to_float(B[kk * ldb + n0 + b_j + j]) : 0.f;
      } else {
        const long long kk = k0 + b_j + j;
        rb[j] = (n0 + b_i < N && kk < ke) ? to_float(B[(long long)(n0 + b_i) * ldb + kk]) : 0.f;
      }
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!A_T) as[buf][a_j + j][a_i] = ra[j];
      else as[buf][a_i][a_j + j] = ra[j];
      if (!B_T) bs[buf][b_i][b_j + j] = rb[j];
      else bs[buf][b_j + j][b_i] = rb[j];
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int n_slabs = ke > kb ? (int)((ke - kb + F32_BK - 1) / F32_BK) : 0;
  if (n_slabs > 0) {
    load(kb);
    store(0);
    __syncthreads();
  }
  for (int s = 0; s < n_slabs; ++s) {
    const int buf = s & 1;
    if (s + 1 < n_slabs) load(kb + (long long)(s + 1) * F32_BK);
#pragma unroll
    for (int k = 0; k < F32_BK; ++k) {
      float a[8], b[8];
      *reinterpret_cast<float4*>(a) = *reinterpret_cast<const float4*>(&as[buf][k][ty * 4]);
      *reinterpret_cast<float4*>(a + 4) =
          *reinterpret_cast<const float4*>(&as[buf][k][64 + ty * 4]);
      *reinterpret_cast<float4*>(b) = *reinterpret_cast<const float4*>(&bs[buf][k][tx * 4]);
      *reinterpret_cast<float4*>(b + 4) =
          *reinterpret_cast<const float4*>(&bs[buf][k][64 + tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (s + 1 < n_slabs) store(buf ^ 1);  // that buffer was last read a slab ago
    __syncthreads();
  }
  const F32Tile t{m0, m0 + rows, n0, seg, tile, (int)blockIdx.z, ty, tx};
  epi(acc, t);
}

// Launches gemm_f32 over m = segments * seg_rows rows (seg_rows 0: one
// segment of m rows), m < 2^31.  Returns a CUDA error code.
template <bool A_T, bool B_T, class ALoad, typename TB, class Epi>
int gemm_f32_run(const ALoad& a, const TB* b, long long ldb, long long m, int n, long long k,
                 int splits, long long seg_rows, const Epi& epi, cudaStream_t stream) {
  if (seg_rows == 0) seg_rows = m;
  if (m < 1 || m > INT_MAX - F32_BM || n < 1 || k < 1 || splits < 1 || splits > 65535 ||
      seg_rows < 1 || m % seg_rows)
    return (int)cudaErrorInvalidValue;
  const long long seg_tiles = (seg_rows + F32_BM - 1) / F32_BM;
  const int n_tiles = (n + F32_BN - 1) / F32_BN;
  const long long blocks = m / seg_rows * seg_tiles * n_tiles;  // blockIdx.x: an int
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const long long k_split = (k + splits - 1) / splits;
  dim3 grid((unsigned)blocks, 1, splits);
  gemm_f32<A_T, B_T, ALoad, TB, Epi><<<grid, F32_THREADS, 0, stream>>>(
      a, b, ldb, n, k, k_split, (int)seg_rows, (int)seg_tiles, n_tiles, epi);
  return (int)cudaGetLastError();
}

// C (M x N, leading dimension ldc) = A (M x K) @ B (K x N), each row m then
// multiplied by row_scale[m] (fp32 or bf16, rs_bf16) when given.  A_T: A
// is stored as its (K x M) transpose; B_T: B as its (N x K) transpose; lda,
// ldb are the stored rows' lengths.  Split z takes K range [z k_split, (z +
// 1) k_split) and writes C + z * M * ldc.
template <bool A_T, bool B_T, typename TA, typename TB>
int gemm_f32_launch(const TA* a, long long lda, const TB* b, long long ldb, float* c,
                    long long ldc, int m, int n, long long k, int splits, const void* row_scale,
                    int rs_bf16, cudaStream_t stream) {
  return gemm_f32_run<A_T, B_T>(F32Matrix<A_T, TA>{a, lda}, b, ldb, m, n, k, splits, 0,
                                F32Store{c, ldc, m, n, row_scale, rs_bf16}, stream);
}


// ---------------------------------------------------------------------------
// Split-precision TF32 GEMM (see the note at the top)

#ifndef TF3_STAGES_OVERRIDE
#define TF3_STAGES_OVERRIDE 0
#endif

constexpr int TF3_BM = 128, TF3_BK = 32;          // rows a block; K a stage (128 bytes)
constexpr int TF3_A_BYTES = TF3_BM * TF3_BK * 4;  // 16 KB, each of A_hi and A_lo
constexpr int TF3_CONSUMERS = 256;                // two consumer warpgroups
constexpr int TF3_THREADS = TF3_CONSUMERS + 128;  // and the loader warpgroup
// setmaxnreg: 2 x 184 + 136 = 504 of the 512 a thread of each warpgroup
// may hold at one block an SM; the loader keeps two stages of A in flight,
// a consumer two m64n128 accumulators
constexpr int TF3_LOADER_REGS = 136, TF3_CONSUMER_REGS = 184;

template <int BN>
struct Tf3Ring {
  static_assert(BN == 112 || BN == 128, "BN is 112 or 128");
  static constexpr int B_BYTES = BN * TF3_BK * 4;  // each of B_hi and B_lo
  static constexpr int SLOT = 2 * TF3_A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES =
      TF3_STAGES_OVERRIDE ? TF3_STAGES_OVERRIDE : 200 * 1024 / SLOT;
  static constexpr int SCRATCH = 2 * 8 * BN * 4;  // the epilogue's (TcTile::smem)
  static constexpr int SMEM = 1024 + STAGES * SLOT + SCRATCH + 2 * STAGES * 8;
  static_assert(SMEM <= 232448, "the ring does not fit in shared memory");
};

// A gemm_tf32x3 block's output tile as its epilogue sees it: rows [m0,
// m_end) of row segment `seg` (its tile `tile`), columns [n0, n0 + BN), K
// split z.  Each consumer thread holds a wgmma fragment: acc[v] belongs to
// tile row row(v) and column n0 + col(v), and acc[v], acc[v + 1] (v even)
// to two adjacent columns of one row.  Every consumer thread calls the
// epilogue, rows past m_end included; `sync()` is a barrier over them,
// and `smem` is the epilogue's shared memory, 2 x 8 x BN floats, the same
// for each of a block's tiles.
struct TcTile {
  int m0, m_end, n0, seg, tile, z, r0, c0;
  float* smem;
  __device__ __forceinline__ int row(int v) const { return r0 + 8 * ((v >> 1) & 1); }
  __device__ __forceinline__ int col(int v) const { return c0 + 8 * (v >> 2) + (v & 1); }
  __device__ __forceinline__ void sync() const { named_bar_sync(1, TF3_CONSUMERS); }
};

// the byte offset of (row r, fp32 chunk c = k / 4) in a 128-row x 32 K
// tile in the 128-byte swizzle
__device__ __forceinline__ int tf3_offset(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// The tiles of one gemm_tf32x3 launch: tile id walks (split z, row tile,
// column tile), columns fastest, so that the blocks working side by side
// share a row tile's A in L2.  A row tile never crosses a segment's end.
struct Tf3Grid {
  int k, k_split, seg_rows, seg_tiles, row_tiles, n_tiles, bn, count;
  struct Tile {
    int m0, rows, seg, tile, n0, z, kb, ke, n_k;
  };
  __device__ __forceinline__ Tile operator()(int id) const {
    Tile t;
    const int per_z = row_tiles * n_tiles, rest = id % per_z, row_tile = rest / n_tiles;
    t.z = id / per_z;
    t.seg = row_tile / seg_tiles;
    t.tile = row_tile % seg_tiles;
    t.m0 = t.seg * seg_rows + t.tile * TF3_BM;
    t.rows = min(TF3_BM, (t.seg + 1) * seg_rows - t.m0);
    t.n0 = (rest % n_tiles) * bn;
    t.kb = t.z * k_split;
    t.ke = min(k, t.kb + k_split);
    t.n_k = t.ke > t.kb ? (t.ke - t.kb + TF3_BK - 1) / TF3_BK : 0;
    return t;
  }
};

// The loader warpgroup: for each stage of each of the block's tiles, the A
// functor's values of the tile's rows (zeros past the segment's end and
// past K), split into hi and lo and stored K-major in the swizzle, and B's
// hi and lo boxes by TMA.  Thread t fills 16-byte chunk t % 8 of rows t / 8
// + 16 j, j < 8; the next stage's raw quads (the next tile's first, at a
// tile's end) are loaded before this one's are finished and stored (a
// quad that K cuts is the functor's finished scalars).
template <int BN, class ALoad>
__device__ __forceinline__ void tf3_load(char* smem, uint64_t* full, uint64_t* empty,
                                         const CUtensorMap* bh_map, const CUtensorMap* bl_map,
                                         const ALoad& a_of, const Tf3Grid& grid) {
  using R = Tf3Ring<BN>;
  using Tile = Tf3Grid::Tile;
  reg_dealloc<TF3_LOADER_REGS>();
  const int t = threadIdx.x - TF3_CONSUMERS, c = t % 8, r0 = t / 8;
  auto fetch = [&](const Tile& tl, int s, float4 (&v)[8]) {
    const int k = tl.kb + s * TF3_BK + 4 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = r0 + 16 * j;
      v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r >= tl.rows || k >= tl.ke) continue;
      if (k + 3 < tl.ke) {
        v[j] = a_of.quad(tl.m0 + r, k, tl.seg);
      } else {
        v[j].x = a_of(tl.m0 + r, k, tl.seg);
        if (k + 1 < tl.ke) v[j].y = a_of(tl.m0 + r, k + 1, tl.seg);
        if (k + 2 < tl.ke) v[j].z = a_of(tl.m0 + r, k + 2, tl.seg);
      }
    }
  };
  // the block's first tile with a stage, and after (id, s) the next stage
  auto first_from = [&](int id, Tile& tl) {
    for (; id < grid.count; id += gridDim.x)
      if ((tl = grid(id)).n_k > 0) break;
    return id;
  };
  Tile cur_t;
  int id = first_from(blockIdx.x, cur_t), s = 0;
  if (id >= grid.count) return;
  float4 cur[8], nxt[8];
  fetch(cur_t, 0, cur);
  for (int gs = 0;; ++gs) {  // gs: the block's stage count, across its tiles
    Tile nxt_t = cur_t;
    int nxt_id = id, nxt_s = s + 1;
    if (nxt_s == cur_t.n_k) {
      nxt_s = 0;
      nxt_id = first_from(id + gridDim.x, nxt_t);
    }
    const bool more = nxt_id < grid.count;
    if (more) fetch(nxt_t, nxt_s, nxt);
    const int slot = gs % R::STAGES;
    char* sb = smem + slot * R::SLOT;
    if (gs >= R::STAGES) mbar_wait(empty + slot, (gs / R::STAGES - 1) & 1);
    const int kk = cur_t.kb + s * TF3_BK;
    if (t == 0) {
      mbar_expect_tx(full + slot, 2 * R::B_BYTES);
      tma_load_2d(sb + 2 * TF3_A_BYTES, bh_map, full + slot, kk, cur_t.n0);
      tma_load_2d(sb + 2 * TF3_A_BYTES + R::B_BYTES, bl_map, full + slot, kk, cur_t.n0);
    }
    const int k = kk + 4 * c;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 x = k + 3 < cur_t.ke && r0 + 16 * j < cur_t.rows
                           ? a_of.finish(cur[j], k, cur_t.seg) : cur[j];
      const float4 hi = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
      const float4 lo = make_float4(tf32_rna(x.x - hi.x), tf32_rna(x.y - hi.y),
                                    tf32_rna(x.z - hi.z), tf32_rna(x.w - hi.w));
      const int off = tf3_offset(r0 + 16 * j, c);
      *reinterpret_cast<float4*>(sb + off) = hi;
      *reinterpret_cast<float4*>(sb + TF3_A_BYTES + off) = lo;
    }
    fence_proxy_async();  // the generic stores, before wgmma's async-proxy reads
    mbar_arrive(full + slot);
    if (!more) break;
#pragma unroll
    for (int j = 0; j < 8; ++j) cur[j] = nxt[j];
    cur_t = nxt_t;
    id = nxt_id;
    s = nxt_s;
  }
}

// The consumer warpgroups, for each of the block's tiles: warpgroup g owns
// rows [64 g, 64 g + 64) of the tile; three wgmmas per k8 step into `part`,
// which each stage starts afresh, the small terms first; once they are
// done, the stage is released and `part` added to `acc` (fp32, round to
// nearest); then the epilogue on `acc`, while the loader fills the ring
// with the next tile's stages.  While one warpgroup adds, the other's
// wgmmas keep the tensor cores busy.
template <int BN, class Epi>
__device__ __forceinline__ void tf3_consume(char* smem, uint64_t* full, uint64_t* empty,
                                            const Tf3Grid& grid, const Epi& epi) {
  using R = Tf3Ring<BN>;
  reg_alloc<TF3_CONSUMER_REGS>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = warp / 4;
  float acc[BN / 2], part[BN / 2];
  int gs = 0;  // the block's stage count, across its tiles
  for (int id = blockIdx.x; id < grid.count; id += gridDim.x) {
    const Tf3Grid::Tile tl = grid(id);
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int s = 0; s < tl.n_k; ++s, ++gs) {
      const int slot = gs % R::STAGES;
      char* sb = smem + slot * R::SLOT;
      mbar_wait(full + slot, (gs / R::STAGES) & 1);
      wgmma_fence();
      fence_operand(part);
      // the small terms first: lo.hi and hi.lo of the stage's four k8
      // steps (k8 = 32 bytes, as bf16's k16), then its hi.hi
#pragma unroll
      for (int pass = 0; pass < 3; ++pass)
#pragma unroll
        for (int ks = 0; ks < TF3_BK / 8; ++ks) {
          char* a = sb + g * 8192 + ks * 32 + (pass == 0 ? TF3_A_BYTES : 0);
          char* b = sb + 2 * TF3_A_BYTES + ks * 32 + (pass == 1 ? R::B_BYTES : 0);
          wgmma_tf32<BN>(part, wgmma_desc(a, 16, 1024), wgmma_desc(b, 16, 1024),
                         pass + ks > 0 ? 1 : 0);  // the stage's first overwrites
        }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(part);
      if (lane == 0) mbar_arrive(empty + slot);  // the stage's wgmmas are done
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    }
    const TcTile t{tl.m0, tl.m0 + tl.rows, tl.n0, tl.seg, tl.tile, tl.z,
                   64 * g + 16 * (warp % 4) + lane / 4, 2 * (lane % 4),
                   reinterpret_cast<float*>(smem + R::STAGES * R::SLOT)};
    epi(acc, t);
  }
}

// epi(A @ B) over row segments of seg_rows (see gemm_f32), persistent: a
// block a multiprocessor walks tile ids blockIdx.x, blockIdx.x +
// gridDim.x, ... (Tf3Grid); split z takes K range [z k_split, (z + 1)
// k_split), k_split a multiple of TF3_BK.
template <int BN, class ALoad, class Epi>
__global__ void __launch_bounds__(TF3_THREADS, 1)
    gemm_tf32x3(const __grid_constant__ CUtensorMap bh_map,
                const __grid_constant__ CUtensorMap bl_map, ALoad a_of, Tf3Grid grid, Epi epi) {
  using R = Tf3Ring<BN>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::STAGES * R::SLOT + R::SCRATCH);
  uint64_t* empty = full + R::STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < R::STAGES; ++s) {
      mbar_init(full + s, 128 + 1);  // every loader thread, and the TMA's expect_tx
      mbar_init(empty + s, TF3_CONSUMERS / 32);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x >= TF3_CONSUMERS)
    tf3_load<BN>(smem, full, empty, &bh_map, &bl_map, a_of, grid);
  else
    tf3_consume<BN>(smem, full, empty, grid, epi);
}

// Launches gemm_tf32x3: epi(A @ B) over m = segments * seg_rows rows
// (seg_rows 0: one segment of m rows), m < 2^31, A (m x k) the functor `a`,
// B (k x n) given as the hi and lo halves of its (n x k) transpose, rows of
// ldb fp32 (ldb >= k, a multiple of 4; 16-byte aligned: a TMA operand).
// `splits` > 1 splits K into that many ranges of whole stages.  One block
// a multiprocessor, at most one a tile.  Returns a CUDA error code.
template <int BN, class ALoad, class Epi>
int gemm_tf32x3_run(const ALoad& a, const float* b_hi, const float* b_lo, long long ldb,
                    long long m, int n, int k, int splits, long long seg_rows, const Epi& epi,
                    cudaStream_t stream) {
  using R = Tf3Ring<BN>;
  if (seg_rows == 0) seg_rows = m;
  if (m < 1 || m > INT_MAX - TF3_BM || n < 1 || k < 1 || ldb < k || ldb % 4 || splits < 1 ||
      splits > 65535 || seg_rows < 1 || m % seg_rows ||
      (reinterpret_cast<uintptr_t>(b_hi) | reinterpret_cast<uintptr_t>(b_lo)) % 16)
    return (int)cudaErrorInvalidValue;
  const long long seg_tiles = (seg_rows + TF3_BM - 1) / TF3_BM;
  const long long row_tiles = m / seg_rows * seg_tiles;
  const int n_tiles = (n + BN - 1) / BN;
  const long long count = row_tiles * n_tiles * splits;  // tile ids: ints
  if (count > INT_MAX) return (int)cudaErrorInvalidValue;
  const int k_split = ((k + splits - 1) / splits + TF3_BK - 1) / TF3_BK * TF3_BK;
  CUtensorMap maps[2];
  const uint64_t dims[2] = {(uint64_t)k, (uint64_t)n};  // TMA writes zeros past K and N
  const uint64_t strides[1] = {(uint64_t)ldb * 4};
  const uint32_t box[2] = {(uint32_t)TF3_BK, (uint32_t)BN};
  for (int i = 0; i < 2; ++i) {
    const int err = make_tensor_map(&maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                                    i ? b_lo : b_hi, dims, strides, box,
                                    CU_TENSOR_MAP_SWIZZLE_128B);
    if (err) return err;
  }
  static int sms = 0;  // once per instantiation: the attribute, the card's multiprocessors
  if (!sms) {
    int dev = 0;
    cudaError_t e = cudaFuncSetAttribute(gemm_tf32x3<BN, ALoad, Epi>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, R::SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const Tf3Grid grid{k, k_split, (int)seg_rows, (int)seg_tiles, (int)row_tiles, n_tiles, BN,
                     (int)count};
  gemm_tf32x3<BN, ALoad, Epi><<<(unsigned)min(count, (long long)sms), TF3_THREADS, R::SMEM,
                                stream>>>(maps[0], maps[1], a, grid, epi);
  return (int)cudaGetLastError();
}

}  // namespace
