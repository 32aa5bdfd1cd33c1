// Truncated forward longitude DFT (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/dft.py:dft_analysis (the Pallas TPU kernel
// that `RealSHT(lon_dft="pallas")` calls).  Per latitude row r of x (rows,
// W, C):
//
//   f[r] = [C | -S]^T @ x[r]        (2M, C) fp32, [re | im] stacked on the
//                                   mode axis
//
// with C, S (W, M) the fp32 matrices of sht._dft_analysis_matrices: JAX's
// (fr, fi) = (x @ C, -(x @ S)) in the layout `RealSHT.legendre_stacked`
// reads.  x is fp32 or bf16, read as it is (no cast pass).
//
// Bound on the H100 at the trans_down shape, x (1, 721, 1440, 256), with
// the operations of the even/odd fold, 721 * 242 * 1440 * 256 = 6.43e10
// FLOP: fp32 operands 0.960 ms at 67 TFLOP/s (operations); bf16 operands,
// x fp32 1.06 GB + f 0.18 GB = 1.24 GB -> 0.371 ms at 3.35 TB/s (bytes;
// 0.065 ms of bf16 tensor-core work).
//
// fp32 operands: the folded block GEMM of dft_tiles.cuh (`fold_rows`),
// true fp32 FMA on the CUDA cores: x_w and its mirror x_{W-w} are added
// and subtracted as the slab is staged, then re and im are two products of
// 121 modes (a 128-row tile, padded in shared memory only) over the 721
// longitudes 0..W/2, half the dense multiply-adds.  A block owns one row,
// the 128-mode tile and 64 channels; 2 blocks per SM.  L2: the operand
// (736 x 256 fp32, 0.75 MB) once per block, 2884 blocks -> 2.2 GB per
// launch (the dense row GEMM read 4.3 GB); x from HBM once.
//
// bf16 operands: dense, on wgmma.  Data movement is the whole job, so a
// block owns one row and 128 channels and holds all 2M <= 256 modes: two
// consumer warpgroups of two m64n128 accumulators each (128 fp32 registers
// a thread, 232 with setmaxnreg), so each matrix tile serves 128 channels.
// A producer warp keeps a ring of DFT_STAGES stages in flight by TMA: the matrix tile (256
// modes x 64 longitudes, bf16, K-major, 128-byte swizzle) and the raw x
// slab (64 longitudes x 128 channels as stored: a 3-D TMA box, zeros past
// W and C).  The consumers convert the raw slab to the MN-major swizzled
// bf16 B operand (fp32 -> bf16 in shared memory), then run 4 K-steps of
// wgmma.  HBM: x read once, f written once (16-byte vectors).  L2: the
// matrix (1440 x 256 bf16, 0.74 MB) once per block, 1442 blocks -> 1.06 GB
// per launch, about the bytes of x (the old row GEMM re-read 2.1-4.3 GB).
// With C * elt not a multiple of 16 (C = 73: 292-byte rows, no 2-D tensor
// map) the block owns all C channels and each slab is one contiguous run:
// one 1-D bulk copy (cp.async.bulk) when W * C * elt is a multiple of 16,
// else the consumers' reads of device memory.
//
// Tunables: FOLD_MINB (blocks per SM of the fp32 kernel, dft_tiles.cuh) and
// DFT_STAGES (ring depth of the bf16 kernel; 0 fills 192 KB); A/B them with
// tools/kernel_variants.py.

#include "dft_tiles.cuh"

namespace {

#ifndef DFT_STAGES_OVERRIDE
#define DFT_STAGES_OVERRIDE 0
#endif

struct WgAnalysisArgs {
  RawSource x;  // (rows, w, c)
  float* out;   // (rows, two_m, c)
  long long rows;
  int w, two_m, c, m_tiles, c_tiles, n_k;
  int vec;  // 16-byte output vectors
};

template <typename IN_T>
struct AnalysisSmem {
  static constexpr int A_BYTES = BF16_TILE * BF16_K * 2;  // 4 boxes of 64 modes x 64 longitudes
  static constexpr int SLOT = A_BYTES + BF16_K * WG_BN * (int)sizeof(IN_T);
  static constexpr int STAGES = DFT_STAGES_OVERRIDE ? DFT_STAGES_OVERRIDE : 192 * 1024 / SLOT;
  static constexpr int B_BYTES = BF16_K * WG_BN * 2;  // one converted B operand
  static constexpr int BYTES = 1024 + STAGES * SLOT + 2 * B_BYTES + 2 * STAGES * 8;
};

// two consumer warpgroups and a producer warpgroup, of which one warp
// works: 384 threads, so that setmaxnreg can give the consumers 232
// registers (their 128 accumulators) and the producer 40
constexpr int ANALYSIS_THREADS = WG_CONSUMERS + 128;

template <typename IN_T>
__global__ void __launch_bounds__(ANALYSIS_THREADS, 1)
    analysis_wgmma(const __grid_constant__ CUtensorMap a_map,
                   const __grid_constant__ CUtensorMap x_map, WgAnalysisArgs a) {
  using S = AnalysisSmem<IN_T>;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  char* bbuf = smem + S::STAGES * S::SLOT;
  uint64_t* full = reinterpret_cast<uint64_t*>(bbuf + 2 * S::B_BYTES);
  uint64_t* empty = full + S::STAGES;
  // (row, mode tile, channel tile), channel tiles fastest
  const long long bid = blockIdx.x;
  const int c0 = (int)(bid % a.c_tiles) * WG_BN;
  const long long rest = bid / a.c_tiles;
  const int mt = (int)(rest % a.m_tiles);
  const long long r = rest / a.m_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 8);  // every consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= WG_CONSUMERS / 32) {  // the producer warpgroup
    reg_dealloc<40>();
    if (warp > WG_CONSUMERS / 32) return;
    for (int s = 0; s < a.n_k; ++s) {
      const int slot = s % S::STAGES;
      char* sb = smem + slot * S::SLOT;
      if (s >= S::STAGES) mbar_wait(empty + slot, (s / S::STAGES - 1) & 1);
      const int k0 = s * BF16_K;
      if (lane == 0) {
        mbar_expect_tx(full + slot, S::A_BYTES + raw_tx_bytes<IN_T>(a.x, k0));
        for (int b = 0; b < 4; ++b)
          tma_load_2d(sb + b * 8192, &a_map, full + slot, k0, mt * BF16_TILE + 64 * b);
        raw_fetch<IN_T>(a.x, &x_map, sb + S::A_BYTES, full + slot, r, k0, c0);
      }
      __syncwarp();
    }
    return;
  }

  // consumers: warpgroup g holds modes [128 g, 128 g + 128) of the tile
  reg_alloc<232>();
  const int g = warp / 4;
  const bool dense = a.x.mode == RAW_TMA;
  const int pitch = dense ? WG_BN : a.c;
  float acc[2][64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[0][i] = acc[1][i] = 0.f;
  for (int s = 0; s < a.n_k; ++s) {
    const int slot = s % S::STAGES;
    char* sb = smem + slot * S::SLOT;
    char* bs = bbuf + (s & 1) * S::B_BYTES;
    mbar_wait(full + slot, (s / S::STAGES) & 1);
    // the other B buffer may still be read by the other warpgroup's
    // previous wgmma; this one was last read two slabs ago
    stage_b<IN_T>(raw_slab<IN_T>(a.x, sb + S::A_BYTES, r, s * BF16_K), pitch,
                  min(BF16_K, a.w - s * BF16_K), pitch, bs, BF16_K * 128, 0, threadIdx.x,
                  WG_CONSUMERS, dense);
    fence_proxy_async();
    named_bar_sync(1, WG_CONSUMERS);
    wgmma_fence();
    fence_operand(acc[0]);
    fence_operand(acc[1]);
#pragma unroll
    for (int ks = 0; ks < BF16_K / 16; ++ks) {
      const uint64_t db = wgmma_desc(bs + ks * 2048, BF16_K * 128, 1024);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const uint64_t da = wgmma_desc(sb + (2 * g + i) * 8192 + ks * 32, 16, 1024);
        wgmma_m64n128k16<1>(acc[i], da, db, (s > 0 || ks > 0) ? 1 : 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operand(acc[0]);
    fence_operand(acc[1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + slot);
  }
  float* out = a.out + r * a.two_m * a.c;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row0 = mt * BF16_TILE + 128 * g + 64 * i;
    if (row0 < a.two_m)
      store_fragment<float>(acc[i], out, row0, min(64, a.two_m - row0), c0, a.c, a.vec, false);
  }
}

template <typename IN_T>
int launch_wgmma(const void* at, const void* x, float* out, long long rows, int w, int m, int c,
                 int at_rows, int at_cols, cudaStream_t stream) {
  using S = AnalysisSmem<IN_T>;
  WgAnalysisArgs a{};
  a.out = out;
  a.rows = rows;
  a.w = w;
  a.two_m = 2 * m;
  a.c = c;
  a.m_tiles = (2 * m + BF16_TILE - 1) / BF16_TILE;
  a.n_k = (w + BF16_K - 1) / BF16_K;
  if (rows < 1 || w < 1 || m < 1 || c < 1 || at_rows != a.m_tiles * BF16_TILE ||
      at_cols != a.n_k * BF16_K)
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, x_map;
  memset(&x_map, 0, sizeof(x_map));
  const uint64_t a_dims[2] = {(uint64_t)at_cols, (uint64_t)at_rows};
  const uint64_t a_strides[1] = {(uint64_t)at_cols * 2};
  const uint32_t a_box[2] = {BF16_K, 64};
  int err = make_tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, at, a_dims, a_strides,
                            a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  if ((err = raw_source<IN_T>(&a.x, &x_map, x, rows, w, c))) return err;
  a.c_tiles = a.x.mode == RAW_TMA ? (c + WG_BN - 1) / WG_BN : 1;
  a.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long blocks = rows * a.m_tiles * a.c_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;  // once per kernel
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(analysis_wgmma<IN_T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  analysis_wgmma<IN_T><<<(unsigned)blocks, ANALYSIS_THREADS, S::BYTES, stream>>>(a_map, x_map,
                                                                                 a);
  return (int)cudaGetLastError();
}

}  // namespace

// The tiles that shape the prepared operands (0: FOLD_K, 1: FOLD_TILE, 2:
// BF16_K, 3: BF16_TILE).
extern "C" int dft_analysis_tile(int i) { return dft_tile(i); }

// at: the prepared operand (at_rows, at_cols): fp32 fold half matrices, or
// bf16 [C | -S]^T (bf16_ops); x (rows, w, c) fp32 or bf16 (x_bf16); out
// (rows, 2m, c) fp32.
extern "C" int dft_analysis(const void* at, const void* x, float* out, long long rows, int w,
                            int m, int c, int at_rows, int at_cols, int x_bf16, int bf16_ops,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (bf16_ops)
    return x_bf16 ? launch_wgmma<bf>(at, x, out, rows, w, m, c, at_rows, at_cols, s)
                  : launch_wgmma<float>(at, x, out, rows, w, m, c, at_rows, at_cols, s);
  FoldArgs a{};
  a.at = reinterpret_cast<const float*>(at);
  a.b = x;
  a.out = out;
  a.rows = rows;
  a.w = w;
  a.m = m;
  a.c = c;
  a.kh = w / 2 + 1;
  a.k_dim = a.kh;
  a.k_pad = at_rows;
  a.tiles = (m + FOLD_TILE - 1) / FOLD_TILE;
  if (at_cols != a.tiles * 2 * FOLD_TILE) return (int)cudaErrorInvalidValue;
  return x_bf16 ? fold_launch<true, bf, float>(a, s) : fold_launch<true, float, float>(a, s);
}
