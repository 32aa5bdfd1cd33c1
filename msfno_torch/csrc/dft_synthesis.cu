// Truncated inverse longitude DFT (sm_90a).
//
// Replaces msfno_tpu/ops/pallas/dft.py:dft_synthesis (the Pallas TPU kernel
// that `InverseRealSHT(lon_dft="pallas")` calls).  Per latitude row r of
// the stacked Legendre synthesis hm (rows, 2M, C) = [re | im]:
//
//   x[r] = [Ci; -Si]^T @ hm[r]      (W, C), fp32 or bf16 out
//
// with Ci, Si (M, W) the fp32 matrices of sht._dft_synthesis_matrices (k_m
// doubling, zeroed Nyquist sin row): JAX's re @ Ci - im @ Si.  hm is fp32 or
// bf16 (the bf16 Legendre GEMM's output on the "bfloat16" knob), read as it
// is.
//
// Bound on the H100 at the itrans_up shape, x (1, 721, 1440, 256), with the
// operations of the even/odd fold (6.43e10 FLOP): fp32 operands 0.960 ms at
// 67 TFLOP/s (operations); bf16 operands, hm 0.09-0.18 GB + x 1.06 GB (fp32
// out) -> 0.344-0.371 ms at 3.35 TB/s (bytes).
//
// fp32 operands: the folded block GEMM of dft_tiles.cuh (`fold_rows`),
// true fp32 FMA: P = Ci_h^T re and Q = Si_h^T im over the 721 longitudes
// 0..W/2 (a block: one row and 64 channels, its six 128-longitude tiles in
// turn; K = the 121 modes),
// then x_w = P - Q and x_{W-w} = P + Q: every computed longitude writes two
// output rows, half the dense multiply-adds.  The second half of the warps
// hands Q to the first through shared memory.  L2 per launch: the operand
// (128 x 256 fp32 per tile) and the hm slabs (2 x 128 x 64 fp32) once per
// (row, tile, channel tile): 2.3 + 2.3 GB; x written once.
//
// bf16 operands: dense, on wgmma.  The output is the stream (1.06 GB in
// fp32), so a block owns one row and 128 channels and keeps hm[r] (2M <=
// 256 modes x 128 channels, converted to bf16: 64 KB) resident in shared
// memory as the MN-major B operand; its two consumer warpgroups walk the
// row's 64-longitude tiles of the matrix ([Ci; -Si]^T, bf16, K-major,
// 128-byte swizzle, 32 KB a tile), which a producer warp streams by TMA
// through a ring of DFT_STAGES stages.  Each warpgroup runs one m64n128
// accumulator over K = 2M in 16 K-steps per tile and writes its 64 x 128
// tile in 16-byte vectors while the other warpgroup computes.  hm[r] goes
// through the same ring first, in raw 64-mode slabs (a 3-D TMA box; for
// C = 73, 242 * 73 * elt is no multiple of 16 and the consumers read the
// slab from device memory), converted to bf16 by the consumers.  Rather than the alternatives (a
// (row, 128-channel) block streaming hm slabs per longitude tile, or a
// cluster multicasting hm): hm[r] is read from HBM once and converted once,
// and the matrix is the only L2 stream: 1440 x 256 bf16 = 0.74 MB per block,
// 1442 blocks -> 1.06 GB per launch, the bytes of the output (the old row
// GEMM moved 2.3 GB of matrix slabs and 1.1 GB of hm re-reads).  With 2M >
// 256 the block runs the modes in chunks of 256 and adds each chunk's
// product to the output it wrote.
//
// Tunables: FOLD_MINB and FOLD_GROUP (blocks per SM and longitude tiles
// per block of the fp32 kernel, dft_tiles.cuh) and DFT_STAGES (ring depth
// of the bf16 kernel); A/B them with tools/kernel_variants.py.

#include "dft_tiles.cuh"

namespace {

#ifndef DFT_STAGES_OVERRIDE
#define DFT_STAGES_OVERRIDE 4
#endif

struct WgSynthesisArgs {
  RawSource hm;  // (rows, two_m, c)
  void* out;     // (rows, w, c)
  long long rows;
  int w, two_m, c, c_tiles, n_wt, n_kc;
  int vec;  // 16-byte output vectors
};

struct SynthesisSmem {
  static constexpr int B_CHUNK = BF16_TILE * 128;  // 256 K-rows of 64 channels (bf16)
  static constexpr int B_BYTES = 2 * B_CHUNK;
  static constexpr int SLOT = RAW_BYTES_MAX;  // = one matrix tile, 64 x 256 bf16
  static constexpr int STAGES = DFT_STAGES_OVERRIDE;
  static constexpr int BYTES = 1024 + B_BYTES + STAGES * SLOT + 2 * STAGES * 8;
  static_assert(SLOT == 64 * BF16_TILE * 2, "a slot holds one matrix tile");
};

// 64-mode slabs of chunk kc
__device__ __forceinline__ int hm_slabs(const WgSynthesisArgs& a, int kc) {
  return (min(BF16_TILE, a.two_m - kc * BF16_TILE) + BF16_K - 1) / BF16_K;
}

template <typename IN_T, typename OUT_T>
__global__ void __launch_bounds__(WG_THREADS, 1)
    synthesis_wgmma(const __grid_constant__ CUtensorMap a_map,
                    const __grid_constant__ CUtensorMap hm_map, WgSynthesisArgs a) {
  using S = SynthesisSmem;
  extern __shared__ char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  char* bres = smem;  // the resident B operand
  char* ring = smem + S::B_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S::STAGES * S::SLOT);
  uint64_t* empty = full + S::STAGES;
  const long long bid = blockIdx.x;
  const int c0 = (int)(bid % a.c_tiles) * WG_BN;
  const long long r = bid / a.c_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4);  // the four warps of one consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the ring's items, in order: per mode chunk, its hm slabs, then the
  // matrix's longitude tiles
  if (warp == WG_CONSUMERS / 32) {  // producer
    int i = 0;
    for (int kc = 0; kc < a.n_kc; ++kc) {
      const int n_hm = hm_slabs(a, kc);
      for (int j = 0; j < n_hm + a.n_wt; ++j, ++i) {
        const int slot = i % S::STAGES;
        char* sb = ring + slot * S::SLOT;
        if (i >= S::STAGES) mbar_wait(empty + slot, (i / S::STAGES - 1) & 1);
        if (j < n_hm) {
          const int k0 = kc * BF16_TILE + j * BF16_K;
          if (lane == 0) {
            mbar_expect_tx(full + slot, raw_tx_bytes<IN_T>(a.hm, k0));
            raw_fetch<IN_T>(a.hm, &hm_map, sb, full + slot, r, k0, c0);
          }
        } else if (lane == 0) {
          const int t = j - n_hm;
          mbar_expect_tx(full + slot, S::SLOT);
          for (int b = 0; b < 4; ++b)
            tma_load_2d(sb + b * 8192, &a_map, full + slot, kc * BF16_TILE + 64 * b, 64 * t);
        }
        __syncwarp();
      }
    }
    return;
  }

  // consumers: warpgroup g takes the longitude tiles t = g, g + 2, ...
  const int g = warp / 4;
  const bool dense = a.hm.mode == RAW_TMA;
  const int pitch = dense ? WG_BN : a.c;
  OUT_T* out = reinterpret_cast<OUT_T*>(a.out) + r * a.w * a.c;
  float acc[64];
#pragma unroll
  for (int q = 0; q < 64; ++q) acc[q] = 0.f;
  int i = 0;
  for (int kc = 0; kc < a.n_kc; ++kc) {
    const int n_hm = hm_slabs(a, kc);
    const int k_len = min(BF16_TILE, a.two_m - kc * BF16_TILE);
    const int n_ks = (k_len + 15) / 16;
    // the previous chunk's wgmmas are done in both warpgroups before B is
    // rewritten
    if (kc > 0) named_bar_sync(1, WG_CONSUMERS);
    for (int j = 0; j < n_hm; ++j, ++i) {
      const int slot = i % S::STAGES;
      mbar_wait(full + slot, (i / S::STAGES) & 1);
      const int k0 = kc * BF16_TILE + j * BF16_K;
      stage_b<IN_T>(raw_slab<IN_T>(a.hm, ring + slot * S::SLOT, r, k0), pitch,
                    min(BF16_K, a.two_m - k0), pitch, bres, S::B_CHUNK, j * BF16_K, threadIdx.x,
                    WG_CONSUMERS, dense);
      fence_proxy_async();
      named_bar_sync(1, WG_CONSUMERS);
      if (warp < 4 && lane == 0) mbar_arrive(empty + slot);
    }
    // B rows [k_len, 16 n_ks) are zeros (stage_b), as are the matrix's
    // columns there (the prepared padding)
    for (int t = g; t < a.n_wt; t += 2) {
      const int it = i + t;
      const int slot = it % S::STAGES;
      const char* sb = ring + slot * S::SLOT;
      mbar_wait(full + slot, (it / S::STAGES) & 1);
      wgmma_fence();
      fence_operand(acc);
      for (int ks = 0; ks < n_ks; ++ks) {
        const uint64_t da = wgmma_desc(sb + (ks / 4) * 8192 + (ks % 4) * 32, 16, 1024);
        const uint64_t db = wgmma_desc(bres + ks * 2048, S::B_CHUNK, 1024);
        wgmma_m64n128k16<1>(acc, da, db, ks > 0 ? 1 : 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operand(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + slot);
      store_fragment<OUT_T>(acc, out, 64LL * t, min(64, a.w - 64 * t), c0, a.c, a.vec, kc > 0);
    }
    i += a.n_wt;
  }
}

template <typename IN_T, typename OUT_T>
int launch_wgmma(const void* at, const void* hm, void* out, long long rows, int w, int m, int c,
                 int at_rows, int at_cols, cudaStream_t stream) {
  using S = SynthesisSmem;
  WgSynthesisArgs a{};
  a.out = out;
  a.rows = rows;
  a.w = w;
  a.two_m = 2 * m;
  a.c = c;
  a.n_wt = (w + 63) / 64;
  a.n_kc = (2 * m + BF16_TILE - 1) / BF16_TILE;
  if (rows < 1 || w < 1 || m < 1 || c < 1 || at_rows != a.n_wt * 64 ||
      at_cols != a.n_kc * BF16_TILE)
    return (int)cudaErrorInvalidValue;
  CUtensorMap a_map, hm_map;
  memset(&hm_map, 0, sizeof(hm_map));
  const uint64_t a_dims[2] = {(uint64_t)at_cols, (uint64_t)at_rows};
  const uint64_t a_strides[1] = {(uint64_t)at_cols * 2};
  const uint32_t a_box[2] = {BF16_K, 64};
  int err = make_tensor_map(&a_map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, at, a_dims, a_strides,
                            a_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  if ((err = raw_source<IN_T>(&a.hm, &hm_map, hm, rows, 2 * m, c))) return err;
  a.c_tiles = a.hm.mode == RAW_TMA ? (c + WG_BN - 1) / WG_BN : 1;
  a.vec = c % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long blocks = rows * a.c_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  static bool smem_set = false;  // once per kernel
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(synthesis_wgmma<IN_T, OUT_T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  synthesis_wgmma<IN_T, OUT_T><<<(unsigned)blocks, WG_THREADS, S::BYTES, stream>>>(a_map, hm_map,
                                                                                    a);
  return (int)cudaGetLastError();
}

template <typename IN_T, typename OUT_T>
int launch(const void* at, const void* hm, void* out, long long rows, int w, int m, int c,
           int at_rows, int at_cols, int bf16_ops, cudaStream_t s) {
  if (bf16_ops) return launch_wgmma<IN_T, OUT_T>(at, hm, out, rows, w, m, c, at_rows, at_cols, s);
  return fold_launch<false, IN_T, OUT_T>(at, hm, out, rows, w, m, c, at_rows, at_cols, s);
}

}  // namespace

// The tiles that shape the prepared operands (0: FOLD_K, 1: FOLD_TILE, 2:
// BF16_K, 3: BF16_TILE).
extern "C" int dft_synthesis_tile(int i) { return dft_tile(i); }

// at: the prepared operand (at_rows, at_cols): fp32 fold half matrices, or
// bf16 [Ci; -Si]^T (bf16_ops); hm (rows, 2m, c) fp32 or bf16 (hm_bf16); out
// (rows, w, c) fp32 or bf16 (out_bf16).
extern "C" int dft_synthesis(const void* at, const void* hm, void* out, long long rows, int w,
                             int m, int c, int at_rows, int at_cols, int hm_bf16, int out_bf16,
                             int bf16_ops, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (hm_bf16)
    return out_bf16 ? launch<bf, bf>(at, hm, out, rows, w, m, c, at_rows, at_cols, bf16_ops, s)
                    : launch<bf, float>(at, hm, out, rows, w, m, c, at_rows, at_cols, bf16_ops, s);
  return out_bf16 ? launch<float, bf>(at, hm, out, rows, w, m, c, at_rows, at_cols, bf16_ops, s)
                  : launch<float, float>(at, hm, out, rows, w, m, c, at_rows, at_cols, bf16_ops, s);
}
