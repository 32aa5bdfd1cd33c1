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
// bf16 operands: dense, on wgmma (dft_tiles.cuh: analysis_wgmma).  Data
// movement is the whole job, so a block owns one row and 128 channels and
// holds all 2M <= 256 modes: two consumer warpgroups of two m64n128
// accumulators each (128 fp32 registers a thread, 232 with setmaxnreg), so
// each matrix tile serves 128 channels.  A producer warp keeps a ring of
// DFT_STAGES stages in flight by TMA: the matrix tile (256
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

#ifndef DFT_STAGES_OVERRIDE
#define DFT_STAGES_OVERRIDE 0
#endif

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
    return x_bf16 ? launch_analysis_wgmma<bf, float, DFT_STAGES_OVERRIDE>(
                        at, x, out, rows, w, m, c, at_rows, at_cols, s)
                  : launch_analysis_wgmma<float, float, DFT_STAGES_OVERRIDE>(
                        at, x, out, rows, w, m, c, at_rows, at_cols, s);
  return x_bf16 ? fold_launch<true, bf, float>(at, x, out, rows, w, m, c, at_rows, at_cols, s)
                : fold_launch<true, float, float>(at, x, out, rows, w, m, c, at_rows, at_cols, s);
}
