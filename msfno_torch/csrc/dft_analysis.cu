// Truncated forward longitude DFT (sm_90a): fp32 FMA or bf16 tensor-core
// GEMMs with fp32 accumulation.
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
// reads.  x is fp32 or bf16 (read as it is; JAX casts it to fp32 first,
// which changes no value).
//
// Bound on the H100 at the trans_down shape, x (1, 721, 1440, 256): x 1.06
// GB (fp32) + f 0.18 GB = 1.24 GB -> 0.37 ms at 3.35 TB/s; 2 * 721 * 242 *
// 1440 * 256 = 1.29e11 FLOP -> 1.92 ms at 67 TFLOP/s fp32 (operations) or
// 0.13 ms at 989 TFLOP/s bf16 (bytes then bound it).
//
// Design (dft_rows.cuh): one block per (row, channel tile of 64) covers all
// 2M = 242 modes in one 256-row tile, so each x row is read from device
// memory once; K = W runs in slabs through shared memory, with the next
// slab in flight.  The prepared At ([C | -S] padded to (1440, 256), 1.5 MB
// in fp32) stays in L2.

#include "dft_rows.cuh"

// Padding multiples of the prepared At (W, 2M): axis 0 rows, axis 1 columns.
extern "C" int dft_analysis_padding(int axis) { return dft_padding(axis); }

// at (k_pad, m_pad) prepared [C | -S], bf16 if bf16_ops else fp32; x (rows,
// w, c) fp32 or bf16 (x_bf16); out (rows, 2m, c) fp32.  bf16_ops: bf16
// operands on the tensor cores, else fp32 FMA.
extern "C" int dft_analysis(const void* at, const void* x, float* out, long long rows, int w,
                            int m, int c, int k_pad, int m_pad, int x_bf16, int bf16_ops,
                            void* stream) {
  DftArgs a{};
  a.at = at;
  a.b = x;
  a.out = out;
  a.rows = rows;
  a.k_dim = w;
  a.m_dim = 2 * m;
  a.c = c;
  a.k_pad = k_pad;
  a.m_pad = m_pad;
  cudaStream_t s = (cudaStream_t)stream;
  return x_bf16 ? dft_rows_launch<__nv_bfloat16, float>(a, bf16_ops, s)
                : dft_rows_launch<float, float>(a, bf16_ops, s);
}
