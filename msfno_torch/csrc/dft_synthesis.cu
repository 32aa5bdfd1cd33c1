// Truncated inverse longitude DFT (sm_90a): fp32 FMA or bf16 tensor-core
// GEMMs with fp32 accumulation.
//
// Replaces msfno_tpu/ops/pallas/dft.py:dft_synthesis (the Pallas TPU kernel
// that `InverseRealSHT(lon_dft="pallas")` calls).  Per latitude row r of
// the stacked Legendre synthesis hm (rows, 2M, C) = [re | im]:
//
//   x[r] = [Ci; -Si]^T @ hm[r]      (W, C), fp32 or bf16 out
//
// with Ci, Si (M, W) the fp32 matrices of sht._dft_synthesis_matrices (k_m
// doubling, zeroed Nyquist sin row): JAX's re @ Ci - im @ Si.  hm is fp32 or
// bf16 (the bf16 Legendre GEMM's output on the "bfloat16" knob).
//
// Bound on the H100 at the itrans_up shape, x (1, 721, 1440, 256): hm 0.18
// GB + x 1.06 GB (fp32) = 1.24 GB -> 0.37 ms at 3.35 TB/s; 1.29e11 FLOP ->
// 1.92 ms at 67 TFLOP/s fp32 (operations) or 0.13 ms at 989 TFLOP/s bf16
// (bytes then bound it).
//
// Design (dft_rows.cuh): one block per (row, 256-longitude tile, channel
// tile of 64); K = 2M = 242 runs in slabs through shared memory.  The six
// longitude tiles of a row are adjacent blocks, so its hm row (248 KB at C
// = 256) comes from L2 after the first; the grid field is written once.

#include "dft_rows.cuh"

// Padding multiples of the prepared At (2M, W): axis 0 rows, axis 1 columns.
extern "C" int dft_synthesis_padding(int axis) { return dft_padding(axis); }

// at (k_pad, m_pad) prepared [Ci; -Si], bf16 if bf16_ops else fp32; hm
// (rows, 2m, c) fp32 or bf16 (hm_bf16); out (rows, w, c) fp32 or bf16
// (out_bf16).  bf16_ops: bf16 operands on the tensor cores, else fp32 FMA.
extern "C" int dft_synthesis(const void* at, const void* hm, void* out, long long rows, int w,
                             int m, int c, int k_pad, int m_pad, int hm_bf16, int out_bf16,
                             int bf16_ops, void* stream) {
  DftArgs a{};
  a.at = at;
  a.b = hm;
  a.out = out;
  a.rows = rows;
  a.k_dim = 2 * m;
  a.m_dim = w;
  a.c = c;
  a.k_pad = k_pad;
  a.m_pad = m_pad;
  cudaStream_t s = (cudaStream_t)stream;
  using bf = __nv_bfloat16;
  if (hm_bf16)
    return out_bf16 ? dft_rows_launch<bf, bf>(a, bf16_ops, s)
                    : dft_rows_launch<bf, float>(a, bf16_ops, s);
  return out_bf16 ? dft_rows_launch<float, bf>(a, bf16_ops, s)
                  : dft_rows_launch<float, float>(a, bf16_ops, s);
}
