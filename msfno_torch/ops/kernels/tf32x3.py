"""The split-precision TF32 product of the fp32-operand kernels
(csrc/row_gemm.cuh:gemm_tf32x3): the operand split, the prepared layout of
a weight operand, a plain mirror of the product (tests only) and the core's
own entry point (tests only).

An fp32 value x is split into hi = rna_tf32(x) and lo = rna_tf32(x - hi),
rna_tf32 the nearest tf32 value with ties away from zero (`cvt.rna.tf32.f32`:
the tensor cores read only a tf32 operand's top 19 bits, so a value not
rounded this way would be truncated).  |x - hi - lo| <= 2^-22 |x|.  A
product a b is a_lo b_hi + a_hi b_lo + a_hi b_hi, three TF32 tensor-core
passes with fp32 accumulation: only a_lo b_lo (< 2^-22 |a b|) is
dropped, so each product keeps about 21 of fp32's 24 significand bits, and
at 495 / 3 = 165 TFLOP/s it is the least time of an fp32-class product on
the H100 (fp32 FMA on the CUDA cores: 67 TFLOP/s).
"""

from __future__ import annotations

import ctypes

import torch

K_PAD = 16  # the K-major rows of a prepared operand: a multiple of this many floats


def rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (fp32) rounded to the nearest tf32 value, ties away from zero, by
    integer ops on the float32 bits: half a tf32 ulp added to the magnitude,
    then the 13 low significand bits cleared."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), fp32: hi = rna_tf32(x), lo = rna_tf32(x - hi)."""
    hi = rna_tf32(x)
    return hi, rna_tf32(x.float() - hi)


def kmajor_split(b: torch.Tensor) -> torch.Tensor:
    """The kernels' prepared form of a weight operand b (K x N): (2, N,
    K_pad) fp32, the hi and lo halves of b^T, each row zero-padded to a
    multiple of K_PAD floats (a TMA row stride is a 16-byte multiple; tf32
    wgmma reads both operands K-major)."""
    k, n = b.shape
    k_pad = -(-k // K_PAD) * K_PAD
    out = torch.zeros((2, n, k_pad), dtype=torch.float32, device=b.device)
    hi, lo = split_tf32(b.t())
    out[0, :, :k] = hi
    out[1, :, :k] = lo
    return out


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the kernels' product (tests only): a (..., K) @ b (K,
    N) as a_lo b_hi + a_hi b_lo + a_hi b_hi over the tf32 splits, the small
    terms first, in fp32 (each tf32 x tf32 product is exact in fp32)."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def tf32x3_matmul(a: torch.Tensor, b: torch.Tensor, bn: int = 128, seg_rows: int = 0,
                  splits: int = 1) -> torch.Tensor:
    """a (m, k) @ b (k, n) on the split-precision core alone (tests): on a
    CUDA tensor one launch of `tf32x3_matmul` (csrc/spectral_mlp.cu) on
    bn-column tiles (80, 112 or 128), its rows in segments of seg_rows (0:
    one), K in `splits` ranges; returns the partial products (splits, m, n).
    On a CPU tensor the plain mirror, (1, m, n)."""
    if a.device.type == "cpu":
        return matmul_tf32x3(a.float(), b.float())[None]
    if a.device.type != "cuda":
        raise ValueError(f"tf32x3_matmul: unsupported device {a.device}")
    from msfno_torch.ops.kernels import check, library, stream_ptr

    m, k = a.shape
    n = b.shape[1]
    a = a.float().contiguous()
    bx = kmajor_split(b)
    c = torch.zeros((splits, m, n), dtype=torch.float32, device=a.device)
    fn = library("spectral_mlp").tf32x3_matmul
    vp, ll = ctypes.c_void_p, ctypes.c_longlong
    fn.argtypes = [vp, ll, vp, vp, ll, vp, ll, ctypes.c_int, ctypes.c_int, ctypes.c_int, ll,
                   ctypes.c_int, ctypes.c_int, vp]
    fn.restype = ctypes.c_int
    check(fn(a.data_ptr(), k, bx[0].data_ptr(), bx[1].data_ptr(), bx.shape[2], c.data_ptr(), n,
             m, n, k, seg_rows, splits, bn, stream_ptr(a)), "tf32x3_matmul")
    return c
