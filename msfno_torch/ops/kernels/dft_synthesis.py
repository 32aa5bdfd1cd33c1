"""Truncated inverse longitude DFT: the `dft_synthesis` CUDA kernel
(csrc/dft_synthesis.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/dft.py:dft_synthesis, which the JAX package
runs for `InverseRealSHT(lon_dft="pallas")`.  Per latitude row of the
stacked Legendre synthesis hm (..., 2M, C) = [re | im]
(`InverseRealSHT._synthesis_hm`):

    x = [Ci; -Si]^T hm        (W, C)

with Ci, Si (M, W) from `sht._dft_synthesis_matrices`: JAX's re @ Ci -
im @ Si.  Operands are rounded to the `mxu_dtype` operand type, products are
accumulated in fp32, the result is written in `out_dtype` (fp32 by
default).  The kernel reads [Ci; -Si] as `prepare` makes it, which the
caller caches.  Bound on the H100 at the itrans_up shape: fp32 operations,
or bytes with bf16 operands (see the kernel source).  No gradient, as for
`dft_analysis`.
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import check, library, stream_ptr
from msfno_torch.ops.kernels.dft_analysis import (
    NO_GRADIENT,
    check_operand,
    operand_flags,
    pad_operand,
)
from msfno_torch.runtime import mxu_round, torch_dtype

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)


def merged_synthesis(ci, si) -> torch.Tensor:
    """[Ci; -Si] (2M, W) fp32."""
    return torch.cat([ci.float(), -si.float()], dim=0)


def prepare(ci, si, mxu_dtype) -> torch.Tensor:
    """The kernel's operand: `pad_operand` of [Ci; -Si]."""
    return pad_operand(merged_synthesis(ci, si), mxu_dtype)


def dft_synthesis_plain(hm, ci, si, mxu_dtype="float32", out_dtype=None):
    """Plain version: hm (..., 2M, C) fp32 or bf16, ci / si (M, W) ->
    (rows, W, C) in `out_dtype` (default fp32) with the kernel's rounding
    points: hm and [Ci; -Si] rounded to `mxu_dtype`, fp32 products and
    sums."""
    two_m, c = hm.shape[-2:]
    x = torch.matmul(mxu_round(merged_synthesis(ci, si), mxu_dtype).t(),
                     mxu_round(hm.reshape(-1, two_m, c), mxu_dtype))
    return x.to(torch_dtype(out_dtype or "float32"))


def dft_synthesis(hm, ci, si, mxu_dtype="float32", out_dtype=None, prepared=None):
    """Inverse longitude DFT of every latitude row (JAX `dft_synthesis` on
    the stacked input): hm (..., 2M, C) -> (rows, W, C) in `out_dtype`.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  `prepared` is an optional `prepare(ci, si, mxu_dtype)` result
    cached by the caller."""
    return _DftSynthesis.apply(hm, ci, si, mxu_dtype, out_dtype, prepared)


class _DftSynthesis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hm, ci, si, mxu_dtype, out_dtype, prepared):
        return _forward(hm, ci, si, mxu_dtype, out_dtype, prepared)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(NO_GRADIENT)


def _forward(hm, ci, si, mxu_dtype, out_dtype, prepared):
    if hm.device.type == "cpu":
        return dft_synthesis_plain(hm, ci, si, mxu_dtype, out_dtype)
    if hm.device.type != "cuda":
        raise ValueError(f"dft_synthesis: unsupported device {hm.device}")
    hm_bf16, bf16_ops = operand_flags("dft_synthesis", hm, mxu_dtype)
    od = torch_dtype(out_dtype or "float32")
    if od not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dft_synthesis: unsupported out dtype {od}")
    two_m, c = hm.shape[-2:]
    m, w = ci.shape
    if two_m != 2 * m or si.shape != (m, w):
        raise ValueError(f"dft_synthesis: hm (..., {two_m}, C) needs ci / si of shape "
                         f"({two_m // 2}, W), got {tuple(ci.shape)} and {tuple(si.shape)}")
    at = prepared if prepared is not None else prepare(ci, si, mxu_dtype)
    lib = library("dft_synthesis")
    check_operand("dft_synthesis", lib, at, two_m, w, bf16_ops)
    hc = hm.contiguous()
    rows = hc.numel() // (two_m * c)
    out = torch.empty((rows, w, c), device=hm.device, dtype=od)
    fn = lib.dft_synthesis
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ctypes.c_longlong, i32, i32, i32, i32, i32, i32, i32, i32, vp]
    fn.restype = ctypes.c_int
    status = fn(at.data_ptr(), hc.data_ptr(), out.data_ptr(), rows, w, m, c, at.shape[0],
                at.shape[1], hm_bf16, int(od == torch.bfloat16), bf16_ops, stream_ptr(hm))
    check(status, "dft_synthesis")
    global LAUNCHES
    LAUNCHES += 1
    return out
