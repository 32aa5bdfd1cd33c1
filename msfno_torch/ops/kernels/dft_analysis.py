"""Truncated forward longitude DFT: the `dft_analysis` CUDA kernel
(csrc/dft_analysis.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/dft.py:dft_analysis, which the JAX package
runs for `RealSHT(lon_dft="pallas")`.  Per latitude row of x (..., W, C):

    f = [C | -S]^T x          (2M, C) fp32, [re | im] on the mode axis

with C, S (W, M) from `sht._dft_analysis_matrices`: JAX's (fr, fi) =
(x @ C, -(x @ S)), written in the port's stacked (rows, 2M, C) layout that
`RealSHT.legendre_stacked` reads.  Operands are rounded to the `mxu_dtype`
operand type ("bfloat16": bf16; "float32"/"tensorfloat": fp32), products
are accumulated in fp32.  The kernel reads [C | -S] as `prepare` makes it
(merged, zero-padded, in the operand dtype), which the caller caches.
Bound on the H100 at the trans_down shape: fp32 operations, or bytes with
bf16 operands (see the kernel source).

No gradient: the JAX package cannot differentiate this path either (its
Pallas call has no reverse-mode rule), so the backward raises on every
device instead of returning a gradient JAX would not give.
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import check, library, stream_ptr
from msfno_torch.runtime import mxu_round

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)

NO_GRADIENT = ("the lon_dft='pallas' DFT kernels have no gradient: the JAX package "
               "cannot differentiate its Pallas DFT path either; use lon_dft='matmul' "
               "or 'fft' to train through the SHT")


# the kernels' padding of the prepared operand (dft_rows.cuh: DFT_K_MULTIPLE,
# DFT_BM), checked against the library at each launch
K_MULTIPLE, M_MULTIPLE = 32, 256


def pad_operand(at: torch.Tensor, mxu_dtype: str) -> torch.Tensor:
    """A merged DFT matrix At (K, M) as the kernels read it: zero-padded to
    multiples of (K_MULTIPLE, M_MULTIPLE), in the operand dtype (bf16 for
    "bfloat16", rounded to nearest even; else fp32)."""
    k, m = at.shape
    out = at.new_zeros((-(-k // K_MULTIPLE) * K_MULTIPLE, -(-m // M_MULTIPLE) * M_MULTIPLE),
                       dtype=torch.float32)
    out[:k, :m] = at
    return out.to(torch.bfloat16 if mxu_dtype == "bfloat16" else torch.float32)


def merged_analysis(cmat, smat) -> torch.Tensor:
    """[C | -S] (W, 2M) fp32."""
    return torch.cat([cmat.float(), -smat.float()], dim=1)


def prepare(cmat, smat, mxu_dtype) -> torch.Tensor:
    """The kernel's operand: `pad_operand` of [C | -S]."""
    return pad_operand(merged_analysis(cmat, smat), mxu_dtype)


def dft_analysis_plain(x, cmat, smat, mxu_dtype="float32"):
    """Plain version: x (..., W, C) fp32 or bf16, cmat / smat (W, M) ->
    (rows, 2M, C) fp32 with the kernel's rounding points: x and [C | -S]
    rounded to `mxu_dtype`, fp32 products and sums."""
    w, c = x.shape[-2:]
    return torch.matmul(mxu_round(merged_analysis(cmat, smat), mxu_dtype).t(),
                        mxu_round(x.reshape(-1, w, c), mxu_dtype))


def dft_analysis(x, cmat, smat, mxu_dtype="float32", prepared=None):
    """Forward longitude DFT of every latitude row (JAX `dft_analysis` with
    the output stacked): x (..., W, C) -> (rows, 2M, C) fp32.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    `prepared` is an optional `prepare(cmat, smat, mxu_dtype)` result cached
    by the caller."""
    return _DftAnalysis.apply(x, cmat, smat, mxu_dtype, prepared)


class _DftAnalysis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cmat, smat, mxu_dtype, prepared):
        return _forward(x, cmat, smat, mxu_dtype, prepared)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(NO_GRADIENT)


def operand_flags(name, x, mxu_dtype) -> tuple[int, int]:
    """(input is bf16, bf16 operands) for a DFT kernel call; raises on what
    the kernels do not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: input dtype {x.dtype} is not fp32 or bf16")
    if mxu_dtype not in ("float32", "tensorfloat", "bfloat16"):
        raise ValueError(f"{name}: unknown mxu dtype {mxu_dtype!r}")
    return int(x.dtype == torch.bfloat16), int(mxu_dtype == "bfloat16")


def check_operand(name, lib, at, k, m, bf16_ops) -> None:
    """Raise unless `at` is a prepared operand of a (k, m) DFT matrix for
    this operand type, padded as the library pads."""
    pad = getattr(lib, f"{name}_padding")
    pad.restype = ctypes.c_int
    if (pad(0), pad(1)) != (K_MULTIPLE, M_MULTIPLE):
        raise RuntimeError(f"{name}: the kernel's padding and the wrapper's differ")
    want = torch.bfloat16 if bf16_ops else torch.float32
    kp, mp = at.shape
    if (at.dtype != want or not at.is_contiguous() or kp % K_MULTIPLE or mp % M_MULTIPLE
            or kp < k or mp < m):
        raise ValueError(f"{name}: prepared operand {tuple(at.shape)} {at.dtype} does not "
                         f"fit a ({k}, {m}) matrix with {want} operands")


def _forward(x, cmat, smat, mxu_dtype, prepared):
    if x.device.type == "cpu":
        return dft_analysis_plain(x, cmat, smat, mxu_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dft_analysis: unsupported device {x.device}")
    x_bf16, bf16_ops = operand_flags("dft_analysis", x, mxu_dtype)
    w, c = x.shape[-2:]
    m = cmat.shape[-1]
    if cmat.shape != (w, m) or smat.shape != (w, m):
        raise ValueError(f"dft_analysis: cmat / smat must be ({w}, M), got "
                         f"{tuple(cmat.shape)} and {tuple(smat.shape)}")
    at = prepared if prepared is not None else prepare(cmat, smat, mxu_dtype)
    lib = library("dft_analysis")
    check_operand("dft_analysis", lib, at, w, 2 * m, bf16_ops)
    xc = x.contiguous()
    rows = xc.numel() // (w * c)
    out = torch.empty((rows, 2 * m, c), device=x.device, dtype=torch.float32)
    fn = lib.dft_analysis
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ctypes.c_longlong, i32, i32, i32, i32, i32, i32, i32, vp]
    fn.restype = ctypes.c_int
    status = fn(at.data_ptr(), xc.data_ptr(), out.data_ptr(), rows, w, m, c, at.shape[0],
                at.shape[1], x_bf16, bf16_ops, stream_ptr(x))
    check(status, "dft_analysis")
    global LAUNCHES
    LAUNCHES += 1
    return out
