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
default).  The kernel reads its operand as `prepare` makes it, which the
caller caches:

- fp32 operands: the even/odd fold.  P_w = re . Ci[:, w] and Q_w = im .
  Si[:, w] for the W/2 + 1 longitudes 0 <= w <= W/2; then x_w = P_w - Q_w
  and x_{W-w} = P_w + Q_w (w = 0 and, for even W, w = W/2 write one
  longitude): half the multiply-adds of the dense product
  (`dft_synthesis_folded` is its plain mirror).  This needs Ci[:, W-w] =
  Ci[:, w] and Si[:, W-w] = -Si[:, w], which the matrices of
  `sht._dft_synthesis_matrices` have: `prepare` raises ValueError on
  matrices without that symmetry.
- bf16 operands: the dense [Ci; -Si]^T in bf16.

The plain version is the dense product.  No gradient, as for
`dft_analysis`.
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import check, library, stream_ptr
from msfno_torch.ops.kernels.dft_analysis import (
    BF16_K,
    BF16_TILE,
    FOLD_K,
    FOLD_TILE,
    NO_GRADIENT,
    _ceil,
    aligned,
    check_fold_symmetry,
    check_operand,
    fold_maps,
    operand_flags,
)
from msfno_torch.runtime import mxu_round, torch_dtype

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)


def merged_synthesis(ci, si) -> torch.Tensor:
    """[Ci; -Si] (2M, W) fp32."""
    return torch.cat([ci.float(), -si.float()], dim=0)


def _check_shapes(ci, si) -> None:
    if ci.dim() != 2 or ci.shape != si.shape:
        raise ValueError(f"dft_synthesis: ci / si must be two (M, W) matrices, got "
                         f"{tuple(ci.shape)} and {tuple(si.shape)}")


def prepare(ci, si, mxu_dtype) -> torch.Tensor:
    """The kernel's operand for `mxu_dtype`.  fp32 operands: the fold's
    half matrices (M_pad, 256 * ceil(kh / 128)) fp32, kh = W // 2 + 1, M
    padded to FOLD_K; longitude tile t holds Ci's longitudes [128 t, 128 t
    + 128) in columns [256 t, 256 t + 128) and Si's in the next 128.  bf16
    operands: [Ci; -Si]^T (W padded to BF16_K, 2M padded to BF16_TILE) in
    bf16, rounded to nearest even.  Raises ValueError on matrices whose
    shapes disagree or, for the fold, that lack its symmetry."""
    _check_shapes(ci, si)
    m, w = ci.shape
    if mxu_dtype == "bfloat16":
        out = ci.new_zeros((_ceil(w, BF16_K), _ceil(2 * m, BF16_TILE)), dtype=torch.float32)
        out[:w, :2 * m] = merged_synthesis(ci, si).t()
        return out.to(torch.bfloat16)
    if mxu_dtype not in ("float32", "tensorfloat"):
        raise ValueError(f"dft_synthesis: unknown mxu dtype {mxu_dtype!r}")
    check_fold_symmetry("dft_synthesis", ci, si, axis=1)
    kh = w // 2 + 1
    tiles = -(-kh // FOLD_TILE)
    out = ci.new_zeros((_ceil(m, FOLD_K), 2 * FOLD_TILE * tiles), dtype=torch.float32)
    half = out[:m].view(m, tiles, 2, FOLD_TILE)
    for t in range(tiles):
        ww = min(FOLD_TILE, kh - t * FOLD_TILE)
        half[:, t, 0, :ww] = ci[:, t * FOLD_TILE:t * FOLD_TILE + ww].float()
        half[:, t, 1, :ww] = si[:, t * FOLD_TILE:t * FOLD_TILE + ww].float()
    return out


def dft_synthesis_plain(hm, ci, si, mxu_dtype="float32", out_dtype=None):
    """Plain version: hm (..., 2M, C) fp32 or bf16, ci / si (M, W) ->
    (rows, W, C) in `out_dtype` (default fp32) with the kernel's rounding
    points: hm and [Ci; -Si] rounded to `mxu_dtype`, fp32 products and
    sums."""
    two_m, c = hm.shape[-2:]
    x = torch.matmul(mxu_round(merged_synthesis(ci, si), mxu_dtype).t(),
                     mxu_round(hm.reshape(-1, two_m, c), mxu_dtype))
    return x.to(torch_dtype(out_dtype or "float32"))


def dft_synthesis_folded(hm, ci, si):
    """Plain mirror of the fp32 kernel's folded algebra (tests only): P / Q
    over `prepare`'s half matrices, then the unfold by the index maps.  hm
    (..., 2M, C) -> (rows, W, C) fp32."""
    two_m, c = hm.shape[-2:]
    m, w = ci.shape
    at = prepare(ci, si, "float32")
    kh = w // 2 + 1
    hr = hm.reshape(-1, two_m, c).float()
    half = at[:m].view(m, -1, 2, FOLD_TILE)
    cih = half[:, :, 0].reshape(m, -1)[:, :kh]
    sih = half[:, :, 1].reshape(m, -1)[:, :kh]
    p = torch.matmul(cih.t(), hr[:, :m])
    q = torch.matmul(sih.t(), hr[:, m:])
    mirror, paired = fold_maps(w)
    out = hr.new_empty((hr.shape[0], w, c))
    out[:, mirror[paired]] = (p + q)[:, paired]
    out[:, :kh] = p - q
    return out


def dft_synthesis(hm, ci, si, mxu_dtype="float32", out_dtype=None, prepared=None):
    """Inverse longitude DFT of every latitude row (JAX `dft_synthesis` on
    the stacked input): hm (..., 2M, C) -> (rows, W, C) in `out_dtype`.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  `prepared` is an optional `prepare(ci, si, mxu_dtype)` result
    cached by the caller.  With fp32 operands the kernel folds the DFT and
    takes only the symmetric matrices of ops.sht (see the module's note)."""
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
    _check_shapes(ci, si)
    two_m, c = hm.shape[-2:]
    m, w = ci.shape
    if two_m != 2 * m:
        raise ValueError(f"dft_synthesis: hm (..., {two_m}, C) needs ci / si of shape "
                         f"({two_m // 2}, W), got {tuple(ci.shape)}")
    if bf16_ops and c > 128 and c * hm.element_size() % 16:
        # JAX's kernel takes C <= 128 or a multiple of 128 only
        raise ValueError(f"dft_synthesis: {c} channels of {hm.dtype}: above 128 the rows "
                         "must be multiples of 16 bytes")
    at = prepared if prepared is not None else prepare(ci, si, mxu_dtype)
    want = ((_ceil(w, BF16_K), _ceil(2 * m, BF16_TILE)) if bf16_ops else
            (_ceil(m, FOLD_K), 2 * FOLD_TILE * (-(-(w // 2 + 1) // FOLD_TILE))))
    lib = library("dft_synthesis")
    check_operand("dft_synthesis", lib, at, want, bf16_ops)
    hc = aligned(hm)
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
