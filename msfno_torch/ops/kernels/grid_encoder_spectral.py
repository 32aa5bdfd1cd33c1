"""Fused encoder MLP + positional embedding + instance-norm statistics +
forward longitude DFT: the `grid_encoder_spectral` CUDA kernel
(csrc/grid_encoder_spectral.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/grid_mlp.py:grid_encoder_spectral (the JAX
counterpart lives in grid_mlp.py).  Per pixel, then per latitude row:

    y = gelu_exact(x @ W1 + b1) @ W2 [+ pe]            (B, H, W, C) fp32
    ssum, ssq = sum(y), sum(y^2) over (H, W)            (B, C) fp32
    f[b, h] = cs^T @ y[b, h]                            (B, H, 2M, C)

with cs (W, 2M) the merged [C | -S] analysis matrix (`RealSHT.merged_analysis`)
and f the stacked [re | im] longitude modes that `RealSHT.legendre_stacked`
completes into the forward SHT.  The grid-space encoder output is never
stored in fp32: the kernel runs in two passes (see its source), the
encoder MLP over 128-pixel tiles with per-tile column sums of y and y^2
added in a fixed order, writing bf16 y, then the bf16 forward DFT of
`dft_analysis` on it.  On fp32 operands ("float32", "tensorfloat") the
same two passes run nothing rounded: the encoder MLP of csrc/mlp_f32.cuh,
its products split-precision (three TF32 tensor-core passes over hi / lo
splits, `tf32x3`), writes fp32 y, and the fp32 DFT of `dft_analysis` (the
even/odd fold) reads it.  `encoder_mlp_tiles`, `tile_stats_reduce` and
`dft_pass` are plain mirrors of that decomposition, `encoder_f32_passes`
of the fp32 one (tests only).  Bound on
the H100 at the serving shapes: operations (see the kernel source).  The
JAX package has no backward kernel here: its gradient is the VJP of
`_ref_encoder_spectral` (grid_mlp.py:521-560: fp32 MLP, y and cs rounded
before the DFT), and so it is here.
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import (TILE_ROWS, check, check_prepared, kernel_operand, library,
                                     mlp_f32, operand_dtype, reference_vjp, stats_scratch,
                                     stream_ptr)
from msfno_torch.ops.kernels import dft_analysis
from msfno_torch.ops.kernels.dft_analysis import (BF16_K, BF16_TILE, FOLD_K, FOLD_TILE, _ceil,
                                                  aligned, check_operand)
# REDUCE_GROUPS and tile_stats_reduce are re-exported for the tail's modules and the tests
from msfno_torch.ops.kernels import REDUCE_GROUPS, tile_stats_reduce  # noqa: F401
from msfno_torch.ops.kernels.grid_mlp import _pad16, grid_mlp_reference, prepare_weights
from msfno_torch.ops.kernels.tf32x3 import matmul_tf32x3
from msfno_torch.runtime import mxu_round, torch_dtype

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)

# the K-stage of the tail's kernels (CH_BK / CHUNK in spectral_decoder.cu and
# spectral_decoder_bwd.cu): the rows of their Mt operand are zero-padded to a
# multiple of it
DFT_ROW_MULTIPLE = 64


def grid_encoder_spectral_reference(x, w1, b1, w2, pe, cs, mxu_dtype="bfloat16",
                                    out_dtype=None):
    """Plain version with the Pallas kernel's rounding points
    (grid_mlp.py:426-446): x, W1, W2 and the GELU output rounded to
    `mxu_dtype` before their GEMMs; y = fp32 GEMM + pe, its statistics taken
    before any rounding; y and cs rounded to `mxu_dtype` for the DFT, which
    accumulates in fp32; f rounded to `out_dtype` (default bf16).  Same
    signature and returns as `grid_encoder_spectral`."""
    bsz, h, w, _ = x.shape
    y, ssum, ssq = grid_mlp_reference(x, w1, b1, w2, pe=pe, mxu_dtype=mxu_dtype,
                                      out_dtype="float32", stats_rows=h * w)
    c = y.shape[-1]
    ym = mxu_round(y, mxu_dtype).reshape(bsz * h, w, c)
    csm = mxu_round(cs, mxu_dtype)
    f = torch.matmul(csm.t(), ym)  # (B*H, 2M, C)
    od = torch_dtype(out_dtype or "bfloat16")
    return f.reshape(bsz, h, -1, c).to(od), ssum, ssq


def encoder_mlp_tiles(x, w1, b1, w2, pe, mxu_dtype="bfloat16", tile=TILE_ROWS):
    """Plain mirror of the kernel's first pass (tests only): per sample, the
    encoder MLP with the kernel's rounding points over tiles of `tile`
    consecutive pixels of the flattened (H*W) grid, the last one ragged.
    Returns (y rounded to `mxu_dtype`, (B, H*W, C); each tile's column sums
    of the unrounded y and y^2, each (B, tiles, C) fp32: the sums over its
    8 groups of 16 rows, added in order)."""
    bsz, h, w, _ = x.shape
    y = grid_mlp_reference(x, w1, b1, w2, pe=pe, mxu_dtype=mxu_dtype, out_dtype="float32")
    y = y.reshape(bsz, h * w, -1)
    return (mxu_round(y, mxu_dtype), *_tile_partials(y, tile))


def _tile_partials(y, tile=TILE_ROWS):
    """Each `tile`-row tile's column sums of y (B, rows, C) and y^2, each (B,
    tiles, C): the sums over its groups of 16 rows, added in order."""
    bsz, rows, _ = y.shape
    tiles = -(-rows // tile)
    pad = y.new_zeros((bsz, tiles * tile - rows, y.shape[-1]))
    yt = torch.cat([y, pad], dim=1).reshape(bsz, tiles, tile // 16, 16, -1)
    s, q = yt.sum(3), (yt * yt).sum(3)
    ps, pq = s[:, :, 0], q[:, :, 0]
    for r in range(1, tile // 16):
        ps, pq = ps + s[:, :, r], pq + q[:, :, r]
    return ps, pq


def encoder_f32_passes(x, w1, b1, w2, pe, cs, out_dtype=None):
    """Plain mirror of the fp32-operand kernel (tests only): the encoder MLP
    in fp32, its two products the split-precision product
    (`tf32x3.matmul_tf32x3`), + pe; the statistics' tile partials
    (`_tile_partials`) added by `tile_stats_reduce`; the folded forward DFT
    of y (`dft_pass`).  Same returns as `grid_encoder_spectral`."""
    bsz, h, w, _ = x.shape
    hid = torch.nn.functional.gelu(matmul_tf32x3(x.float(), w1.float()) + b1.float(),
                                   approximate="none")
    y = matmul_tf32x3(hid, w2.float())
    if pe is not None:
        y = y + pe.float()
    y = y.reshape(bsz, h * w, -1)
    part_sum, part_sq = _tile_partials(y)
    f = dft_pass(y, cs, w, "float32", out_dtype or "float32")
    return f, tile_stats_reduce(part_sum), tile_stats_reduce(part_sq)


def dft_pass(y, cs, w, mxu_dtype="bfloat16", out_dtype=None):
    """Plain mirror of the kernel's second pass (tests only): the forward DFT
    of the rounded y (B, H*W, C) per latitude row, through the prepared
    operand of `prepare` (bf16: [C | -S]^T; fp32: the even/odd fold of
    `dft_analysis`), f rounded to `out_dtype` (default bf16).  Returns
    (B, H, 2M, C)."""
    bsz, hw, c = y.shape
    two_m = cs.shape[1]
    rows = y.float().reshape(bsz * (hw // w), w, c)
    if mxu_dtype == "bfloat16":
        f = torch.matmul(_dft_operand(cs).float()[:two_m, :w], rows)
    else:
        f = dft_analysis.dft_analysis_folded(rows, *_analysis_pair(cs))
    od = torch_dtype(out_dtype or "bfloat16")
    return f.reshape(bsz, hw // w, two_m, c).to(od)


def _dft_operand(cs: torch.Tensor) -> torch.Tensor:
    """[C | -S]^T (2M padded to BF16_TILE, W padded to BF16_K) in bf16: the
    operand of the bf16 DFT pass, as `dft_analysis.prepare` builds it."""
    w, two_m = cs.shape
    out = cs.new_zeros((_ceil(two_m, BF16_TILE), _ceil(w, BF16_K)), dtype=torch.float32)
    out[:two_m, :w] = cs.t()
    return out.to(torch.bfloat16)


# the numerator (odd, x^1 .. x^13) and denominator (even, x^0 .. x^8)
# coefficients of the kernels' f32 erf (chain_gemm.cuh:gelu_rational)
_ERF_P = (-1.60960333262415e-02, -2.95459980854025e-03, -7.34990630326855e-04,
          -5.69250639462346e-05, -2.10102402082508e-06, 2.77068142495902e-08,
          -2.72614225801306e-10)
_ERF_Q = (-1.42647390514189e-02, -7.37332916720468e-03, -1.68282697438203e-03,
          -2.13374055278905e-04, -1.45660718464996e-05)


def erf_rational(x: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the erf inside the head's and tail's GELU (tests
    only): x clamped to [-4, 4], an odd rational approximation in fp32."""
    x = x.float().clamp(-4.0, 4.0)
    x2 = x * x
    p = torch.full_like(x, _ERF_P[-1])
    for c in reversed(_ERF_P[:-1]):
        p = p * x2 + c
    q = torch.full_like(x, _ERF_Q[-1])
    for c in reversed(_ERF_Q[:-1]):
        q = q * x2 + c
    return x * p / q


def pad_dft_matrix(mat: torch.Tensor) -> torch.Tensor:
    """The tail kernels' (W, 2M) Mt operand in bf16, zero-padded to
    (DFT_ROW_MULTIPLE-multiple rows, 16-multiple columns)."""
    w, two_m = mat.shape
    w_pad = -(-w // DFT_ROW_MULTIPLE) * DFT_ROW_MULTIPLE
    out = torch.zeros((w_pad, _pad16(two_m)), dtype=torch.bfloat16, device=mat.device)
    out[:w, :two_m] = mat
    return out


def _analysis_pair(cs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, S), each (W, M), of the merged [C | -S] analysis matrix."""
    m = cs.shape[1] // 2
    return cs[:, :m], -cs[:, m:]


def prepare(w1, w2, cs, mxu_dtype="bfloat16"):
    """The kernel's operands for `mxu_dtype`: `grid_mlp.prepare_weights` of
    the MLP and the DFT pass's operand (bf16: [C | -S]^T, as
    `dft_analysis.prepare` builds its bf16 one; fp32: the fold's half
    matrices of `dft_analysis.prepare`), and for fp32 operands the MLP's
    split-precision B operands (`tf32x3.kmajor_split`: hi and lo, K-major,
    rows zero-padded) of W1^T and W2^T."""
    w1p, w2p, *splits = prepare_weights(w1, w2, w1.shape[0], mxu_dtype)
    if operand_dtype(mxu_dtype) == torch.float32:
        return w1p, w2p, dft_analysis.prepare(*_analysis_pair(cs), mxu_dtype), *splits
    return w1p, w2p, _dft_operand(cs)


def grid_encoder_spectral(x, w1, b1, w2, pe, cs, mxu_dtype="bfloat16", out_dtype=None,
                          prepared=None):
    """Encoder MLP + pe + statistics + forward DFT in one pass (JAX
    `grid_encoder_spectral` API).

    x: (B, H, W, C_in); w1: (C_in, hidden); w2: (hidden, C); pe: (H, W, C)
    or None; cs: (W, 2M).  Returns (f (B, H, 2M, C) in `out_dtype` (default
    bf16), ssum (B, C), ssq (B, C)) with fp32 sums over the H*W pixels.  A
    CPU tensor takes the plain version; a CUDA tensor launches the kernel or
    raises.  `prepared` is an optional `prepare` result cached by the
    caller."""
    return _GridEncoderSpectral.apply(x, w1, b1, w2, pe, cs, mxu_dtype, out_dtype, prepared)


def _ref_encoder_spectral(x, w1, b1, w2, pe, cs, mxu_dtype, out_dtype):
    """Port of the JAX `_ref_encoder_spectral`: the encoder MLP in fp32, y and
    cs rounded to `mxu_dtype` before the DFT (the rounding passes the
    gradient straight through, as `astype` does in JAX), statistics of the
    unrounded y."""
    bsz, h, w, _ = x.shape
    y = grid_mlp_reference(x, w1, b1, w2, pe=pe, mxu_dtype="float32", out_dtype="float32")
    ym = y + (mxu_round(y, mxu_dtype) - y).detach()
    f = torch.matmul(mxu_round(cs, mxu_dtype).t(), ym.reshape(bsz * h, w, -1))
    od = torch_dtype(out_dtype or "bfloat16")
    f = f + (f.to(od).float() - f).detach()
    ys = y.reshape(bsz, h * w, -1)
    return f.reshape(bsz, h, -1, y.shape[-1]), ys.sum(1), (ys * ys).sum(1)


class _GridEncoderSpectral(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, pe, cs, mxu_dtype, out_dtype, prepared):
        out = _forward(x, w1, b1, w2, pe, cs, mxu_dtype, out_dtype, prepared)
        ctx.save_for_backward(x, w1, b1, w2, pe, cs)
        ctx.opts = (mxu_dtype, out_dtype)
        return out

    @staticmethod
    def backward(ctx, *grads):
        mxu_dtype, out_dtype = ctx.opts
        d = reference_vjp(lambda *t: _ref_encoder_spectral(*t, mxu_dtype, out_dtype),
                          ctx.saved_tensors, ctx.needs_input_grad[:6], grads)
        return (*d, None, None, None)


def _forward(x, w1, b1, w2, pe, cs, mxu_dtype, out_dtype, prepared):
    if x.device.type == "cpu":
        return grid_encoder_spectral_reference(x, w1, b1, w2, pe, cs, mxu_dtype, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grid_encoder_spectral: unsupported device {x.device}")
    f32 = operand_dtype(mxu_dtype) == torch.float32
    bsz, h, w, c_in = x.shape
    hidden, c = w1.shape[1], w2.shape[1]
    two_m = cs.shape[1]
    if (w1.shape[0] != c_in or b1.shape != (hidden,) or w2.shape[0] != hidden
            or cs.shape[0] != w or (pe is not None and pe.numel() != h * w * c)):
        raise ValueError("grid_encoder_spectral: operand shapes do not match x "
                         "(B, H, W, C_in), w1 (C_in, hidden), w2 (hidden, C), "
                         "pe (H, W, C) and cs (W, 2M)")
    if not f32 and (hidden % 16 or c % 16 or max(c_in, hidden, c) > 256):
        raise ValueError(f"grid_encoder_spectral: hidden {hidden} and C {c} must be "
                         f"multiples of 16, and C_in {c_in}, hidden and C at most 256")
    if prepared is None:
        prepared = prepare(w1, w2, cs, mxu_dtype)
    check_prepared("grid_encoder_spectral", prepared, mxu_dtype)
    w1p, w2p, cst = prepared[:3]
    od = torch_dtype(out_dtype or "bfloat16")
    if od not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grid_encoder_spectral: unsupported out dtype {od}")
    if f32:
        return _forward_f32(x, w1p, b1, w2p, pe, cst, *prepared[3:], two_m, od)
    xf, x_bf16 = kernel_operand(x)
    xf = aligned(xf)
    pef, pe_bf16 = kernel_operand(pe) if pe is not None else (None, 0)
    if pef is not None:  # bf16 pe comes by TMA, fp32 pe in pairs
        pef = aligned(pef)
    b1f = b1.float().contiguous()
    dev = x.device
    y = torch.empty((bsz, h * w, c), dtype=torch.bfloat16, device=dev)  # bf16 y, pass 1 -> 2
    f = torch.empty((bsz, h, two_m, c), dtype=od, device=dev)
    (part_sum, part_sq, grp_sum, grp_sq, ssum, ssq), groups = stats_scratch(bsz, h * w, c, dev)

    lib = library("grid_encoder_spectral")
    check_operand("grid_encoder_spectral", lib, cst,
                  (_ceil(two_m, BF16_TILE), _ceil(w, BF16_K)), bf16_ops=1)
    lib.grid_encoder_spectral_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.grid_encoder_spectral_bf16.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * 14)(*[
        t.data_ptr() if t is not None else None
        for t in (xf, w1p, b1f, w2p, pef, cst, y, f, part_sum, part_sq, grp_sum, grp_sq, ssum,
                  ssq)
    ])
    ints = (ctypes.c_longlong * 14)(
        bsz, h, w, c_in, w1p.shape[0], hidden, c, two_m, cst.shape[0], cst.shape[1],
        x_bf16, pe_bf16, int(od == torch.bfloat16), groups,
    )
    status = lib.grid_encoder_spectral_bf16(ptrs, ints, stream_ptr(x))
    check(status, "grid_encoder_spectral")
    global LAUNCHES
    LAUNCHES += 1
    return f, ssum, ssq


def _forward_f32(x, w1p, b1, w2p, pe, at, w1t_x3, w2t_x3, two_m, od):
    """The fp32-operand kernel: the encoder MLP on the split-precision core,
    B the prepared hi / lo halves of W1^T and W2^T, into an fp32 y scratch,
    then the folded forward DFT of y (csrc/grid_encoder_spectral.cu)."""
    bsz, h, w, c_in = x.shape
    hidden, c = w2p.shape
    if (w1t_x3.shape[:2] != (2, hidden) or w1t_x3.shape[2] < c_in
            or w2t_x3.shape[:2] != (2, c) or w2t_x3.shape[2] < hidden):
        raise ValueError("grid_encoder_spectral: prepared split weights do not match the MLP")
    lib = library("grid_encoder_spectral")
    check_operand("grid_encoder_spectral", lib, at,
                  (_ceil(w // 2 + 1, FOLD_K), 2 * FOLD_TILE * -(-(two_m // 2) // FOLD_TILE)),
                  bf16_ops=0)
    xf, _ = kernel_operand(x)
    y = torch.empty((bsz * h * w, c), device=x.device)  # fp32 y, pass 1 -> 2
    f = torch.empty((bsz, h, two_m, c), dtype=od, device=x.device)
    ptrs, ints, _keep, (ssum, ssq) = mlp_f32.mlp_args(
        xf.reshape(-1, c_in), w1t_x3, b1, w2t_x3, pe=pe, out=y, samples=bsz, stats=True)
    # fp32 x of a width that is no multiple of 4 (73): the kernel copies it
    # into 16-byte rows for its first GEMM's loader
    xp = (torch.empty((bsz * h * w, -(-c_in // 4) * 4), device=x.device)
          if c_in % 4 and xf.dtype == torch.float32 else None)
    ptrs += [at.data_ptr(), f.data_ptr(), xp.data_ptr() if xp is not None else None]
    ints += [bsz, h, w, two_m // 2, at.shape[0], at.shape[1], int(od == torch.bfloat16)]
    mlp_f32.launch("grid_encoder_spectral", "grid_encoder_spectral_f32", ptrs, ints,
                   stream_ptr(x))
    global LAUNCHES
    LAUNCHES += 1
    return f, ssum, ssq
