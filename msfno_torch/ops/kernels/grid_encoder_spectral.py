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
stored.  Bound on the H100 at the serving shapes: operations (see the kernel
source).  The JAX package has no backward kernel here: its gradient is the
VJP of `_ref_encoder_spectral` (grid_mlp.py:521-560: fp32 MLP, y and cs
rounded before the DFT), and so it is here.
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import check, library, reference_vjp, stream_ptr
from msfno_torch.ops.kernels.grid_mlp import _act, _pad16, grid_mlp_reference, prepare_weights
from msfno_torch.runtime import mxu_round, torch_dtype

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)

# the longitude chunk of both DFT kernels (CHUNK in their sources): the rows
# of their DFT operand are zero-padded to a multiple of it
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


def pad_dft_matrix(mat: torch.Tensor) -> torch.Tensor:
    """A DFT kernel's (W, 2M) operand in bf16, zero-padded to
    (DFT_ROW_MULTIPLE-multiple rows, 16-multiple columns)."""
    w, two_m = mat.shape
    w_pad = -(-w // DFT_ROW_MULTIPLE) * DFT_ROW_MULTIPLE
    out = torch.zeros((w_pad, _pad16(two_m)), dtype=torch.bfloat16, device=mat.device)
    out[:w, :two_m] = mat
    return out


def prepare(w1, w2, cs):
    """The kernel's bf16 operands: `grid_mlp.prepare_weights` of the MLP and
    the padded DFT matrix."""
    return (*prepare_weights(w1, w2, w1.shape[0]), pad_dft_matrix(cs))


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
    if mxu_dtype != "bfloat16":
        raise NotImplementedError(
            "grid_encoder_spectral: the CUDA kernel takes bf16 operands; an "
            f"fp32 kernel ({mxu_dtype!r}) comes in a later slice"
        )
    bsz, h, w, c_in = x.shape
    hidden, c = w1.shape[1], w2.shape[1]
    two_m = cs.shape[1]
    if (w1.shape[0] != c_in or b1.shape != (hidden,) or w2.shape[0] != hidden
            or cs.shape[0] != w or (pe is not None and pe.numel() != h * w * c)):
        raise ValueError("grid_encoder_spectral: operand shapes do not match x "
                         "(B, H, W, C_in), w1 (C_in, hidden), w2 (hidden, C), "
                         "pe (H, W, C) and cs (W, 2M)")
    if hidden % 16 or c % 16:
        raise ValueError(f"grid_encoder_spectral: hidden {hidden} and C {c} must be "
                         "multiples of 16")
    if prepared is None:
        prepared = prepare(w1, w2, cs)
    w1p, w2p, csp = prepared
    od = torch_dtype(out_dtype or "bfloat16")
    if od not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grid_encoder_spectral: unsupported out dtype {od}")
    xf, x_bf16 = _act(x)
    pef, pe_bf16 = _act(pe) if pe is not None else (None, 0)
    if pef is not None and pef.data_ptr() % 16:  # the kernel copies pe rows in 16-byte vectors
        pef = pef.clone()
    b1f = b1.float().contiguous()
    dev = x.device
    f = torch.empty((bsz, h, two_m, c), dtype=od, device=dev)
    part_sum = torch.empty((bsz, h, c), device=dev)
    part_sq = torch.empty_like(part_sum)
    ssum = torch.empty((bsz, c), device=dev)
    ssq = torch.empty_like(ssum)

    lib = library("grid_encoder_spectral")
    lib.grid_encoder_spectral_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.grid_encoder_spectral_bf16.restype = ctypes.c_int
    lib.grid_encoder_spectral_chunk.restype = ctypes.c_int
    if lib.grid_encoder_spectral_chunk() != DFT_ROW_MULTIPLE:
        raise RuntimeError("grid_encoder_spectral: kernel chunk and DFT_ROW_MULTIPLE differ")
    ptrs = (ctypes.c_void_p * 11)(*[
        t.data_ptr() if t is not None else None
        for t in (xf, w1p, b1f, w2p, pef, csp, f, part_sum, part_sq, ssum, ssq)
    ])
    ints = (ctypes.c_longlong * 14)(
        bsz, h, w, c_in, w1p.shape[0], hidden, c, two_m, csp.shape[1], csp.shape[0],
        x_bf16, pe_bf16, int(od == torch.bfloat16), int(pe is not None),
    )
    status = lib.grid_encoder_spectral_bf16(ptrs, ints, stream_ptr(x))
    check(status, "grid_encoder_spectral")
    global LAUNCHES
    LAUNCHES += 1
    return f, ssum, ssq
