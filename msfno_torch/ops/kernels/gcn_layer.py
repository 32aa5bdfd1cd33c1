"""One masked-grid GCN layer: the `gcn_layer` CUDA kernel
(csrc/gcn_layer.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/gcn_layer.py:gcn_layer:

    out = residual + leaky_relu((box3(x @ W * d) * d + b) * mask, slope)

with box3 the 3x3 neighbour sum (periodic in longitude, zero past the poles)
and d = D^{-1/2}.  The kernel runs it in two passes, mirrored by
`gcn_t_pass` (t = x @ W * d in fp32) and `gcn_stencil_pass`; "float32" and
"tensorfloat" knobs take fp32 operands, "bfloat16" bf16 operands.  On fp32
operands the first pass is the split-precision product (three TF32
tensor-core passes over hi / lo splits, `tf32x3`; its mirror is
`gcn_t_pass(..., matmul=tf32x3.matmul_tf32x3)`), against hi / lo halves of
W^T that the kernel makes on every call: W is trained in place.  Bound on
the H100 at the generator's shapes, a 512 -> 512 layer: ~200 MB of bf16
traffic (0.06 ms), or 3.4e10 operations of an fp32-class product (0.21 ms
at 165 TFLOP/s) on fp32 operands (see the kernel source).  Its gradient is the
`gcn_layer_bwd` kernel (JAX `_bwd`, gcn_layer.py:396-421): dx, dW and db
from the kernel, g itself for the residual, none for dinv and mask
(functions of the SST's NaN pattern).
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import (check, kernel_operand, library, operand_dtype,
                                     stream_ptr)
from msfno_torch.ops.kernels.tf32x3 import K_PAD, kmajor_split
from msfno_torch.runtime import mxu_round, torch_dtype

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)


def box3(v: torch.Tensor) -> torch.Tensor:
    """3x3 box sum (self + 8 neighbours) of (B, H, W, F): periodic in
    longitude (axis -2), zero past the poles (axis -3)."""
    if v.shape[-2] < 3:
        raise ValueError(f"box3 needs >= 3 longitude columns, got {v.shape[-2]}")
    zero = torch.zeros_like(v[..., :1, :, :])
    rows = v + torch.cat([zero, v[..., :-1, :, :]], dim=-3) + torch.cat(
        [v[..., 1:, :, :], zero], dim=-3
    )
    return rows + torch.roll(rows, 1, dims=-2) + torch.roll(rows, -1, dims=-2)


def gcn_t_pass(x, w, dinv, mxu_dtype="bfloat16", matmul=torch.matmul) -> torch.Tensor:
    """The kernel's first pass, t = (x @ W) * dinv in fp32: for c_in > 1 x
    and W rounded to `mxu_dtype` before an fp32-accumulated product by
    `matmul` (the card's fp32 operands: `tf32x3.matmul_tf32x3`); c_in == 1
    an fp32 outer product."""
    if x.shape[-1] == 1:
        sup = x.float() * w.float()[0]
    else:
        sup = matmul(mxu_round(x, mxu_dtype), mxu_round(w, mxu_dtype))
    return sup * dinv.float()


def gcn_stencil_pass(t, b, dinv, mask, residual=None, slope=0.01,
                     out_dtype=torch.float32) -> torch.Tensor:
    """The kernel's second pass on an fp32 t: residual + leaky_relu((box3(t)
    * dinv + b) * mask), in fp32, cast to `out_dtype`."""
    d = dinv.float()
    agg = (box3(t) * d + b.float()) * mask.float()
    y = torch.where(agg >= 0, agg, slope * agg)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def gcn_layer_reference(x, w, b, dinv, mask, residual=None, slope=0.01,
                        mxu_dtype="bfloat16", out_dtype=None):
    """Plain version of `_ref_gcn_layer` (msfno_tpu/ops/pallas/gcn_layer.py:
    362-377) with the kernel's rounding points and passes: `gcn_t_pass` then
    `gcn_stencil_pass`."""
    od = torch_dtype(out_dtype) if out_dtype is not None else x.dtype
    return gcn_stencil_pass(gcn_t_pass(x, w, dinv, mxu_dtype), b, dinv, mask, residual,
                            slope, od)


def gcn_layer(x, w, b, dinv, mask, residual=None, slope: float = 0.01,
              mxu_dtype: str = "bfloat16", out_dtype=None, prepared=None):
    """One fused GCN layer (JAX `gcn_layer` API).

    x: (B, H, W, C_in); w: (C_in, F); b: (F,); dinv/mask: (B, H, W, 1);
    residual: optional (B, H, W, F) added after the activation.  Returns
    (B, H, W, F) in `out_dtype` (default x.dtype).  A CPU tensor takes the
    plain version, forward and backward; a CUDA tensor launches the kernels
    or raises.  `prepared` is an optional cached copy of w (c_in > 1) in the
    operand dtype (bf16, or fp32 for "float32" and "tensorfloat")."""
    return _GcnLayer.apply(x, w, b, dinv, mask, residual, slope, mxu_dtype, out_dtype,
                           prepared)


class _GcnLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, dinv, mask, residual, slope, mxu_dtype, out_dtype, prepared):
        y = _forward(x, w, b, dinv, mask, residual, slope, mxu_dtype, out_dtype, prepared)
        ctx.save_for_backward(x, w, dinv, mask, residual, y)
        ctx.opts = (slope, mxu_dtype, prepared)
        return y

    @staticmethod
    def backward(ctx, g):
        from msfno_torch.ops.kernels.gcn_layer_bwd import gcn_layer_bwd

        x, w, dinv, mask, residual, y = ctx.saved_tensors
        slope, mxu_dtype, prepared = ctx.opts
        need = ctx.needs_input_grad
        dx, dw, db = gcn_layer_bwd(g, y, residual, x, w, dinv, mask, slope, mxu_dtype,
                                   need_dx=need[0], prepared=prepared)
        return (
            dx.to(x.dtype) if need[0] else None,
            dw.to(w.dtype) if need[1] else None,
            db if need[2] else None,
            None, None,
            g.to(residual.dtype) if need[5] else None,
            None, None, None, None,
        )


def _forward(x, w, b, dinv, mask, residual, slope, mxu_dtype, out_dtype, prepared):
    if x.device.type == "cpu":
        return gcn_layer_reference(x, w, b, dinv, mask, residual, slope,
                                   mxu_dtype, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gcn_layer: unsupported device {x.device}")
    bsz, h, wd, c_in = x.shape
    f = w.shape[1]
    if (w.shape != (c_in, f) or b.shape != (f,) or dinv.numel() != bsz * h * wd
            or mask.numel() != bsz * h * wd
            or (residual is not None and residual.shape != (bsz, h, wd, f))):
        raise ValueError("gcn_layer: operand shapes do not match x (B, H, W, C_in) "
                         f"{tuple(x.shape)} and w (C_in, F) {tuple(w.shape)}")
    f32_ops = operand_dtype(mxu_dtype) == torch.float32
    w_x3, c_in_pad = None, 0
    if c_in == 1:
        wk = w.float().reshape(-1).contiguous()
        xk, x_bf16 = kernel_operand(x)
    elif f32_ops:
        wk = prepared if prepared is not None else w.float().contiguous()
        xk, x_bf16 = x.float().contiguous(), 0
        # the hi / lo halves of W^T, rows padded (the GEMM's K-major B),
        # made by the kernel on every call
        c_in_pad = -(-c_in // K_PAD) * K_PAD
        w_x3 = torch.empty((2, f, c_in_pad), device=x.device)
    else:
        wk = prepared if prepared is not None else w.to(torch.bfloat16).contiguous()
        xk, x_bf16 = x.to(torch.bfloat16).contiguous(), 1
    if xk.data_ptr() % 16:  # TMA reads 16-byte aligned rows
        xk = xk.clone()
    dk, d_bf16 = kernel_operand(dinv)
    mk, m_bf16 = kernel_operand(mask)
    if d_bf16 != m_bf16:
        mk = mk.to(dk.dtype)
    rk, r_bf16 = kernel_operand(residual) if residual is not None else (None, 0)
    od = torch_dtype(out_dtype) if out_dtype is not None else x.dtype
    if od not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gcn_layer: unsupported out dtype {od}")
    out = torch.empty((bsz, h, wd, f), dtype=od, device=x.device)
    # t = (x @ W) * dinv, fp32, rows padded to 4 values (16-byte loads)
    ldt = -(-f // 4) * 4
    t = (torch.empty((bsz * h * wd, ldt), device=x.device, dtype=torch.float32)
         if c_in > 1 else None)
    bk = b.float().contiguous()
    fn = library("gcn_layer").gcn_layer
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp] * 9 + [ci] * 12 + [ctypes.c_float, vp]
    fn.restype = ci
    status = fn(
        xk.data_ptr(), wk.data_ptr(), bk.data_ptr(), dk.data_ptr(), mk.data_ptr(),
        rk.data_ptr() if rk is not None else None, out.data_ptr(),
        t.data_ptr() if t is not None else None, w_x3.data_ptr() if w_x3 is not None else None,
        bsz, h, wd, c_in, f, ldt, c_in_pad, x_bf16, d_bf16, r_bf16, int(od == torch.bfloat16),
        int(f32_ops), slope, stream_ptr(x),
    )
    check(status, "gcn_layer")
    global LAUNCHES
    LAUNCHES += 1
    return out


def split_w(w: torch.Tensor) -> torch.Tensor:
    """The hi / lo halves of W^T, (2, F, C_in padded to K_PAD), that the
    kernel's fp32 GEMM pass makes on every call (tests): on a CUDA tensor
    the kernel's transposing split alone, on a CPU tensor its plain
    version, `tf32x3.kmajor_split`."""
    if w.device.type == "cpu":
        return kmajor_split(w)
    c_in, f = w.shape
    wk = w.float().contiguous()
    out = torch.empty((2, f, -(-c_in // K_PAD) * K_PAD), device=w.device)
    fn = library("gcn_layer").gcn_layer_split_w
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, ci, ci, ci, vp, vp]
    fn.restype = ci
    check(fn(wk.data_ptr(), c_in, f, out.shape[2], out.data_ptr(), stream_ptr(w)),
          "gcn_layer_split_w")
    return out
