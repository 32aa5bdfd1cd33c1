"""Backward of one masked-grid GCN layer: the `gcn_layer_bwd` CUDA kernel
(csrc/gcn_layer_bwd.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/gcn_layer.py:_gcn_layer_bwd_call.  With the
forward y = residual + leaky_relu((box3(x @ W * d) * d + b) * mask, slope):

    dagg = g * act' * mask      act' = 1 where y - residual >= 0, else slope
    dsup = box3(dagg * d) * d   (box3 is symmetric: its own transpose)
    dx = dsup @ W^T             dW = x^T @ dsup             db = sum dagg

with dsup, W and x rounded to the matmul operand dtype before the products,
fp32 accumulation.  The residual's cotangent is g itself (the caller's).
Bound on the H100 at a 512 -> 512 layer: memory traffic on bf16 operands,
fp32 FMA operations on fp32 operands (see the kernel source).
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import check, library, stream_ptr
from msfno_torch.ops.kernels.gcn_layer import _act, _fp32_operands, box3
from msfno_torch.runtime import mxu_round

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)

_SM_WAVE = 4 * 132  # blocks that fill the card's SMs a few times over


def gcn_layer_bwd_reference(g, y, residual, x, w, dinv, mask, slope=0.01,
                            mxu_dtype="bfloat16"):
    """Plain version of the Pallas `_make_bwd_kernel` (gcn_layer.py:194-283)
    with its rounding points.  g, y, residual: (B, H, W, F); x: (B, H, W,
    C_in); w: (C_in, F); dinv, mask: (B, H, W, 1).  Returns (dx (B, H, W,
    C_in), dw (C_in, F), db (F,)), all fp32."""
    c_in, f = w.shape
    yr = y.float() - (residual.float() if residual is not None else 0.0)
    act = torch.where(yr >= 0, 1.0, slope)
    d = dinv.float()
    dagg = g.float() * act * mask.float()
    dsup = mxu_round(box3(dagg * d) * d, mxu_dtype)
    dx = dsup @ mxu_round(w, mxu_dtype).t()
    dw = mxu_round(x, mxu_dtype).reshape(-1, c_in).t() @ dsup.reshape(-1, f)
    return dx, dw, dagg.reshape(-1, f).sum(0)


def gcn_layer_bwd(g, y, residual, x, w, dinv, mask, slope: float = 0.01,
                  mxu_dtype: str = "bfloat16", need_dx: bool = True, prepared=None):
    """Input, weight and bias gradients of `gcn_layer` (the JAX
    `_gcn_layer_bwd_call` contract).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.  Without `need_dx` the kernel
    skips dx and returns None for it.  `prepared` is an optional cached bf16
    copy of w (c_in > 1) in the operand dtype: bf16, or fp32 for the
    "float32" and "tensorfloat" knobs."""
    if g.device.type == "cpu":
        return gcn_layer_bwd_reference(g, y, residual, x, w, dinv, mask, slope, mxu_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"gcn_layer_bwd: unsupported device {g.device}")
    bsz, h, wd, f = g.shape
    c_in = x.shape[-1]
    if (w.shape != (c_in, f) or y.shape != g.shape or x.shape[:3] != g.shape[:3]
            or dinv.numel() != bsz * h * wd or mask.numel() != bsz * h * wd
            or (residual is not None and residual.shape != g.shape)):
        raise ValueError("gcn_layer_bwd: operand shapes do not match g (B, H, W, F) "
                         f"{tuple(g.shape)}, x (B, H, W, C_in) {tuple(x.shape)} and "
                         f"w (C_in, F) {tuple(w.shape)}")
    f32_ops = _fp32_operands(mxu_dtype)
    if f % 8 or (c_in > 1 and c_in % 8 and not f32_ops):
        raise ValueError(f"gcn_layer_bwd: F {f} (and, on bf16 operands, C_in {c_in} > 1) "
                         "must be multiples of 8")
    dev = g.device
    gk, g_bf16 = _act(g)
    yk, y_bf16 = _act(y)
    rk, r_bf16 = _act(residual) if residual is not None else (None, 0)
    dk, d_bf16 = _act(dinv)
    mk = mask.to(dk.dtype).contiguous()
    op_dtype = torch.float32 if f32_ops else torch.bfloat16
    if c_in > 1:
        xk, x_bf16 = x.to(op_dtype).contiguous(), int(not f32_ops)
        wk = prepared if prepared is not None else w.to(op_dtype).contiguous()
    else:
        xk, x_bf16 = _act(x)
        wk = w.to(op_dtype).reshape(1, f).contiguous()
    n_px = bsz * h * wd
    tile = 128 if f32_ops else 64  # the dW GEMM's tile edge
    tiles = -(-c_in // tile) * -(-f // tile)
    splits = 1 if c_in == 1 else max(1, min(n_px // 1024, -(-_SM_WAVE // tiles)))
    dx = torch.empty((bsz, h, wd, c_in), device=dev) if need_dx else None
    dw = torch.empty((c_in, f), device=dev)
    db = torch.empty((f,), device=dev)
    dsup = torch.empty((bsz, h, wd, f), dtype=op_dtype, device=dev)
    part_db = torch.empty((bsz * h, f), device=dev)
    part_dw = torch.empty((bsz * h, f) if c_in == 1 else (splits, c_in, f), device=dev)

    lib = library("gcn_layer_bwd")
    lib.gcn_layer_bwd.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                                  ctypes.c_void_p]
    lib.gcn_layer_bwd.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * 13)(*[
        t.data_ptr() if t is not None else None
        for t in (gk, yk, rk, xk, wk, dk, mk, dx, dw, db, dsup, part_db, part_dw)
    ])
    ints = (ctypes.c_longlong * 12)(bsz, h, wd, c_in, f, g_bf16, y_bf16, r_bf16, x_bf16,
                                    d_bf16, splits, int(f32_ops))
    status = lib.gcn_layer_bwd(ptrs, ints, slope, stream_ptr(g))
    check(status, "gcn_layer_bwd")
    global LAUNCHES
    LAUNCHES += 1
    return dx, dw, db
