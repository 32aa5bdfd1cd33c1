"""Input gradient of the complex spectral MLP: the `spectral_mlp_bwd` CUDA
kernel (csrc/spectral_mlp_bwd.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/spectral_mlp.py:_packed_bwd_call: recompute
the packed forward, keep the LeakyReLU-on-real derivative of each hidden
layer, then run the transposed chain g <- (g @ P_l^T) * m_{l-1} back to the
input, with P_l = [[wr, wi], [-wi, wr]] the packed complex weight.  The
weight gradients are not part of the kernel: `spectral_mlp`'s backward takes
them from the fp32 reference's VJP, as the JAX `_bwd` does.  Bound on the
H100 at the serving shapes: operations (see the kernel source).
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import check, library, stream_ptr
from msfno_torch.ops.kernels.spectral_mlp import pack_weights
from msfno_torch.runtime import mxu_round

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)


def _packed(w: torch.Tensor, mxu_dtype: str) -> torch.Tensor:
    wr, wi = w[..., 0].float(), w[..., 1].float()
    p = torch.cat([torch.cat([wr, wi], dim=1), torch.cat([-wi, wr], dim=1)], dim=0)
    return mxu_round(p, mxu_dtype)


def spectral_mlp_bwd_reference(z, g, weights, negative_slope: float = 0.0,
                               mxu_dtype: str = "bfloat16") -> torch.Tensor:
    """Plain version of the Pallas `_make_packed_bwd_kernel`
    (spectral_mlp.py:342-385) with its rounding points: z (2, ..., C_in) and
    g (2, ..., C_out) [re, im] fp32 -> dx (2, ..., C_in) fp32.  Packed
    weights and the operand of every product rounded to `mxu_dtype`; the
    derivative multipliers are bf16(slope) or 1, as the JAX kernel stores
    them in bf16 whatever the operand dtype."""
    c_in = z.shape[-1]
    lead = z.shape[1:-1]
    h = torch.cat([z[0].reshape(-1, c_in), z[1].reshape(-1, c_in)], dim=1).float()
    ps = [_packed(w, mxu_dtype) for w in weights]
    slope_m = mxu_round(torch.tensor(negative_slope), "bfloat16").item()
    mults = []
    for w, p in zip(weights[:-1], ps[:-1]):
        zl = mxu_round(h, mxu_dtype) @ p
        real = torch.arange(zl.shape[1], device=zl.device) < w.shape[1]
        neg = real & (zl < 0)
        mults.append(torch.where(neg, slope_m, 1.0))
        h = torch.where(neg, negative_slope * zl, zl)
    c_out = g.shape[-1]
    gk = torch.cat([g[0].reshape(-1, c_out), g[1].reshape(-1, c_out)], dim=1).float()
    for idx in range(len(ps) - 1, -1, -1):
        gk = mxu_round(gk, mxu_dtype) @ ps[idx].t()
        if idx > 0:
            gk = gk * mults[idx - 1]
    return torch.stack([gk[:, :c_in], gk[:, c_in:]]).reshape(2, *lead, c_in)


def spectral_mlp_bwd(z, g, weights, negative_slope: float = 0.0,
                     mxu_dtype: str = "bfloat16", packed=None) -> torch.Tensor:
    """dx of `spectral_mlp` at z (2, ..., C_in) for the cotangent g (2, ...,
    C_out), fp32.  A CPU tensor takes the plain version; a CUDA tensor
    launches the kernel or raises.  `packed` is the forward's
    `pack_weights(weights)` result, when the caller caches it."""
    if z.device.type == "cpu":
        return spectral_mlp_bwd_reference(z, g, weights, negative_slope, mxu_dtype)
    if z.device.type != "cuda":
        raise ValueError(f"spectral_mlp_bwd: unsupported device {z.device}")
    if mxu_dtype != "bfloat16":
        raise NotImplementedError(
            "spectral_mlp_bwd: the CUDA kernel takes bf16 operands; an fp32 "
            f"kernel ({mxu_dtype!r}) comes in a later slice"
        )
    if packed is None:
        packed = pack_weights(weights)
    wbuf, dims, offs = packed
    c_in, c_out = z.shape[-1], g.shape[-1]
    if c_in != dims[0] or c_out != dims[-1] or any(d % 16 for d in dims):
        raise ValueError(f"spectral_mlp_bwd: widths {dims} must be multiples of 16 and "
                         f"match z's {c_in} and g's {c_out}")
    x = z.float().reshape(2, -1, c_in).contiguous()
    gg = g.float().reshape(2, -1, c_out).contiguous()
    if x.shape[1] != gg.shape[1]:
        raise ValueError("spectral_mlp_bwd: z and g have different rows")
    x = x if x.data_ptr() % 16 == 0 else x.clone()  # rows are read as float4
    gg = gg if gg.data_ptr() % 16 == 0 else gg.clone()
    n = x.shape[1]
    dx = torch.empty((2, n, c_in), device=z.device, dtype=torch.float32)
    fn = library("spectral_mlp_bwd").spectral_mlp_bwd_bf16
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, vp, vp, ctypes.c_int,
                   ctypes.c_float, vp]
    fn.restype = ctypes.c_int
    n_layers = len(dims) - 1
    status = fn(
        x[0].data_ptr(), x[1].data_ptr(), gg[0].data_ptr(), gg[1].data_ptr(), wbuf.data_ptr(),
        (ctypes.c_int * len(dims))(*dims), (ctypes.c_longlong * n_layers)(*offs), n_layers,
        dx[0].data_ptr(), dx[1].data_ptr(), n, negative_slope, stream_ptr(z),
    )
    check(status, "spectral_mlp_bwd")
    global LAUNCHES
    LAUNCHES += 1
    return dx.reshape(z.shape)
