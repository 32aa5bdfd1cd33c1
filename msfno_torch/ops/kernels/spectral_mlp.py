"""Complex spectral MLP over SHT modes: the `spectral_mlp` CUDA kernel
(csrc/spectral_mlp.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/spectral_mlp.py:spectral_mlp.  Per retained
(l, m) mode, weights shared across modes: `len(weights) - 1` layers of
complex matmul + ComplexReLU("real") (LeakyReLU on the real part only), then
the `wout` projection (reference SpectralAttentionS2.forward_mlp,
MSFNO/Models/sfno/layers.py:615-631).

Bound on the H100 at the serving shapes: operations (see the kernel source);
one launch is ~9.1e10 FLOP in the 4-product form.  bf16 operands run on
wgmma, fp32 operands ("float32", "tensorfloat": the JAX package's default
knob) on the CUDA cores in true fp32 FMA.  `spectral_mlp_layers` mirrors
the kernel's algebra (one packed GEMM per layer, the hidden state handed on
rounded to the operand dtype).  Its gradient is what the
JAX `_bwd` (spectral_mlp.py:485-507) does: on the bf16 path dx from the
`spectral_mlp_bwd` kernel; the weights' gradients, only when asked for (and
dx off the bf16 path), from the VJP of the fp32 reference `_ref_flat`.
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import (check, check_prepared, library, operand_dtype,
                                     reference_vjp, stream_ptr)
from msfno_torch.runtime import mxu_round

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)


def spectral_mlp_reference(z: torch.Tensor, weights, negative_slope: float = 0.0,
                           mxu_dtype: str = "float32") -> torch.Tensor:
    """Plain version: z (2, ..., C) [re, im]; weights (in, out, 2) each.

    The 4-product complex form of `_mlp_reference`
    (msfno_tpu/ops/pallas/spectral_mlp.py:58-69) with the kernel's rounding
    points: matmul operands rounded to `mxu_dtype`, fp32 accumulation."""
    hr, hi = z[0].float(), z[1].float()
    n_layers = len(weights)
    for idx, w in enumerate(weights):
        wr = mxu_round(w[..., 0], mxu_dtype)
        wi = mxu_round(w[..., 1], mxu_dtype)
        ar, ai = mxu_round(hr, mxu_dtype), mxu_round(hi, mxu_dtype)
        nr = ar @ wr - ai @ wi
        ni = ar @ wi + ai @ wr
        if idx < n_layers - 1:
            nr = torch.where(nr >= 0, nr, negative_slope * nr)
        hr, hi = nr, ni
    return torch.stack([hr, hi])


def packed_matrix(w: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """P = [[wr, wi], [-wi, wr]] of one (in, out, 2) complex weight, so that
    [hr | hi] @ P = [hr wr - hi wi | hr wi + hi wr], in `dtype`."""
    wr, wi = w[..., 0].float(), w[..., 1].float()
    return torch.cat(
        [torch.cat([wr, wi], dim=1), torch.cat([-wi, wr], dim=1)], dim=0
    ).to(dtype)


def pack_weights(weights, mxu_dtype: str = "bfloat16"
                 ) -> tuple[torch.Tensor, list[int], list[int]]:
    """The kernel's weight buffer: `packed_matrix` per layer in the operand
    type of `mxu_dtype`, concatenated; with the layer widths and element
    offsets."""
    dt = operand_dtype(mxu_dtype)
    dims = [int(weights[0].shape[0])] + [int(w.shape[1]) for w in weights]
    parts, offs, off = [], [], 0
    for w in weights:
        packed = packed_matrix(w, dt)
        parts.append(packed.reshape(-1))
        offs.append(off)
        off += packed.numel()
    return torch.cat(parts).contiguous(), dims, offs


def spectral_mlp_layers(z: torch.Tensor, weights, negative_slope: float = 0.0,
                        mxu_dtype: str = "float32") -> torch.Tensor:
    """Mirror of the kernel's algebra: one packed GEMM per layer with the
    hidden state handed from layer to layer as [re | im] rows rounded to
    the operand dtype (bf16: once per layer, as the kernel's epilogue
    does), fp32 accumulation, the LeakyReLU on the real half of every
    hidden layer, fp32 re and im out."""
    h = mxu_round(torch.cat([z[0], z[1]], dim=-1), mxu_dtype)
    for idx, w in enumerate(weights):
        d_out = w.shape[1]
        y = h @ mxu_round(packed_matrix(w, torch.float32), mxu_dtype)
        if idx < len(weights) - 1:
            y = torch.cat([torch.where(y[..., :d_out] >= 0, y[..., :d_out],
                                       negative_slope * y[..., :d_out]), y[..., d_out:]], -1)
            h = mxu_round(y, mxu_dtype)
        else:
            h = y
    return torch.stack([h[..., :h.shape[-1] // 2], h[..., h.shape[-1] // 2:]])


def spectral_mlp(z: torch.Tensor, weights, negative_slope: float = 0.0,
                 mxu_dtype: str = "float32", packed=None) -> torch.Tensor:
    """Spectral MLP over z (2, ..., C_in) fp32 -> (2, ..., C_out) fp32.

    A CPU tensor takes the plain version, forward and backward; a CUDA tensor
    launches the kernels (operands of `mxu_dtype`, fp32 accumulation) or
    raises.  `packed` is an optional `pack_weights(weights, mxu_dtype)`
    result cached by the caller."""
    return _SpectralMlp.apply(z, negative_slope, mxu_dtype, packed, *weights)


class _SpectralMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, negative_slope, mxu_dtype, packed, *weights):
        out = _forward(z, weights, negative_slope, mxu_dtype, packed)
        ctx.save_for_backward(z, *weights)
        ctx.opts = (negative_slope, mxu_dtype, packed)
        return out

    @staticmethod
    def backward(ctx, g):
        from msfno_torch.ops.kernels.spectral_mlp_bwd import spectral_mlp_bwd

        z, *ws = ctx.saved_tensors
        slope, mxu_dtype, packed = ctx.opts
        need = ctx.needs_input_grad
        # the fp32 reference's VJP (no rounding) for the weights, and for x
        # too off the bf16 path, where the JAX package has no backward kernel
        kernel_dz = mxu_dtype == "bfloat16"
        vjp_need = (need[0] and not kernel_dz, *need[4:])
        d = [None] * (1 + len(ws))
        if any(vjp_need):
            d = reference_vjp(
                lambda x, *w: spectral_mlp_reference(x, list(w), slope, "float32"),
                (z, *ws), vjp_need, (g,),
            )
        if kernel_dz and need[0]:
            d[0] = spectral_mlp_bwd(z, g, ws, slope, mxu_dtype, packed)
        return (d[0], None, None, None, *d[1:])


def _forward(z, weights, negative_slope, mxu_dtype, packed):
    if z.device.type == "cpu":
        return spectral_mlp_reference(z, weights, negative_slope, mxu_dtype)
    if z.device.type != "cuda":
        raise ValueError(f"spectral_mlp: unsupported device {z.device}")
    dt = operand_dtype(mxu_dtype)
    if packed is None:
        packed = pack_weights(weights, mxu_dtype)
    wbuf, dims, offs = packed
    check_prepared("spectral_mlp", (wbuf,), mxu_dtype)
    lead = z.shape[1:-1]
    c_in = z.shape[-1]
    if c_in != dims[0] or any(d % 16 for d in dims):
        raise ValueError(f"spectral_mlp: widths {dims} must be multiples of 16 "
                         f"and match the input's {c_in}")
    x = z.float().reshape(2, -1, c_in).contiguous()
    if x.data_ptr() % 16:  # the kernel stages its rows as float4
        x = x.clone()
    n = x.shape[1]
    out = torch.empty((2, n, dims[-1]), device=z.device, dtype=torch.float32)
    # the hidden states, [re | im] rows of the operand type, in turn
    hidden = torch.empty((2, n * 2 * max(dims)), device=z.device, dtype=dt)
    lib = library("spectral_mlp")
    fn = lib.spectral_mlp_bf16 if dt == torch.bfloat16 else lib.spectral_mlp_f32
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, vp, vp,
                   ctypes.c_int, ctypes.c_float, vp, vp, vp]
    fn.restype = ctypes.c_int
    n_layers = len(dims) - 1
    status = fn(
        x[0].data_ptr(), x[1].data_ptr(), wbuf.data_ptr(),
        (ctypes.c_int * len(dims))(*dims), (ctypes.c_longlong * n_layers)(*offs),
        n_layers, out[0].data_ptr(), out[1].data_ptr(), n, negative_slope,
        hidden[0].data_ptr(), hidden[1].data_ptr(), stream_ptr(z),
    )
    check(status, "spectral_mlp")
    global LAUNCHES
    LAUNCHES += 1
    return out.reshape(2, *lead, dims[-1])
