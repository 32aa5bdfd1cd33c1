"""Input gradient of the complex spectral MLP: the `spectral_mlp_bwd` CUDA
kernel (csrc/spectral_mlp_bwd.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/spectral_mlp.py:_packed_bwd_call: recompute
the packed forward, keep the LeakyReLU-on-real derivative of each hidden
layer, then run the transposed chain g <- (g @ P_l^T) * m_{l-1} back to the
input, with P_l = [[wr, wi], [-wi, wr]] the packed complex weight.  The
weight gradients are not part of the kernel: `spectral_mlp`'s backward takes
them from the fp32 reference's VJP, as the JAX `_bwd` does.  Bound on the
H100 at the serving shapes: operations (see the kernel source).  The kernel
is one GEMM per layer (three recomputed, four transposed) with each hidden
layer's derivative kept as packed mask bits; `spectral_mlp_bwd_layers` is a
plain mirror of that sequence (tests only).
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


def pack_mask(neg: torch.Tensor) -> torch.Tensor:
    """The kernel's mask words of a (rows, d_out) bool: per row 4 words per
    128 columns, word 4 (col // 128) + (col % 8) // 2 holding column col at
    bit 2 ((col % 128) // 8) + col % 2 (the wgmma accumulator fragment's
    layout: a lane quad's columns).  Returns (rows, words) int64."""
    rows, d_out = neg.shape
    col = torch.arange(d_out, device=neg.device)
    word = 4 * (col // 128) + (col % 8) // 2
    bit = 2 * ((col % 128) // 8) + col % 2
    words = torch.zeros((rows, 4 * -(-d_out // 128)), dtype=torch.int64, device=neg.device)
    return words.index_add_(1, word, neg.long() << bit)


def unpack_mask(words: torch.Tensor, d_out: int) -> torch.Tensor:
    """The (rows, d_out) bool that `pack_mask` packed into `words`."""
    col = torch.arange(d_out, device=words.device)
    word = 4 * (col // 128) + (col % 8) // 2
    bit = 2 * ((col % 128) // 8) + col % 2
    return ((words[:, word] >> bit) & 1).bool()


def spectral_mlp_bwd_layers(z, g, weights, negative_slope: float = 0.0,
                            mxu_dtype: str = "bfloat16") -> torch.Tensor:
    """Plain mirror of the kernel's sequence (tests only): [re | im] rows
    rounded to `mxu_dtype`; the recompute z_l = h_l @ P_l, its real-half
    signs kept as `pack_mask` words and h_{l+1} = LeakyReLU on the real half,
    rounded per layer; then g_l = g_{l+1} @ P_l^T, times bf16(slope) where
    the unpacked mask of layer l-1 is set, rounded per layer; dx fp32.  Same
    signature and returns as `spectral_mlp_bwd`."""
    c_in, c_out = z.shape[-1], g.shape[-1]
    lead = z.shape[1:-1]
    r = lambda v: mxu_round(v, mxu_dtype)  # noqa: E731
    ps = [_packed(w, mxu_dtype) for w in weights]
    h = r(torch.cat([z[0].reshape(-1, c_in), z[1].reshape(-1, c_in)], dim=1).float())
    masks = []
    for w, p in zip(weights[:-1], ps[:-1]):
        zl = h @ p
        d_out = w.shape[1]
        neg = zl[:, :d_out] < 0
        masks.append(pack_mask(neg))
        h = r(torch.cat([torch.where(neg, negative_slope * zl[:, :d_out], zl[:, :d_out]),
                         zl[:, d_out:]], dim=1))
    slope_m = mxu_round(torch.tensor(negative_slope), "bfloat16").item()
    gk = r(torch.cat([g[0].reshape(-1, c_out), g[1].reshape(-1, c_out)], dim=1).float())
    for idx in range(len(ps) - 1, -1, -1):
        gk = gk @ ps[idx].t()
        if idx > 0:
            d_in = weights[idx].shape[0]
            neg = unpack_mask(masks[idx - 1], d_in)
            gk = r(torch.cat([torch.where(neg, gk[:, :d_in] * slope_m, gk[:, :d_in]),
                              gk[:, d_in:]], dim=1))
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
            f"spectral_mlp_bwd: the CUDA kernel takes bf16 operands, not {mxu_dtype!r}: "
            "off bf16 the gradient of spectral_mlp is the reference VJP, in this "
            "package as in the JAX package (msfno_tpu/ops/pallas/spectral_mlp.py:487)"
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
    lib = library("spectral_mlp_bwd")
    lib.spectral_mlp_bwd_mask_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.spectral_mlp_bwd_mask_bytes.restype = ctypes.c_longlong
    n_layers = len(dims) - 1
    # scratch: the [re | im] bf16 rows in turn, and each hidden layer's mask
    hidden = torch.empty((2, n * 2 * max(dims)), device=z.device, dtype=torch.bfloat16)
    mask_offs, mask_bytes = [], 0
    for d_out in dims[1:-1]:
        mask_offs.append(mask_bytes)
        mask_bytes += -(-lib.spectral_mlp_bwd_mask_bytes(n, d_out) // 16) * 16
    masks = torch.empty(max(mask_bytes, 16), device=z.device, dtype=torch.uint8)
    fn = lib.spectral_mlp_bwd_bf16
    vp = ctypes.c_void_p
    fn.argtypes = [vp, vp, vp, vp, vp, ctypes.POINTER(ctypes.c_int),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, vp, vp, ctypes.c_int,
                   ctypes.c_float, vp, vp, vp, ctypes.POINTER(ctypes.c_longlong), vp]
    fn.restype = ctypes.c_int
    status = fn(
        x[0].data_ptr(), x[1].data_ptr(), gg[0].data_ptr(), gg[1].data_ptr(), wbuf.data_ptr(),
        (ctypes.c_int * len(dims))(*dims), (ctypes.c_longlong * n_layers)(*offs), n_layers,
        dx[0].data_ptr(), dx[1].data_ptr(), n, negative_slope, hidden[0].data_ptr(),
        hidden[1].data_ptr(), masks.data_ptr(),
        (ctypes.c_longlong * max(1, len(mask_offs)))(*mask_offs), stream_ptr(z),
    )
    check(status, "spectral_mlp_bwd")
    global LAUNCHES
    LAUNCHES += 1
    return dx.reshape(z.shape)
