"""Backward of the fused inverse DFT + affine + big-skip decoder MLP: the
`spectral_decoder_bwd` CUDA kernel (csrc/spectral_decoder_bwd.cu) and its
plain version.

Replaces msfno_tpu/ops/pallas/spectral_decoder.py:_spectral_decoder_bwd_call.
Per latitude row, recomputing the forward from its inputs:

    x_raw = Mt @ hm[b, h];  xa = a * x_raw + b;  z1 = [xa, skip] @ W1 + b1
    dz1 = (g @ W2^T) * gelu'(z1)
    dhm = a * (Mt^T @ (dz1 @ W1a^T));   dskip = dz1 @ W1b^T
    da, db = sums of dxa * x_raw, dxa;  dW1, db1, dW2, db2

with every product's operands rounded to the matmul operand dtype and fp32
accumulation.  GELU is exact (erf) where the JAX kernels use the A&S 7.1.26
erf polynomial (<= 1.5e-7 absolute), the choice the forward kernels made.
Bound on the H100 at the serving shapes: operations (see the kernel source).
"""

from __future__ import annotations

import ctypes
import math

import torch

from msfno_torch.ops.kernels import check, library, stream_ptr
from msfno_torch.ops.kernels.grid_encoder_spectral import DFT_ROW_MULTIPLE
from msfno_torch.ops.kernels.grid_mlp import _act
from msfno_torch.runtime import mxu_round

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)

_SM_WAVE = 4 * 132  # blocks that fill the card's SMs a few times over


def gelu_grad(z: torch.Tensor) -> torch.Tensor:
    """d/dz [z * Phi(z)] = Phi(z) + z * phi(z), Phi with the exact erf."""
    cdf = 0.5 * (1.0 + torch.erf(z * (1.0 / math.sqrt(2.0))))
    return cdf + z * torch.exp(-0.5 * z * z) * (1.0 / math.sqrt(2.0 * math.pi))


def spectral_decoder_bwd_reference(g, hm, skip, mt, a, b, w1, b1, w2, b2=None,
                                   mxu_dtype="bfloat16"):
    """Plain version of the Pallas `_make_bwd_kernel` (spectral_decoder.py:
    172-280) with its rounding points: g (B, H, W, C_out); hm (B, H, 2M, C);
    skip (B, H, W, S); mt (W, 2M); a, b (B, C); w1 (C + S, hidden); w2
    (hidden, C_out).  Returns (dhm, dskip, da, db, dw1, db1, dw2, db2), fp32;
    db2 is None without b2."""
    bsz, h, two_m, c = hm.shape
    wd = mt.shape[0]
    hidden = w1.shape[1]
    mtm = mxu_round(mt, mxu_dtype)
    x_raw = torch.matmul(mtm, mxu_round(hm, mxu_dtype).reshape(bsz * h, two_m, c))
    x_raw = x_raw.reshape(bsz, h, wd, c)
    a4, b4 = a.float()[:, None, None, :], b.float()[:, None, None, :]
    xam = mxu_round(x_raw * a4 + b4, mxu_dtype)
    skm = mxu_round(skip, mxu_dtype)
    w1r, w2r = mxu_round(w1, mxu_dtype), mxu_round(w2, mxu_dtype)
    z1 = xam @ w1r[:c] + skm @ w1r[c:] + b1.float()
    gf = g.float()
    gm = mxu_round(gf, mxu_dtype)
    dz1 = (gm @ w2r.t()) * gelu_grad(z1)
    dzm = mxu_round(dz1, mxu_dtype)
    dxa = dzm @ w1r[:c].t()
    dskip = dzm @ w1r[c:].t()
    dhm = torch.matmul(mtm.t(), mxu_round(dxa, mxu_dtype).reshape(bsz * h, wd, c))
    dhm = dhm.reshape(bsz, h, two_m, c) * a4
    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dw1 = torch.cat([flat(xam).t() @ flat(dzm), flat(skm).t() @ flat(dzm)])
    h1 = mxu_round(torch.nn.functional.gelu(z1, approximate="none"), mxu_dtype)
    dw2 = flat(h1).t() @ flat(gm)
    return (dhm, dskip, (dxa * x_raw).sum((1, 2)), dxa.sum((1, 2)), dw1,
            flat(dz1).sum(0).reshape(hidden), dw2,
            flat(gf).sum(0) if b2 is not None else None)


def spectral_decoder_bwd(g, hm, skip, mt, a, b, w1, b1, w2, b2=None,
                         mxu_dtype="bfloat16", need_weights=True, prepared=None):
    """Gradients of `spectral_decoder` for the cotangent g (the JAX
    `_spectral_decoder_bwd_call` contract): (dhm, dskip, da, db, dw1, db1,
    dw2, db2).  A CPU tensor takes the plain version; a CUDA tensor launches
    the kernel or raises.  Without `need_weights` the kernel skips the weight
    gradients and returns None for them.  `prepared` is the forward's
    `spectral_decoder.prepare` result, when the caller caches it."""
    if g.device.type == "cpu":
        return spectral_decoder_bwd_reference(g, hm, skip, mt, a, b, w1, b1, w2, b2,
                                              mxu_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"spectral_decoder_bwd: unsupported device {g.device}")
    if mxu_dtype != "bfloat16":
        raise NotImplementedError(
            "spectral_decoder_bwd: the CUDA kernel takes bf16 operands; an fp32 "
            f"kernel ({mxu_dtype!r}) comes in a later slice"
        )
    from msfno_torch.ops.kernels.spectral_decoder import prepare

    bsz, h, two_m, c = hm.shape
    wd, s = skip.shape[-2], skip.shape[-1]
    hidden, c_out = w1.shape[1], w2.shape[1]
    if (skip.shape[:2] != (bsz, h) or g.shape != (bsz, h, wd, c_out)
            or mt.shape != (wd, two_m) or a.shape != (bsz, c) or b.shape != (bsz, c)
            or w1.shape[0] != c + s or b1.shape != (hidden,) or w2.shape[0] != hidden):
        raise ValueError("spectral_decoder_bwd: operand shapes do not match hm (B, H, 2M, C), "
                         "skip (B, H, W, S), g (B, H, W, C_out), mt (W, 2M), a/b (B, C), "
                         "w1 (C + S, hidden) and w2 (hidden, C_out)")
    if c % 16 or hidden % 16:
        raise ValueError(f"spectral_decoder_bwd: C {c} and hidden {hidden} must be "
                         "multiples of 16")
    if prepared is None:
        prepared = prepare(w1, w2, mt, c)
    w1p, w2p, mtp = prepared
    k1p, n2p, m2p = w1p.shape[0], w2p.shape[1], mtp.shape[1]
    gk, g_bf16 = _act(g)
    hmk, hm_bf16 = _act(hm)
    skk, skip_bf16 = _act(skip)
    af, bf = a.float().contiguous(), b.float().contiguous()
    b1f = b1.float().contiguous()
    dev = g.device
    lib = library("spectral_decoder_bwd")
    lib.spectral_decoder_bwd_chunk.restype = ctypes.c_int
    if lib.spectral_decoder_bwd_chunk() != DFT_ROW_MULTIPLE:
        raise RuntimeError("spectral_decoder_bwd: kernel chunk and DFT_ROW_MULTIPLE differ")
    n_chunks = -(-wd // DFT_ROW_MULTIPLE)
    n_px = bsz * h * wd
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    dhm, dskip = empty(bsz, h, two_m, c), empty(bsz, h, wd, s)
    da, db = empty(bsz, c), empty(bsz, c)
    t = empty(bsz, h, m2p, c, dtype=torch.bfloat16)
    dxa = empty(n_px, c, dtype=torch.bfloat16)
    part_da, part_db = empty(bsz, h * n_chunks, c), empty(bsz, h * n_chunks, c)
    weights = [None] * 11  # dw1p, db1, dw2p, db2p, xin, h1, gb, dz, part_db1, part_db2, part_w
    splits = 1
    if need_weights:
        tiles = -(-max(k1p, hidden) // 64) * -(-max(hidden, n2p) // 64)
        splits = max(1, min(n_px // 4096, -(-_SM_WAVE // tiles)))
        bf16 = torch.bfloat16
        weights = [empty(k1p, hidden), empty(hidden), empty(hidden, n2p), empty(n2p),
                   empty(n_px, k1p, dtype=bf16), empty(n_px, hidden, dtype=bf16),
                   empty(n_px, n2p, dtype=bf16), empty(n_px, hidden, dtype=bf16),
                   empty(bsz * h * n_chunks, hidden), empty(bsz * h * n_chunks, n2p),
                   empty(splits, max(k1p, n2p) * hidden)]
    dw1p, db1, dw2p, db2p, xin, h1, gb, dz, part_db1, part_db2, part_w = weights
    lib.spectral_decoder_bwd_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.spectral_decoder_bwd_bf16.restype = ctypes.c_int
    ptrs = (ctypes.c_void_p * 28)(*[
        p.data_ptr() if p is not None else None
        for p in (gk, hmk, skk, af, bf, mtp, w1p, b1f, w2p, dhm, dskip, da, db, dw1p, db1,
                  dw2p, db2p, t, dxa, part_da, part_db, xin, h1, gb, dz, part_db1, part_db2,
                  part_w)
    ])
    ints = (ctypes.c_longlong * 18)(
        bsz, h, wd, two_m, m2p, mtp.shape[0], c, s, c, k1p, hidden, c_out, n2p, hm_bf16,
        skip_bf16, g_bf16, int(need_weights), splits,
    )
    status = lib.spectral_decoder_bwd_bf16(ptrs, ints, stream_ptr(g))
    check(status, "spectral_decoder_bwd")
    global LAUNCHES
    LAUNCHES += 1
    if not need_weights:
        return dhm, dskip, da, db, None, None, None, None
    dw1 = torch.cat([dw1p[:c], dw1p[c:c + s]])
    return (dhm, dskip, da, db, dw1, db1, dw2p[:, :c_out],
            db2p[:c_out] if b2 is not None else None)
