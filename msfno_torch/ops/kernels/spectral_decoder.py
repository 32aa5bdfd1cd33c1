"""Fused inverse longitude DFT + per-channel affine + big-skip decoder MLP:
the `spectral_decoder` CUDA kernel (csrc/spectral_decoder.cu), its plain
version, and the spectral-space instance-norm statistics it needs.

Replaces msfno_tpu/ops/pallas/spectral_decoder.py:spectral_decoder (forward)
and ports its `spectral_grid_stats`.  Per latitude row:

    x = Mt @ (a * hm[b, h]) + b        (W, C): the last block's grid field,
                                       normalized and FiLM-modulated
    y = MLP([x, skip])                 (W, C_out)

with hm the Legendre-synthesis intermediate (B, H, 2M, C)
(`InverseRealSHT.synthesis_hm`), Mt (W, 2M) the transposed merged synthesis
matrix (`InverseRealSHT.merged_matrix_t`) and (a, b) the combined norm + FiLM
affine per (sample, channel): a per-channel affine commutes with the DFT.
The grid field is never stored: the kernel chains three GEMMs per tile of
128 longitudes of a row (see its source); `decoder_tiles` is a plain
mirror of that chain (tests only).  On fp32 operands ("float32",
"tensorfloat") the kernel runs in true fp32 FMA: the fp32 inverse DFT of
`dft_synthesis` (the even/odd fold) writes the unscaled field Mt @ hm, and
the decoder MLP of csrc/mlp_f32.cuh reads it with (a, b) as its input
affine; `decoder_f32_passes` is its plain mirror.  Bound on the H100 at
the serving shapes: operations (see the kernel source).  Its gradient is the
`spectral_decoder_bwd` kernel (JAX `_bwd`, spectral_decoder.py:412-438),
on bf16 and on fp32 operands: dhm, dskip, da, db and the weight
gradients; none for Mt, a constant.
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import (check, check_prepared, kernel_operand, library, mlp_f32,
                                     operand_dtype, stream_ptr)
from msfno_torch.ops.kernels import dft_analysis, dft_synthesis
from msfno_torch.ops.kernels.dft_analysis import FOLD_K, FOLD_TILE, _ceil, aligned, check_operand
from msfno_torch.ops.kernels.grid_encoder_spectral import (
    DFT_ROW_MULTIPLE, TILE_ROWS, _dft_operand, pad_dft_matrix)
from msfno_torch.ops.kernels.grid_mlp import grid_mlp_reference, prepare_weights
from msfno_torch.ops.kernels.tf32x3 import kmajor_split
from msfno_torch.runtime import mxu_round, torch_dtype

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)


def spectral_decoder_reference(hm, skip, mt, a, b, w1, b1, w2, b2=None,
                               mxu_dtype="bfloat16", out_dtype=None):
    """Plain version with the Pallas kernel's rounding points
    (spectral_decoder.py:79-98): t = hm * a rounded to `mxu_dtype`; x = Mt t
    + b in fp32 with Mt rounded to `mxu_dtype`; then the big-skip MLP with x,
    skip, W1, W2 and the GELU output rounded to `mxu_dtype`; y in fp32, cast
    to `out_dtype` (default fp32).  Same signature and returns as
    `spectral_decoder`."""
    bsz, h, two_m, c = hm.shape
    w = mt.shape[0]
    t = mxu_round(hm.float() * a.float()[:, None, None, :], mxu_dtype)
    x = torch.matmul(mxu_round(mt, mxu_dtype), t.reshape(bsz * h, two_m, c))
    x = x.reshape(bsz, h, w, c) + b.float()[:, None, None, :]
    return grid_mlp_reference(x, w1, b1, w2, b2, skip=skip, mxu_dtype=mxu_dtype,
                              out_dtype=out_dtype or "float32")


def decoder_tiles(hm, skip, mt, a, b, w1, b1, w2, b2=None, mxu_dtype="bfloat16",
                  out_dtype=None, tile=TILE_ROWS):
    """Plain mirror of the kernel's chain (tests only): per tile of `tile`
    longitudes of each row (the last one ragged), (1) x = Mt[tile] t + b with
    t = bf16(hm * a), (2) h = bf16(gelu([bf16(x) | bf16(skip)] W1 + b1)),
    (3) y = h W2 + b2, with the kernel's rounding points.  Same signature and
    returns as `spectral_decoder`."""
    bsz, h, two_m, c = hm.shape
    w = mt.shape[0]
    r = lambda v: mxu_round(v, mxu_dtype)
    t = r(hm.float() * a.float()[:, None, None, :])
    mtr, w1r, w2r = r(mt.float()), r(w1.float()), r(w2.float())
    outs = []
    for w0 in range(0, w, tile):
        x = torch.matmul(mtr[w0:w0 + tile], t) + b.float()[:, None, None, :]
        k = torch.cat([r(x), r(skip[:, :, w0:w0 + tile].float())], dim=-1)
        hid = r(torch.nn.functional.gelu(torch.matmul(k, w1r) + b1.float(),
                                         approximate="none"))
        y = torch.matmul(hid, w2r)
        outs.append(y + b2.float() if b2 is not None else y)
    return torch.cat(outs, dim=2).to(torch_dtype(out_dtype or "float32"))


def _synthesis_pair(mt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ci, Si), each (M, W), of the transposed merged synthesis matrix
    Mt = [Ci; -Si]^T."""
    m = mt.shape[1] // 2
    return mt[:, :m].t(), -mt[:, m:].t()


def _transposed_pair(mt: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(C, S), each (W, M), with Mt^T = [C | -S]^T: the forward DFT's
    matrices of the transposed product Mt^T @ x that the backward's dhm
    takes (Mt's cos columns, and its sin columns negated)."""
    m = mt.shape[1] // 2
    return mt[:, :m], -mt[:, m:]


def decoder_f32_passes(hm, skip, mt, a, b, w1, b1, w2, b2=None, out_dtype=None):
    """Plain mirror of the fp32-operand kernel (tests only): the folded
    inverse DFT of the unscaled hm (`dft_synthesis.dft_synthesis_folded`),
    then the decoder MLP with (a, b) as its per-sample input affine, all in
    fp32.  Same returns as `spectral_decoder`."""
    bsz, h, two_m, c = hm.shape
    w = mt.shape[0]
    x = dft_synthesis.dft_synthesis_folded(hm.float(), *_synthesis_pair(mt.float()))
    return grid_mlp_reference(x.reshape(bsz, h, w, c), w1, b1, w2, b2, skip=skip,
                              mxu_dtype="float32", out_dtype=out_dtype or "float32",
                              affine=(a.float(), b.float()))


def spectral_grid_stats(hm: torch.Tensor, omega: torch.Tensor):
    """Exact instance-norm statistics of the unstored grid field
    x = Mt @ hm: by DFT orthogonality (omega = diag(M M^T) / W,
    `InverseRealSHT.mode_power_weights`)

        E[x]   = mean_h hm[:, :, 0, :]
        E[x^2] = mean_h sum_m omega_m hm[:, :, m, :]^2

    Returns (mean, mean_sq), each (B, C) fp32: the InstanceNorm statistics
    contract with count 1.  Plain fp32 torch; the einsum is a true fp32
    matmul on the card (`runtime.exact_fp32_matmuls`: no TF32)."""
    hm32 = hm.float()
    mean = hm32[:, :, 0, :].mean(dim=1)
    mean_sq = torch.einsum("bhmc,m->bc", hm32 * hm32, omega.float()) / hm.shape[1]
    return mean, mean_sq


def prepare(w1, w2, mt, c_main: int, mxu_dtype="bfloat16"):
    """The kernels' operands for `mxu_dtype`, built once.  bf16:
    `grid_mlp.prepare_weights` of the MLP (main rows, then the skip rows)
    and the padded Mt for the forward; the transposes of both weights and
    Mt^T (as the head's DFT pass takes its operand) for the
    `spectral_decoder_bwd` kernel (~1.0 MB at the serving widths).  fp32:
    the fp32 weights and the fold's half matrices of
    `dft_synthesis.prepare` for the forward, and for the backward's dhm
    those of `dft_analysis.prepare` of the transposed product (~0.75 MB
    each at the serving widths); then the backward's split-precision B
    operands (`tf32x3.kmajor_split`: hi and lo, K-major, rows zero-padded):
    W1^T (hidden x (C + S)) for z1, W2 (hidden x C_out) for dz1 = g W2^T
    and W1 ((C + S) x hidden) for [dxa | dskip] = dz1 W1^T (~1.5 MB)."""
    if operand_dtype(mxu_dtype) == torch.float32:
        w1p, w2p = prepare_weights(w1, w2, c_main, mxu_dtype)
        return (w1p, w2p, dft_synthesis.prepare(*_synthesis_pair(mt), mxu_dtype),
                dft_analysis.prepare(*_transposed_pair(mt), mxu_dtype),
                kmajor_split(w1p), kmajor_split(w2p.t()), kmajor_split(w1p.t()))
    w1p, w2p = prepare_weights(w1, w2, c_main)
    return (w1p, w2p, pad_dft_matrix(mt), w1p.t().contiguous(), w2p.t().contiguous(),
            _dft_operand(mt))


def spectral_decoder(hm, skip, mt, a, b, w1, b1, w2, b2=None, mxu_dtype="bfloat16",
                     out_dtype=None, prepared=None):
    """Fused inverse DFT + affine + big-skip decoder MLP (JAX
    `spectral_decoder` API).

    hm: (B, H, 2M, C); skip: (B, H, W, S); mt: (W, 2M); a, b: (B, C); w1:
    (C + S, hidden); w2: (hidden, C_out).  Returns (B, H, W, C_out) in
    `out_dtype` (default fp32).  A CPU tensor takes the plain version, forward
    and backward; a CUDA tensor launches the kernels or raises.  `prepared`
    is an optional `prepare` result cached by the caller."""
    return _SpectralDecoder.apply(hm, skip, mt, a, b, w1, b1, w2, b2, mxu_dtype, out_dtype,
                                  prepared)


class _SpectralDecoder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hm, skip, mt, a, b, w1, b1, w2, b2, mxu_dtype, out_dtype, prepared):
        out = _forward(hm, skip, mt, a, b, w1, b1, w2, b2, mxu_dtype, out_dtype, prepared)
        ctx.save_for_backward(hm, skip, mt, a, b, w1, b1, w2, b2)
        ctx.opts = (mxu_dtype, prepared)
        return out

    @staticmethod
    def backward(ctx, g):
        from msfno_torch.ops.kernels.spectral_decoder_bwd import spectral_decoder_bwd

        hm, skip, mt, a, b, w1, b1, w2, b2 = ctx.saved_tensors
        mxu_dtype, prepared = ctx.opts
        need = ctx.needs_input_grad
        grads = spectral_decoder_bwd(g, hm, skip, mt, a, b, w1, b1, w2, b2, mxu_dtype,
                                     need_weights=any(need[5:9]), prepared=prepared)
        dhm, dskip, da, db, dw1, db1, dw2, db2 = grads
        ins = (hm, skip, None, a, b, w1, b1, w2, b2)
        outs = (dhm, dskip, None, da, db, dw1, db1, dw2, db2)
        return (*(d.to(t.dtype) if n and d is not None else None
                  for d, t, n in zip(outs, ins, need)), None, None, None)


def _forward(hm, skip, mt, a, b, w1, b1, w2, b2, mxu_dtype, out_dtype, prepared):
    if hm.device.type == "cpu":
        return spectral_decoder_reference(hm, skip, mt, a, b, w1, b1, w2, b2, mxu_dtype,
                                          out_dtype)
    if hm.device.type != "cuda":
        raise ValueError(f"spectral_decoder: unsupported device {hm.device}")
    f32 = operand_dtype(mxu_dtype) == torch.float32
    bsz, h, two_m, c = hm.shape
    w, s = skip.shape[-2], skip.shape[-1]
    hidden, c_out = w1.shape[1], w2.shape[1]
    if (skip.shape[:2] != (bsz, h) or mt.shape != (w, two_m) or a.shape != (bsz, c)
            or b.shape != (bsz, c) or w1.shape[0] != c + s or b1.shape != (hidden,)
            or w2.shape[0] != hidden or (b2 is not None and b2.shape != (c_out,))):
        raise ValueError("spectral_decoder: operand shapes do not match hm (B, H, 2M, C), "
                         "skip (B, H, W, S), mt (W, 2M), a/b (B, C), w1 (C + S, hidden) "
                         "and w2 (hidden, C_out)")
    if not f32 and (c % 16 or hidden % 16 or c > 256 or hidden > 256 or c_out > 96
                    or s > 128):
        raise ValueError(f"spectral_decoder: C {c} and hidden {hidden} must be "
                         "multiples of 16 and at most 256, C_out at most 96, S at most 128")
    if prepared is None:
        prepared = prepare(w1, w2, mt, c, mxu_dtype)
    w1p, w2p, mtp = prepared[:3]
    check_prepared("spectral_decoder", (w1p, w2p, mtp), mxu_dtype)
    od = torch_dtype(out_dtype or "float32")
    if od not in (torch.float32, torch.bfloat16):
        raise ValueError(f"spectral_decoder: unsupported out dtype {od}")
    if f32:
        return _forward_f32(hm, skip, a, b, w1p, b1, w2p, b2, mtp, od, w)
    hmf, hm_bf16 = kernel_operand(hm)
    skf, skip_bf16 = kernel_operand(skip)
    af, bf = a.float().contiguous(), b.float().contiguous()
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous() if b2 is not None else None
    out = torch.empty((bsz, h, w, c_out), dtype=od, device=hm.device)
    # the kernel's scratch: t = bf16(hm * a), 2M padded to the kernel's K
    t = torch.empty((bsz, h, mtp.shape[1], c), dtype=torch.bfloat16, device=hm.device)

    lib = library("spectral_decoder")
    lib.spectral_decoder_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.spectral_decoder_bf16.restype = ctypes.c_int
    lib.spectral_decoder_chunk.restype = ctypes.c_int
    if lib.spectral_decoder_chunk() != DFT_ROW_MULTIPLE:
        raise RuntimeError("spectral_decoder: kernel chunk and DFT_ROW_MULTIPLE differ")
    ptrs = (ctypes.c_void_p * 11)(*[
        p.data_ptr() if p is not None else None
        for p in (hmf, af, bf, mtp, skf, w1p, b1f, w2p, b2f, out, t)
    ])
    ints = (ctypes.c_longlong * 17)(
        bsz, h, w, two_m, mtp.shape[1], mtp.shape[0], c, s, c, w1p.shape[0], hidden,
        c_out, w2p.shape[1], hm_bf16, skip_bf16, int(od == torch.bfloat16),
        int(b2 is not None),
    )
    status = lib.spectral_decoder_bf16(ptrs, ints, stream_ptr(hm))
    check(status, "spectral_decoder")
    global LAUNCHES
    LAUNCHES += 1
    return out


def _forward_f32(hm, skip, a, b, w1p, b1, w2p, b2, at, od, w):
    """The fp32-operand kernel: the folded inverse DFT of hm into an fp32
    grid-field scratch, then the decoder MLP with (a, b) as its input
    affine (csrc/spectral_decoder.cu)."""
    bsz, h, two_m, c = hm.shape
    c_out = w2p.shape[1]
    lib = library("spectral_decoder")
    check_operand("spectral_decoder", lib, at,
                  (_ceil(two_m // 2, FOLD_K), 2 * FOLD_TILE * -(-(w // 2 + 1) // FOLD_TILE)),
                  bf16_ops=0)
    hmf, hm_bf16 = kernel_operand(hm)
    hmf = aligned(hmf)
    xg = torch.empty((bsz * h * w, c), device=hm.device)  # the grid field Mt @ hm
    out = torch.empty((bsz, h, w, c_out), dtype=od, device=hm.device)
    affine = (a.float().contiguous(), b.float().contiguous())
    ptrs, ints, _keep, _ = mlp_f32.mlp_args(xg, w1p, b1, w2p, b2, skip=skip, affine=affine,
                                            out=out, samples=bsz)
    ptrs += [at.data_ptr(), hmf.data_ptr()]
    ints += [bsz, h, w, two_m // 2, at.shape[0], at.shape[1], hm_bf16]
    mlp_f32.launch("spectral_decoder", "spectral_decoder_f32", ptrs, ints, stream_ptr(hm))
    global LAUNCHES
    LAUNCHES += 1
    return out
