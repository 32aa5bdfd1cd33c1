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
accumulation.  The plain version's GELU is exact (erf); the kernel's GELU
derivative is the JAX backward kernel's (Phi from the A&S 7.1.26 erf
polynomial, <= 1.5e-7 absolute) and its recomputed GELU the forward
kernels' branch-free rational erf.  Bound on the H100
at the serving shapes: operations (see the kernel source).  On bf16
operands the kernel runs a tile pass over 128-longitude tiles of each row,
then the transposed DFT (dhm) as a pass of its own; `decoder_bwd_tiles` is
a plain mirror of the two passes (tests only).  On fp32 operands
("float32", "tensorfloat": nothing rounded to bf16) it runs a chain of fp32
passes through device memory, the DFTs folded, the MLP's three products as
fp32-class products in three TF32 tensor-core passes over hi / lo splits
(`tf32x3`); `decoder_bwd_f32_passes` is its plain mirror (tests only).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from msfno_torch.ops.kernels import (check, check_prepared, kernel_operand, library, mlp_f32,
                                     operand_dtype, stats_scratch, stream_ptr,
                                     tile_stats_reduce)
from msfno_torch.ops.kernels.dft_analysis import (BF16_K, BF16_TILE, FOLD_K, FOLD_TILE, _ceil,
                                                  aligned, check_operand, dft_analysis_folded)
from msfno_torch.ops.kernels.grid_encoder_spectral import (
    DFT_ROW_MULTIPLE, REDUCE_GROUPS, TILE_ROWS, erf_rational)
from msfno_torch.ops.kernels.tf32x3 import matmul_tf32x3
from msfno_torch.runtime import mxu_round

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)

_SM_WAVE = 4 * 132  # blocks that fill the card's SMs a few times over
_SUM_RUN = 1024  # rows of g per partial of db2's fixed-order column sums


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


_ERF_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)
_ERF_P = 0.3275911


def gelu_grad_as7126(z: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the kernel's GELU derivative (tests only), as the JAX
    backward kernel computes it: Phi(z) + z phi(z) with Phi from the A&S
    7.1.26 erf (<= 1.5e-7 absolute), whose exp(-z^2 / 2) is phi's too."""
    t = 1.0 / (1.0 + _ERF_P * z.abs() * (1.0 / math.sqrt(2.0)))
    poly = t * (_ERF_A[0] + t * (_ERF_A[1] + t * (_ERF_A[2] + t * (_ERF_A[3] + t * _ERF_A[4]))))
    e = torch.exp(-0.5 * z * z)
    cdf = 0.5 * (1.0 + torch.sign(z) * (1.0 - poly * e))
    return cdf + z * e * (1.0 / math.sqrt(2.0 * math.pi))


def decoder_bwd_tiles(g, hm, skip, mt, a, b, w1, b1, w2, b2=None, mxu_dtype="bfloat16",
                      need_weights=True, tile=TILE_ROWS):
    """Plain mirror of the kernel's two passes (tests only).  Pass A, per
    tile of `tile` longitudes of each row (the last one ragged): x_raw =
    Mt[tile] t with t = bf16(hm); [xa | skip] with xa = bf16(x_raw a + b);
    z1 = [xa | skip] W1 + b1 and dh1 = bf16(g) W2^T, dz1 = dh1 gelu'(z1)
    (A&S 7.1.26's erf, as JAX); [dxa | dskip] = bf16(dz1) [W1a | W1b]^T; the tile's
    column sums of dxa x_raw (fp32 dxa against the fp32 x_raw above: JAX's
    rounding point) and of dxa.  Pass B: dhm = a (Mt^T bf16(dxa)) per row.
    The weight gradients from the tiles' bf16 operands.  Same signature and
    returns as `spectral_decoder_bwd`."""
    bsz, h, two_m, c = hm.shape
    wd = mt.shape[0]
    r = lambda v: mxu_round(v, mxu_dtype)  # noqa: E731
    t = r(hm.float())
    mtr, w1r, w2r = r(mt.float()), r(w1.float()), r(w2.float())
    a4, b4 = a.float()[:, None, None, :], b.float()[:, None, None, :]
    gf = g.float()
    dxas, dskips, da_parts, db_parts = [], [], [], []
    xins, dzs, h1s = [], [], []
    for w0 in range(0, wd, tile):
        x_raw = torch.matmul(mtr[w0:w0 + tile], t)
        xin = torch.cat([r(x_raw * a4 + b4), r(skip[:, :, w0:w0 + tile].float())], dim=-1)
        z1 = xin @ w1r + b1.float()
        dz1 = (r(gf[:, :, w0:w0 + tile]) @ w2r.t()) * gelu_grad_as7126(z1)
        dzm = r(dz1)
        dxa = dzm @ w1r[:c].t()
        dskips.append(dzm @ w1r[c:].t())
        dxas.append(dxa)
        da_parts.append((dxa * x_raw).sum(2))
        db_parts.append(dxa.sum(2))
        xins.append(xin)
        dzs.append(dz1)
        h1s.append(r(torch.nn.functional.gelu(z1, approximate="none")))
    cat = lambda ts: torch.cat(ts, dim=2)  # noqa: E731
    dxa = cat(dxas)
    dhm = torch.matmul(mtr.t(), r(dxa)) * a4
    da = torch.stack(da_parts, 2).sum((1, 2))
    db = torch.stack(db_parts, 2).sum((1, 2))
    if not need_weights:
        return dhm, cat(dskips), da, db, None, None, None, None
    flat = lambda ts: cat(ts).flatten(0, 2)  # noqa: E731
    dz = flat(dzs)
    dw1 = flat(xins).t() @ r(dz)
    dw2 = flat(h1s).t() @ r(gf.reshape(-1, gf.shape[-1]))
    return (dhm, cat(dskips), da, db, dw1, dz.sum(0), dw2,
            gf.reshape(-1, gf.shape[-1]).sum(0) if b2 is not None else None)


def decoder_bwd_f32_passes(g, hm, skip, mt, a, b, w1, b1, w2, b2=None, need_weights=True,
                           tile=TILE_ROWS):
    """Plain mirror of the fp32-operand kernel's passes (tests only), all in
    fp32, the three products of (2)-(4) the split-precision product
    (`tf32x3.matmul_tf32x3`): (1) x_raw = Mt @ hm by the folded inverse
    DFT; (2) z1 = [a x_raw + b | skip] W1 + b1; (3) dz1 = (g W2^T) gelu'(z1)
    (A&S 7.1.26's erf, as JAX); (4) [dxa | dskip] = dz1 [W1a | W1b]^T, and
    per (sample, `tile` pixels, the last one ragged) the sums of dxa x_raw
    and of dxa; (5) da, db: those partials in the kernels' fixed order; (6)
    dhm = Mt^T (a dxa) by the folded forward DFT.  The weight gradients, in
    true fp32: dW1 = [xa | skip]^T dz1, dW2 = gelu(z1)^T g with the forward
    kernels' rational-erf GELU, db1 and db2 column sums.  Same signature
    and returns as `spectral_decoder_bwd` (fp32 operands)."""
    from msfno_torch.ops.kernels.spectral_decoder import _synthesis_pair, _transposed_pair
    from msfno_torch.ops.kernels.dft_synthesis import dft_synthesis_folded

    bsz, h, two_m, c = hm.shape
    wd = mt.shape[0]
    hidden = w1.shape[1]
    mtf = mt.float()
    x_raw = dft_synthesis_folded(hm.float(), *_synthesis_pair(mtf)).reshape(bsz, h * wd, c)
    af, bf = a.float()[:, None, :], b.float()[:, None, :]
    xin = torch.cat([x_raw * af + bf, skip.float().reshape(bsz, h * wd, -1)], dim=-1)
    z1 = matmul_tf32x3(xin, w1.float()) + b1.float()
    gf = g.float().reshape(bsz, h * wd, -1)
    dz = matmul_tf32x3(gf, w2.float().t()) * gelu_grad_as7126(z1)
    dx = matmul_tf32x3(dz, w1.float().t())
    dxa = dx[..., :c]

    def tile_sums(t):  # (B, tiles, C) partials over `tile` pixels of a sample
        t = F.pad(t, (0, 0, 0, -t.shape[1] % tile))
        return t.reshape(bsz, -1, tile, c).sum(2)

    da, db = tile_stats_reduce(tile_sums(dxa * x_raw)), tile_stats_reduce(tile_sums(dxa))
    dhm = dft_analysis_folded((dxa * af).reshape(bsz * h, wd, c), *_transposed_pair(mtf))
    grads = (dhm.reshape(hm.shape), dx[..., c:].reshape(*skip.shape[:3], -1), da, db)
    if not need_weights:
        return (*grads, None, None, None, None)
    h1 = 0.5 * z1 * (1.0 + erf_rational(z1 * (1.0 / math.sqrt(2.0))))
    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    return (*grads, flat(xin).t() @ flat(dz), flat(dz).sum(0).reshape(hidden),
            flat(h1).t() @ flat(gf), flat(gf).sum(0) if b2 is not None else None)


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
    from msfno_torch.ops.kernels.spectral_decoder import prepare

    f32 = operand_dtype(mxu_dtype) == torch.float32
    bsz, h, two_m, c = hm.shape
    wd, s = skip.shape[-2], skip.shape[-1]
    hidden, c_out = w1.shape[1], w2.shape[1]
    if (skip.shape[:2] != (bsz, h) or g.shape != (bsz, h, wd, c_out)
            or mt.shape != (wd, two_m) or a.shape != (bsz, c) or b.shape != (bsz, c)
            or w1.shape[0] != c + s or b1.shape != (hidden,) or w2.shape[0] != hidden):
        raise ValueError("spectral_decoder_bwd: operand shapes do not match hm (B, H, 2M, C), "
                         "skip (B, H, W, S), g (B, H, W, C_out), mt (W, 2M), a/b (B, C), "
                         "w1 (C + S, hidden) and w2 (hidden, C_out)")
    if not f32 and (c % 16 or hidden % 16 or c > 256 or hidden > 256 or c_out > 96
                    or s > 128):
        raise ValueError(f"spectral_decoder_bwd: C {c} and hidden {hidden} must be "
                         "multiples of 16 and at most 256, C_out at most 96, S at most 128")
    if prepared is None:
        prepared = prepare(w1, w2, mt, c, mxu_dtype)
    check_prepared("spectral_decoder_bwd", prepared, mxu_dtype)
    if f32:
        return _bwd_f32(g, hm, skip, a, b, b1, b2, prepared, need_weights)
    w1p, w2p, mtp, w1t, w2t, mtt = prepared
    k1p, n2p, m2p = w1p.shape[0], w2p.shape[1], mtp.shape[1]
    gk, skk = aligned(g.float()), aligned(skip.float())  # the kernel reads fp32 rows
    hmk, hm_bf16 = kernel_operand(hm)
    af, bf = a.float().contiguous(), b.float().contiguous()
    b1f = b1.float().contiguous()
    dev = g.device
    lib = library("spectral_decoder_bwd")
    lib.spectral_decoder_bwd_chunk.restype = ctypes.c_int
    lib.spectral_decoder_bwd_tile_rows.restype = ctypes.c_int
    lib.spectral_decoder_bwd_xr_floats.restype = ctypes.c_int
    if lib.spectral_decoder_bwd_chunk() != DFT_ROW_MULTIPLE:
        raise RuntimeError("spectral_decoder_bwd: kernel chunk and DFT_ROW_MULTIPLE differ")
    check_operand("spectral_decoder_bwd", lib, mtt,
                  (-(-two_m // BF16_TILE) * BF16_TILE, -(-wd // BF16_K) * BF16_K), True)
    n_tiles = bsz * h * -(-wd // lib.spectral_decoder_bwd_tile_rows())
    n_px = bsz * h * wd
    empty = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    dhm, dskip = empty(bsz, h, two_m, c), empty(bsz, h, wd, s)
    da, db = empty(bsz, c), empty(bsz, c)
    t = empty(bsz, h, m2p, c, dtype=torch.bfloat16)
    dxa = empty(n_px, c, dtype=torch.bfloat16)
    part_da, part_db = empty(n_tiles, c), empty(n_tiles, c)
    # the tile pass is persistent, one block per SM; each keeps its tile's
    # fp32 x_raw in a scratch of its own
    blocks = min(n_tiles, torch.cuda.get_device_properties(dev).multi_processor_count)
    xr = empty(blocks, lib.spectral_decoder_bwd_xr_floats())
    # dw1p, db1, dw2p, db2, xin, h1, gb, dz, part_db1, part_db2, part_w
    weights = [None] * 11
    splits, sum_run = 1, _SUM_RUN
    if need_weights:
        tiles = -(-max(k1p, hidden) // 64) * -(-max(hidden, n2p) // 64)
        splits = max(1, min(n_px // 4096, -(-_SM_WAVE // tiles)))
        bf16 = torch.bfloat16
        weights = [empty(k1p, hidden), empty(hidden), empty(hidden, n2p), empty(c_out),
                   empty(n_px, k1p, dtype=bf16), empty(n_px, hidden, dtype=bf16),
                   empty(n_px, n2p, dtype=bf16), empty(n_px, hidden, dtype=bf16),
                   empty(n_tiles * 8, hidden), empty(-(-n_px // sum_run), c_out),
                   empty(splits, max(k1p, n2p) * hidden)]
    dw1p, db1, dw2p, db2, xin, h1, gb, dz, part_db1, part_db2, part_w = weights
    lib.spectral_decoder_bwd_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.spectral_decoder_bwd_bf16.restype = ctypes.c_int
    # the first level of da's and db's sums: at most REDUCE_GROUPS runs
    grp_da, grp_db = empty(bsz, REDUCE_GROUPS, c), empty(bsz, REDUCE_GROUPS, c)
    ptrs = (ctypes.c_void_p * 33)(*[
        p.data_ptr() if p is not None else None
        for p in (gk, hmk, skk, af, bf, mtp, w1p, b1f, w2t, w1t, mtt, dhm, dskip, da, db, dw1p,
                  db1, dw2p, db2, t, dxa, part_da, part_db, xin, h1, gb, dz, part_db1,
                  part_db2, part_w, grp_da, grp_db, xr)
    ])
    ints = (ctypes.c_longlong * 20)(
        bsz, h, wd, two_m, m2p, mtp.shape[0], c, s, k1p, hidden, c_out, n2p, mtt.shape[0],
        mtt.shape[1], hm_bf16, int(need_weights), splits, sum_run, REDUCE_GROUPS, blocks,
    )
    status = lib.spectral_decoder_bwd_bf16(ptrs, ints, stream_ptr(g))
    check(status, "spectral_decoder_bwd")
    global LAUNCHES
    LAUNCHES += 1
    if not need_weights:
        return dhm, dskip, da, db, None, None, None, None
    dw1 = torch.cat([dw1p[:c], dw1p[c:c + s]])
    return dhm, dskip, da, db, dw1, db1, dw2p[:, :c_out], db2 if b2 is not None else None


def _bwd_f32(g, hm, skip, a, b, b1, b2, prepared, need_weights):
    """The fp32-operand kernel (csrc/spectral_decoder_bwd.cu,
    `spectral_decoder_bwd_f32`): its passes through an fp32 grid-field
    scratch and an fp32 hidden scratch, then the folded forward DFT; the
    MLP's products read the prepared hi / lo K-major weights."""
    w1p, w2p, at_syn, at_ana, w1t_x3, w2_x3, w1_x3 = prepared
    bsz, h, two_m, c = hm.shape
    wd, s = skip.shape[-2], skip.shape[-1]
    hidden, c_out = w2p.shape
    m, kh = two_m // 2, wd // 2 + 1
    lib = library("spectral_decoder_bwd")
    check_operand("spectral_decoder_bwd", lib, at_syn,
                  (_ceil(m, FOLD_K), 2 * FOLD_TILE * -(-kh // FOLD_TILE)), bf16_ops=0)
    check_operand("spectral_decoder_bwd", lib, at_ana,
                  (_ceil(kh, FOLD_K), 2 * FOLD_TILE * -(-m // FOLD_TILE)), bf16_ops=0)
    dev = g.device
    n_px = bsz * h * wd
    empty = lambda *shape: torch.empty(shape, device=dev)  # noqa: E731
    gk = aligned(g.float())
    hmk, hm_bf16 = kernel_operand(hm)
    skk, skip_bf16 = kernel_operand(skip)
    af, bf = a.float().contiguous(), b.float().contiguous()
    dhm, dskip = empty(bsz, h, two_m, c), empty(bsz, h, wd, s)
    # (part_da, part_db) per 128-pixel tile, (grp_da, grp_db), (da, db)
    sums, groups = stats_scratch(bsz, h * wd, c, dev)
    xg, z = empty(n_px, c), empty(n_px, hidden)  # the grid field; z1, then dz1
    # dw1, db1, dw2, db2, part_w, part_db1, part_db2
    weights = [None] * 7
    splits = (1, 1)
    if need_weights:
        # pixel ranges that give each dW GEMM a few waves of 128 x 128 tiles
        splits = tuple(max(1, min(n_px // 4096, -(-_SM_WAVE // (-(-r // 128) * -(-k // 128)))))
                       for r, k in ((c + s, hidden), (hidden, c_out)))
        runs = -(-n_px // _SUM_RUN)
        weights = [empty(c + s, hidden), empty(hidden), empty(hidden, c_out),
                   empty(c_out) if b2 is not None else None,
                   empty(max(splits[0] * (c + s) * hidden, splits[1] * hidden * c_out)),
                   empty(runs, hidden), empty(runs, c_out)]
    dw1, db1, dw2, db2, part_w, part_db1, part_db2 = weights
    if (w1t_x3.shape[:2] != (2, hidden) or w2_x3.shape[:2] != (2, hidden)
            or w1_x3.shape[:2] != (2, c + s)):
        raise ValueError("spectral_decoder_bwd: prepared split weights do not match the MLP")
    ptrs = [t.data_ptr() if t is not None else None for t in (
        gk, hmk, skk, af, bf, at_syn, at_ana, w1t_x3, b1.float().contiguous(), w2_x3, w1_x3,
        dhm, dskip, sums[4], sums[5], dw1, db1, dw2, db2, xg, z, sums[0], sums[1], sums[2],
        sums[3], part_w, part_db1, part_db2)]
    ints = [bsz, h, wd, m, c, s, hidden, c_out, *at_syn.shape, *at_ana.shape, hm_bf16,
            skip_bf16, int(need_weights), groups, *splits, _SUM_RUN, w1t_x3.shape[2],
            w2_x3.shape[2], w1_x3.shape[2]]
    mlp_f32.launch("spectral_decoder_bwd", "spectral_decoder_bwd_f32", ptrs, ints,
                   stream_ptr(g))
    global LAUNCHES
    LAUNCHES += 1
    return dhm, dskip, sums[4], sums[5], dw1, db1, dw2, db2
