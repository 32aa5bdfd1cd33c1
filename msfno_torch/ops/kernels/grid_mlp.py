"""Pointwise grid MLP with fused epilogues: the `grid_mlp` CUDA kernel
(csrc/grid_mlp.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/grid_mlp.py:grid_mlp.  Per pixel:

    y = gelu_exact((A*x + B) @ W1a [+ skip @ W1b] + b1) @ W2 [+ b2] [+ pe] [+ res]

with optional per-sample sum(y) and sum(y^2) of the fp32 y before it is
rounded to the output dtype.  Bound on the H100 at the full-resolution call
sites: memory traffic; at the inner block MLP: operations (see the kernel
source).  The kernel walks tiles of 128 rows of one sample, runs a hidden
width above 256 as two passes of the first GEMM, and adds per-tile
statistics partials in a fixed order: `mlp_tiles` and
`ops.kernels.tile_stats_reduce` are plain mirrors of that decomposition
(tests only).  On fp32 operands ("float32", "tensorfloat") the kernel is
two split-precision TF32 GEMMs with h through device memory
(csrc/mlp_f32.cuh:mlp_tf32x3_run; B the hi / lo halves of W1^T and W2^T
that `prepare_weights` adds): the same tiles of 128 rows of one sample and
the same fixed-order statistics, in one pass over the hidden width
(`mlp_tiles` with `half` = hidden and `matmul` =
`tf32x3.matmul_tf32x3`).  The JAX package has no backward kernel here: its
gradient is the VJP of the fp32 pre-rounding reference (`_ref_mlp_f32`,
grid_mlp.py:306-395), and so it is here.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from msfno_torch.ops.kernels import (TILE_ROWS, check, check_prepared, kernel_operand,
                                     library, mlp_f32, operand_dtype, reference_vjp,
                                     stats_scratch, stream_ptr)
from msfno_torch.ops.kernels.tf32x3 import kmajor_split
from msfno_torch.runtime import mxu_round, torch_dtype

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)

HIDDEN_PASS = 256  # the first GEMM's N a pass (GM_HALF, grid_mlp.cu)


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _flat(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


def _check_options(stats_rows, affine, pe, residual):
    if residual is not None and stats_rows is not None:
        # the JAX `_grid_mlp_with_stats` path silently drops the residual
        # (grid_mlp.py:375-384); no call site combines them
        raise ValueError("grid_mlp: residual and stats_rows cannot be combined")
    if affine is not None and (pe is not None or stats_rows is not None):
        raise ValueError("grid_mlp: affine is mutually exclusive with pe/stats")


def grid_mlp_reference(x, w1, b1, w2, b2=None, skip=None, pe=None,
                       mxu_dtype="bfloat16", out_dtype=None, stats_rows=None,
                       affine=None, residual=None):
    """Plain version with the kernel's rounding points: the (affine-applied)
    input, the skip, W1, W2 and the GELU output rounded to `mxu_dtype`;
    fp32 everywhere else.  Same signature and returns as `grid_mlp`."""
    _check_options(stats_rows, affine, pe, residual)
    lead, c_main = x.shape[:-1], x.shape[-1]
    xf = _flat(x).float()
    n = xf.shape[0]
    if affine is not None:
        a, b = (t.reshape(t.shape[0], -1).float() for t in affine)
        ns = a.shape[0]
        xf = (xf.reshape(ns, -1, c_main) * a[:, None] + b[:, None]).reshape(n, c_main)
    w1r = mxu_round(w1, mxu_dtype)
    h = mxu_round(xf, mxu_dtype) @ w1r[:c_main]
    if skip is not None:
        h = h + mxu_round(_flat(skip), mxu_dtype) @ w1r[c_main:]
    h = F.gelu(h + b1.float(), approximate="none")
    y = mxu_round(h, mxu_dtype) @ mxu_round(w2, mxu_dtype)
    if b2 is not None:
        y = y + b2.float()
    c_out = y.shape[-1]
    if pe is not None:
        pf = _flat(pe).float()
        if n % pf.shape[0]:
            raise ValueError(f"pixel count {n} not a multiple of pe rows {pf.shape[0]}")
        y = (y.reshape(-1, pf.shape[0], c_out) + pf).reshape(n, c_out)
    if residual is not None:
        y = y + _flat(residual).float()
    out = y.to(torch_dtype(out_dtype or "float32")).reshape(*lead, c_out)
    if stats_rows is None:
        return out
    ys = y.reshape(-1, stats_rows, c_out)
    return out, ys.sum(1), (ys * ys).sum(1)


def mlp_tiles(x, w1, b1, w2, b2=None, skip=None, pe=None, mxu_dtype="bfloat16",
              stats_rows=None, affine=None, residual=None, tile=TILE_ROWS,
              half=HIDDEN_PASS, matmul=torch.matmul):
    """Plain mirror of the kernel's tile chain (tests only): per sample (of
    `stats_rows` rows, or of the affine's rows, else one), tiles of `tile`
    consecutive rows, the last one ragged; the first GEMM in passes of
    `half` hidden columns, the second GEMM over h's K-chunks in order, each
    an fp32-accumulated product by `matmul` (the card's fp32 operands:
    `tf32x3.matmul_tf32x3`), the epilogue in the plain version's order.
    Returns (y fp32 (rows, C_out);
    each tile's column sums of y and y^2 over its groups of 16 rows, added in
    order, each (samples, tiles, C_out))."""
    _check_options(stats_rows, affine, pe, residual)
    xf = _flat(x).float()
    n, c_main = xf.shape
    samples = (affine[0].shape[0] if affine is not None
               else n // stats_rows if stats_rows is not None else 1)
    rps = n // samples
    hidden, c_out = w1.shape[1], w2.shape[1]
    w1r, w2r = mxu_round(w1, mxu_dtype).float(), mxu_round(w2, mxu_dtype).float()
    tiles = -(-rps // tile)
    y = torch.empty((n, c_out))
    part_sum = torch.zeros((samples, tiles, c_out))
    part_sq = torch.zeros_like(part_sum)
    for smp in range(samples):
        for ti in range(tiles):
            rows = slice(smp * rps + ti * tile, smp * rps + min(rps, (ti + 1) * tile))
            u = xf[rows]
            if affine is not None:
                a, b = (t.reshape(samples, -1).float()[smp] for t in affine)
                u = u * a + b
            u = mxu_round(u, mxu_dtype).float()
            if skip is not None:
                u = torch.cat([u, mxu_round(_flat(skip)[rows], mxu_dtype).float()], dim=1)
            hs = [F.gelu(matmul(u, w1r[:, j:j + half]) + b1.float()[j:j + half],
                         approximate="none")
                  for j in range(0, hidden, half)]
            h = mxu_round(torch.cat(hs, dim=1), mxu_dtype).float()
            yt = matmul(h, w2r)
            if b2 is not None:
                yt = yt + b2.float()
            if pe is not None:
                pf = _flat(pe).float()
                yt = yt + pf[torch.arange(rows.start, rows.stop) % pf.shape[0]]
            if residual is not None:
                yt = yt + _flat(residual).float()[rows]
            y[rows] = yt
            for g in range(0, yt.shape[0], 16):
                part_sum[smp, ti] += yt[g:g + 16].sum(0)
                part_sq[smp, ti] += (yt[g:g + 16] * yt[g:g + 16]).sum(0)
    return y, part_sum, part_sq


def prepare_weights(w1, w2, c_main: int, mxu_dtype: str = "bfloat16"):
    """The kernel's weights for `mxu_dtype`.  bf16 operands: W1 as (k1p,
    hidden) with the main rows padded to a multiple of 16 and the skip rows
    after them, W2 as (hidden, n2p) with zero columns past c_out.  fp32
    operands: W1 and W2 as they are, contiguous fp32, then the
    split-precision B operands (`tf32x3.kmajor_split`: hi and lo, K-major,
    rows zero-padded) of W1^T, whose K holds the main rows padded with
    zeros to a multiple of 4 and then the skip rows (the kernel's A: x's
    rows, then the skip's, each of a width that is a multiple of 4), and
    of W2^T."""
    if operand_dtype(mxu_dtype) == torch.float32:
        w1f, w2f = w1.float().contiguous(), w2.float().contiguous()
        w1k = w1f
        if c_main % 4 and w1f.shape[0] > c_main:
            w1k = torch.cat([w1f[:c_main], w1f.new_zeros((_pad4(c_main) - c_main, w1f.shape[1])),
                             w1f[c_main:]])
        return w1f, w2f, kmajor_split(w1k), kmajor_split(w2f)
    hidden, c_out = w1.shape[1], w2.shape[1]
    c_skip = w1.shape[0] - c_main
    cmp = _pad16(c_main)
    k1p = cmp + (_pad16(c_skip) if c_skip else 0)
    w1p = torch.zeros((k1p, hidden), dtype=torch.bfloat16, device=w1.device)
    w1p[:c_main] = w1[:c_main]
    if c_skip:
        w1p[cmp:cmp + c_skip] = w1[c_main:]
    w2p = torch.zeros((hidden, _pad16(c_out)), dtype=torch.bfloat16, device=w2.device)
    w2p[:, :c_out] = w2
    return w1p, w2p


def grid_mlp(x, w1, b1, w2, b2=None, skip=None, pe=None, mxu_dtype="bfloat16",
             out_dtype=None, stats_rows=None, affine=None, residual=None,
             prepared=None):
    """Fused pointwise two-layer MLP over grid pixels (JAX `grid_mlp` API).

    x: (..., C_main); w1: (C_main + C_skip, hidden); w2: (hidden, C_out);
    skip: (..., C_skip); pe: (H, W, C_out) or (H*W, C_out), broadcast over
    the leading rows; affine: per-sample (A, B), each (n_samples, C_main);
    residual: (..., C_out).  Returns y (..., C_out) in `out_dtype`
    (default fp32), or (y, ssum, ssq) with per-sample fp32 sums when
    `stats_rows` (rows per sample) is set.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.  `prepared` is an
    optional `prepare_weights` result cached by the caller."""
    aff_a, aff_b = affine if affine is not None else (None, None)
    return _GridMlp.apply(x, w1, b1, w2, b2, skip, pe, aff_a, aff_b, residual, mxu_dtype,
                          out_dtype, stats_rows, prepared)


def _ref_f32(x, w1, b1, w2, b2, skip, pe, aff_a, aff_b, residual, stats_rows):
    """The fp32 pre-rounding reference whose VJP is the gradient."""
    affine = (aff_a, aff_b) if aff_a is not None else None
    return grid_mlp_reference(x, w1, b1, w2, b2, skip, pe, "float32", "float32",
                              stats_rows, affine, residual)


class _GridMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, skip, pe, aff_a, aff_b, residual, mxu_dtype,
                out_dtype, stats_rows, prepared):
        affine = (aff_a, aff_b) if aff_a is not None else None
        out = _forward(x, w1, b1, w2, b2, skip, pe, mxu_dtype, out_dtype, stats_rows, affine,
                       residual, prepared)
        ctx.save_for_backward(x, w1, b1, w2, b2, skip, pe, aff_a, aff_b, residual)
        ctx.stats_rows = stats_rows
        return out

    @staticmethod
    def backward(ctx, *grads):
        rows = ctx.stats_rows
        d = reference_vjp(lambda *t: _ref_f32(*t, rows), ctx.saved_tensors,
                          ctx.needs_input_grad[:10], grads)
        return (*d, None, None, None, None)


def _forward(x, w1, b1, w2, b2, skip, pe, mxu_dtype, out_dtype, stats_rows, affine,
             residual, prepared):
    if x.device.type == "cpu":
        return grid_mlp_reference(x, w1, b1, w2, b2, skip, pe, mxu_dtype,
                                  out_dtype, stats_rows, affine, residual)
    if x.device.type != "cuda":
        raise ValueError(f"grid_mlp: unsupported device {x.device}")
    _check_options(stats_rows, affine, pe, residual)
    f32 = operand_dtype(mxu_dtype) == torch.float32
    lead, c_main = x.shape[:-1], x.shape[-1]
    xf, x_bf16 = kernel_operand(_flat(x))
    n = xf.shape[0]
    hidden, c_out = w1.shape[1], w2.shape[1]
    c_skip = w1.shape[0] - c_main
    k1p = _pad16(c_main) + (_pad16(c_skip) if c_skip else 0)
    if not f32 and (hidden % 16 or hidden > 2 * HIDDEN_PASS or c_out > 256 or k1p > 448
                    or (hidden > HIDDEN_PASS and k1p > HIDDEN_PASS)):
        raise ValueError(f"grid_mlp: hidden width {hidden} must be a multiple of 16 and at "
                         f"most {2 * HIDDEN_PASS}, C_out {c_out} at most 256, the padded "
                         f"input width {k1p} at most 448 (at most {HIDDEN_PASS} for a "
                         f"hidden width above {HIDDEN_PASS})")
    if (skip is None) != (c_skip == 0):
        raise ValueError("grid_mlp: w1 rows must equal C_main (+ C_skip with skip)")
    if prepared is None:
        prepared = prepare_weights(w1, w2, c_main, mxu_dtype)
    check_prepared("grid_mlp", prepared, mxu_dtype)
    w1p, w2p = prepared[:2]
    dev = x.device
    od = torch_dtype(out_dtype or "float32")
    if od not in (torch.float32, torch.bfloat16):
        raise ValueError(f"grid_mlp: unsupported out dtype {od}")
    out = torch.empty((n, c_out), dtype=od, device=dev)

    n_samples, rows_per_sample = 1, n
    aff_a = aff_b = None
    if affine is not None:
        aff_a, aff_b = (t.reshape(t.shape[0], -1).float().contiguous() for t in affine)
        n_samples = aff_a.shape[0]
    elif stats_rows is not None:
        n_samples = n // stats_rows
    if n % n_samples:
        raise ValueError(f"grid_mlp: {n} rows do not split into {n_samples} samples")
    rows_per_sample = n // n_samples

    if (b1.shape != (hidden,) or w2.shape[0] != hidden
            or (b2 is not None and b2.shape != (c_out,))
            or (skip is not None and skip.numel() != n * c_skip)
            or (residual is not None and residual.numel() != n * c_out)
            or (pe is not None and pe.shape[-1] != c_out)
            or (aff_a is not None and (aff_a.shape != (n_samples, c_main)
                                       or aff_b.shape != aff_a.shape))):
        raise ValueError("grid_mlp: operand shapes do not match x (..., C_main), "
                         "w1 (C_main + C_skip, hidden) and w2 (hidden, C_out)")
    if pe is not None and n % _flat(pe).shape[0]:
        raise ValueError(f"pixel count {n} not a multiple of pe rows {_flat(pe).shape[0]}")
    global LAUNCHES
    if f32:
        sums = _forward_f32(xf, skip, pe, b1, b2, residual, (aff_a, aff_b), out, n_samples,
                            stats_rows is not None, prepared, stream_ptr(x))
        LAUNCHES += 1
        out = out.reshape(*lead, c_out)
        return out if sums is None else (out, *sums)
    skf, skip_bf16 = kernel_operand(_flat(skip)) if skip is not None else (None, 0)
    pef, pe_bf16, pe_rows = None, 0, 0
    if pe is not None:
        pef, pe_bf16 = kernel_operand(_flat(pe))
        pe_rows = pef.shape[0]
        if stats_rows is None:  # tiles of one pe table each: its bf16 rows come by TMA
            n_samples, rows_per_sample = n // pe_rows, pe_rows
    rsf, res_bf16 = kernel_operand(_flat(residual)) if residual is not None else (None, 0)
    b1f = b1.float().contiguous()
    b2f = b2.float().contiguous() if b2 is not None else None

    lib = library("grid_mlp")
    lib.grid_mlp_bf16.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p]
    lib.grid_mlp_bf16.restype = ctypes.c_int
    part_sum, part_sq, grp_sum, grp_sq, ssum, ssq = [None] * 6
    groups = 1
    if stats_rows is not None:
        (part_sum, part_sq, grp_sum, grp_sq, ssum, ssq), groups = stats_scratch(
            n_samples, rows_per_sample, c_out, dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    ptrs = (ctypes.c_void_p * 17)(*[
        ptr(xf), ptr(skf), ptr(aff_a), ptr(aff_b), ptr(w1p), ptr(b1f), ptr(w2p),
        ptr(b2f), ptr(pef), ptr(rsf), ptr(out), ptr(part_sum), ptr(part_sq),
        ptr(grp_sum), ptr(grp_sq), ptr(ssum), ptr(ssq),
    ])
    cmp = _pad16(c_main)
    ints = (ctypes.c_longlong * 16)(
        n_samples, rows_per_sample, pe_rows, c_main, c_skip, cmp, w1p.shape[0],
        hidden, c_out, w2p.shape[1], x_bf16, skip_bf16, pe_bf16, res_bf16,
        int(od == torch.bfloat16), groups,
    )
    status = lib.grid_mlp_bf16(ptrs, ints, stream_ptr(x))
    check(status, "grid_mlp")
    LAUNCHES += 1
    out = out.reshape(*lead, c_out)
    if stats_rows is None:
        return out
    return out, ssum, ssq


def _forward_f32(xf, skip, pe, b1, b2, residual, affine, out, samples, stats, prepared,
                 stream):
    """The fp32-operand kernel (csrc/grid_mlp.cu:grid_mlp_f32): x's rows,
    then the skip's, each copied first into fp32 rows of a multiple of 4
    floats where it is not such rows, against the prepared hi / lo halves
    of W1^T and W2^T, into `out`; b2, pe and the residual, where a call has
    more than one of them, added into one fp32 table first.  Returns (ssum,
    ssq) with `stats`, else None."""
    w1p, w2p, w1t_x3, w2t_x3 = prepared
    (rows, c_main), (hidden, c_out) = xf.shape, w2p.shape
    c_skip = w1p.shape[0] - c_main
    k = _pad4(c_main) + _pad4(c_skip)
    if (w1t_x3.shape[:2] != (2, hidden) or w1t_x3.shape[2] < k
            or w2t_x3.shape[:2] != (2, c_out) or w2t_x3.shape[2] < hidden):
        raise ValueError("grid_mlp: prepared split weights do not match the MLP")
    if (b2 is not None) + (pe is not None) + (residual is not None) > 1:
        # one addend table (mlp_f32.cuh:OutAdd): the residual's rows, or pe's
        table = 0.0 if b2 is None else b2.float()
        if pe is not None:
            pf = _flat(pe).float()
            table = table + pf if residual is None else (
                _flat(residual).float().reshape(-1, pf.shape[0], c_out) + pf + table
            ).reshape(rows, c_out)
        else:
            table = _flat(residual).float() + table
        b2 = None
        pe, residual = (table, None) if residual is None else (None, table)
    # with statistics the kernel writes fp32 y
    y = out if not stats or out.dtype == torch.float32 else torch.empty(
        out.shape, device=out.device)
    ptrs, ints, _keep, sums = mlp_f32.mlp_args(
        xf, w1t_x3, b1, w2t_x3, b2, skip=skip, pe=pe, affine=affine, residual=residual,
        out=y, samples=samples, stats=stats)
    # x and the skip as 16-byte aligned fp32 rows of a multiple of 4 floats,
    # else the kernel copies them into such rows first
    pads = [torch.empty((rows, _pad4(c)), device=xf.device)
            if t is not None and (c % 4 or t.dtype != torch.float32 or t.data_ptr() % 16)
            else None for t, c in ((xf, c_main), (_keep[1], c_skip))]
    ptrs += [t.data_ptr() if t is not None else None for t in pads]
    mlp_f32.launch("grid_mlp", "grid_mlp_f32", ptrs, ints, stream)
    if y is not out:
        out.copy_(y)
    return sums
