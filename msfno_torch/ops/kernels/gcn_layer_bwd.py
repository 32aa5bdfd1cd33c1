"""Backward of one masked-grid GCN layer: the `gcn_layer_bwd` CUDA kernel
(csrc/gcn_layer_bwd.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/gcn_layer.py:_gcn_layer_bwd_call.  With the
forward y = residual + leaky_relu((box3(x @ W * d) * d + b) * mask, slope):

    dagg = g * act' * mask      act' = 1 where y - residual >= 0, else slope
    dsup = box3(dagg * d) * d   (box3 is symmetric: its own transpose)
    dx = dsup @ W^T             dW = x^T @ dsup             db = sum dagg

with dsup, W and x rounded to the matmul operand dtype before the products,
fp32 accumulation.  The residual's cotangent is g itself (the caller's).
On fp32 operands ("float32", "tensorfloat") the kernel's two products are
fp32-class: three TF32 tensor-core passes over hi / lo splits
(`tf32x3`).  Bound on the H100 at a 512 -> 512 layer: memory traffic on
bf16 operands, operations on fp32 operands (see the kernel source).  The
kernel walks strips of latitude rows for dsup and splits dW over pixel
ranges; `dsup_strip_walk`, `dw_split_k` and `gcn_layer_bwd_passes` are
plain mirrors of that decomposition (tests only).
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import (check, kernel_operand, library, operand_dtype,
                                     reduce_groups, stream_ptr, tile_stats_reduce)
from msfno_torch.ops.kernels.gcn_layer import box3
from msfno_torch.ops.kernels.tf32x3 import K_PAD, matmul_tf32x3
from msfno_torch.runtime import mxu_round

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)

STRIP_ROWS = 8  # latitude rows a block of the dsup pass emits (DS_ROWS, gcn_layer_bwd.cu)
SEGMENT = 30  # longitudes a block of the dsup pass emits (DS_PIX - 2)
# the dW split ranges are whole K stages of this many pixels: wgmma_gemm's
# WGM_BK (bf16 operands), dw_mma's MMA_BK (fp32)
SPLIT_CHUNK = {False: 64, True: 32}
# the dW GEMM's output tile: wgmma_gemm's 128 x 256 (bf16 operands), one
# block an SM, splits x tiles at most the card's 132 SMs, one wave (against
# two: half the partials to add, the same GEMM time); dw_mma's 128 x 128
# (fp32), one block an SM, four waves
_DW_TILE = {False: (128, 256), True: (128, 128)}


def gcn_layer_bwd_reference(g, y, residual, x, w, dinv, mask, slope=0.01,
                            mxu_dtype="bfloat16"):
    """Plain version of the Pallas `_make_bwd_kernel` (gcn_layer.py:194-283)
    with its rounding points.  g, y, residual: (B, H, W, F); x: (B, H, W,
    C_in); w: (C_in, F); dinv, mask: (B, H, W, 1).  Returns (dx (B, H, W,
    C_in), dw (C_in, F), db (F,)), all fp32."""
    c_in, f = w.shape
    d = dinv.float()
    dagg = _dagg(g, y, residual, mask, slope)
    dsup = mxu_round(box3(dagg * d) * d, mxu_dtype)
    dx = dsup @ mxu_round(w, mxu_dtype).t()
    dw = mxu_round(x, mxu_dtype).reshape(-1, c_in).t() @ dsup.reshape(-1, f)
    return dx, dw, dagg.reshape(-1, f).sum(0)


def _dagg(g, y, residual, mask, slope):
    yr = y.float() - (residual.float() if residual is not None else 0.0)
    return g.float() * torch.where(yr >= 0, 1.0, slope) * mask.float()


def dsup_strip_walk(g, y, residual, x, dinv, mask, slope=0.01, mxu_dtype="bfloat16",
                    strip=STRIP_ROWS, segment=SEGMENT):
    """Plain mirror of the kernel's dsup pass (tests only): each strip of
    `strip` latitude rows walks its rows with the halo row above and below,
    dagg * d computed once a row and the two previous rows carried; a row's
    vertical sum (own + above) + below, its longitude taps (own + left) +
    right, times d, rounded to `mxu_dtype`.  Returns (dsup (B, H, W, F),
    the column sums of dagg over each row's segments of `segment` longitudes
    (B*H*segments, F) and, for c_in == 1, of bf16(x) * dsup (the same
    shape), else None)."""
    bsz, h, wd, f = g.shape
    segs = -(-wd // segment)
    dagg = _dagg(g, y, residual, mask, slope)
    dbx = dagg * dinv.float()
    xr = mxu_round(x, mxu_dtype).float() if x.shape[-1] == 1 else None
    zero = torch.zeros_like(dbx[:, 0])
    dsup = torch.empty_like(dbx)
    part_db = torch.empty((bsz, h, segs, f))
    part_dw = torch.empty((bsz, h, segs, f)) if xr is not None else None

    def seg_sums(v):  # (B, W, F) -> (B, segments, F)
        return torch.stack([v[:, s * segment:(s + 1) * segment].sum(1) for s in range(segs)], 1)

    for r0 in range(0, h, strip):
        r1 = min(h, r0 + strip)
        prev = cur = zero
        for j in range(r0 - 1, r1 + 1):
            nxt = dbx[:, j] if 0 <= j < h else zero
            if r0 <= j < r1:
                part_db[:, j] = seg_sums(dagg[:, j])
            if j > r0:
                v = cur + prev + nxt
                ds = mxu_round((v + torch.roll(v, 1, 1) + torch.roll(v, -1, 1))
                               * dinv.float()[:, j - 1], mxu_dtype).float()
                dsup[:, j - 1] = ds
                if part_dw is not None:
                    part_dw[:, j - 1] = seg_sums(xr[:, j - 1] * ds)
            prev, cur = cur, nxt
    flat = lambda t: t.reshape(-1, f) if t is not None else None  # noqa: E731
    return dsup, flat(part_db), flat(part_dw)


def dw_split_k(x, dsup, splits: int, chunk: int = SPLIT_CHUNK[False], matmul=torch.matmul):
    """Plain mirror of the kernel's dW (tests only): x^T dsup of (n, c_in) and
    (n, F) over `splits` pixel ranges of ceil(n / splits) rounded up to a
    multiple of `chunk` (a range past the end is empty), each an fp32
    partial by `matmul` (fp32 operands: `tf32x3.matmul_tf32x3`), added in
    order."""
    n = x.shape[0]
    k_split = -(-(-(-n // splits)) // chunk) * chunk
    out = x.new_zeros((x.shape[1], dsup.shape[1]), dtype=torch.float32)
    for z in range(splits):
        xs, ds = x[z * k_split:(z + 1) * k_split], dsup[z * k_split:(z + 1) * k_split]
        out = out + matmul(xs.float().t(), ds.float())
    return out


def dw_splits(n_px: int, c_in: int, f: int, f32_ops: bool) -> int:
    """The kernel's split count of dW over pixel ranges (see `_DW_TILE`),
    each split at least 1024 pixels."""
    if c_in == 1:
        return 1
    tm, tn = _DW_TILE[f32_ops]
    tiles = -(-c_in // tm) * -(-f // tn)
    splits = -(-4 * 132 // tiles) if f32_ops else 132 // tiles
    return max(1, min(n_px // 1024, splits))


def gcn_layer_bwd_passes(g, y, residual, x, w, dinv, mask, slope=0.01, mxu_dtype="bfloat16",
                         strip=STRIP_ROWS, segment=SEGMENT, splits=None):
    """Plain mirror of the kernel's passes (tests only): `dsup_strip_walk`,
    dx = dsup W^T, dW by `dw_split_k` (c_in == 1: the per-row-segment
    partials), the partials added in `tile_stats_reduce`'s order; on fp32
    operands (c_in > 1) both products are the split-precision product
    (`tf32x3.matmul_tf32x3`).  Returns (dx, dw, db) as `gcn_layer_bwd`."""
    c_in, f = w.shape
    dsup, part_db, part_dw = dsup_strip_walk(g, y, residual, x, dinv, mask, slope, mxu_dtype,
                                             strip, segment)
    db = tile_stats_reduce(part_db[None])[0]
    wr = mxu_round(w, mxu_dtype).float()
    if c_in == 1:
        return dsup @ wr.t(), tile_stats_reduce(part_dw[None]), db
    n, f32_ops = dsup.numel() // f, operand_dtype(mxu_dtype) == torch.float32
    matmul = matmul_tf32x3 if f32_ops else torch.matmul
    if splits is None:
        splits = dw_splits(n, c_in, f, f32_ops)
    xr = mxu_round(x, mxu_dtype).float().reshape(n, c_in)
    dx = matmul(dsup.reshape(n, f), wr.t()).reshape(*dsup.shape[:3], c_in)
    return dx, dw_split_k(xr, dsup.reshape(n, f), splits, SPLIT_CHUNK[f32_ops], matmul), db


def gcn_layer_bwd(g, y, residual, x, w, dinv, mask, slope: float = 0.01,
                  mxu_dtype: str = "bfloat16", need_dx: bool = True, prepared=None):
    """Input, weight and bias gradients of `gcn_layer` (the JAX
    `_gcn_layer_bwd_call` contract).  A CPU tensor takes the plain version; a
    CUDA tensor launches the kernel or raises.  Without `need_dx` the kernel
    skips dx and returns None for it.  `prepared` is an optional cached copy
    of w (c_in > 1) in the operand dtype: bf16, or fp32 for the "float32"
    and "tensorfloat" knobs.  On fp32 operands the kernel splits w into hi /
    lo halves on every call, into a scratch of that call: w is a trained
    weight, updated in place between steps."""
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
    f32_ops = operand_dtype(mxu_dtype) == torch.float32
    if f % 8 or (c_in > 1 and c_in % 8 and not f32_ops):
        raise ValueError(f"gcn_layer_bwd: F {f} (and, on bf16 operands, C_in {c_in} > 1) "
                         "must be multiples of 8")
    dev = g.device
    acts = [kernel_operand(t)[0] for t in (g, y, residual) if t is not None]
    if len({t.dtype for t in acts}) > 1:  # the kernel reads them in one type
        acts = [t.float() for t in acts]
    gk, yk, rk = acts if residual is not None else (*acts, None)
    act_bf16 = int(gk.dtype == torch.bfloat16)
    dk, d_bf16 = kernel_operand(dinv)
    mk = mask.to(dk.dtype).contiguous()
    op_dtype = torch.float32 if f32_ops else torch.bfloat16
    if c_in > 1:
        if prepared is not None and (prepared.shape != (c_in, f) or prepared.dtype != op_dtype
                                     or not prepared.is_contiguous()):
            raise ValueError(f"gcn_layer_bwd: prepared w {tuple(prepared.shape)} "
                             f"{prepared.dtype} is not a contiguous ({c_in}, {f}) {op_dtype}")
        xk, x_bf16 = x.to(op_dtype).contiguous(), int(not f32_ops)
        wk = prepared if prepared is not None else w.to(op_dtype).contiguous()
    else:
        xk, x_bf16 = kernel_operand(x)
        wk = w.to(op_dtype).reshape(1, f).contiguous()
    n_px = bsz * h * wd
    splits = dw_splits(n_px, c_in, f, f32_ops)
    dx = torch.empty((bsz, h, wd, c_in), device=dev) if need_dx else None
    dw = torch.empty((c_in, f), device=dev)
    db = torch.empty((f,), device=dev)
    # conv1 without dx needs no dsup: its dW comes from the dsup pass
    dsup = (torch.empty((bsz, h, wd, f), dtype=op_dtype, device=dev)
            if c_in > 1 or need_dx else None)
    lib = library("gcn_layer_bwd")
    lib.gcn_layer_bwd_segments.argtypes = [ctypes.c_int]
    lib.gcn_layer_bwd_segments.restype = ctypes.c_int
    rows = bsz * h * lib.gcn_layer_bwd_segments(wd)  # the dsup pass's partials
    groups, _ = reduce_groups(rows)
    part_db = torch.empty((rows, f), device=dev)
    part_dw = torch.empty((rows, f) if c_in == 1 else (splits, c_in, f), device=dev)
    grp = torch.empty((2 if c_in == 1 else 1, groups, f), device=dev)
    lib.gcn_layer_bwd.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                  ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                                  ctypes.c_void_p]
    lib.gcn_layer_bwd.restype = ctypes.c_int
    # fp32 operands: the hi / lo halves of w, rows padded (dx's K-major B)
    f_pad = -(-f // K_PAD) * K_PAD
    w_x3 = (torch.empty((2, c_in, f_pad), device=dev) if f32_ops and c_in > 1 and need_dx
            else None)
    ptrs = (ctypes.c_void_p * 16)(*[
        t.data_ptr() if t is not None else None
        for t in (gk, yk, rk, xk, wk, dk, mk, dx, dw, db, dsup, part_db, part_dw, grp[0],
                  grp[-1], w_x3)
    ])
    ints = (ctypes.c_longlong * 12)(bsz, h, wd, c_in, f, act_bf16, x_bf16, d_bf16, splits,
                                    int(f32_ops), groups, f_pad)
    status = lib.gcn_layer_bwd(ptrs, ints, slope, stream_ptr(g))
    check(status, "gcn_layer_bwd")
    global LAUNCHES
    LAUNCHES += 1
    return dx, dw, db
