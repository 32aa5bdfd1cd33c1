"""Truncated forward longitude DFT: the `dft_analysis` CUDA kernel
(csrc/dft_analysis.cu) and its plain version.

Replaces msfno_tpu/ops/pallas/dft.py:dft_analysis, which the JAX package
runs for `RealSHT(lon_dft="pallas")`.  Per latitude row of x (..., W, C):

    f = [C | -S]^T x          (2M, C) fp32, [re | im] on the mode axis

with C, S (W, M) from `sht._dft_analysis_matrices`: JAX's (fr, fi) =
(x @ C, -(x @ S)), written in the port's stacked (rows, 2M, C) layout that
`RealSHT.legendre_stacked` reads.  Operands are rounded to the `mxu_dtype`
operand type ("bfloat16": bf16; "float32"/"tensorfloat": fp32), products
are accumulated in fp32.  The kernel reads its operand as `prepare` makes
it, which the caller caches:

- fp32 operands: the even/odd fold of the real DFT.  With u_w = x_w +
  x_{W-w} and v_w = x_w - x_{W-w} (u_0 = x_0, and u_{W/2} = x_{W/2} for
  even W), re = C_h^T u and im = -S_h^T v over the W/2 + 1 longitudes of
  the half matrices C_h, S_h: half the multiply-adds of the dense product,
  which it equals up to rounding (`dft_analysis_folded` is its plain
  mirror).  This needs C[W-w] = C[w] and S[W-w] = -S[w], which the
  matrices of `sht._dft_analysis_matrices` have: `prepare` raises
  ValueError on matrices without that symmetry.
- bf16 operands: the dense [C | -S]^T in bf16 (no fold: u_w would be
  rounded to bf16 once more, which the plain version does not do).

The plain version is the dense product.  No gradient: the JAX package
cannot differentiate this path either (its Pallas call has no reverse-mode
rule), so the backward raises on every device instead of returning a
gradient JAX would not give.
"""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import check, library, stream_ptr
from msfno_torch.runtime import mxu_round

LAUNCHES = 0  # kernel launches since the last reset (ops.kernels.reset_launch_counts)

NO_GRADIENT = ("the lon_dft='pallas' DFT kernels have no gradient: the JAX package "
               "cannot differentiate its Pallas DFT path either; use lon_dft='matmul' "
               "or 'fft' to train through the SHT")

# the kernels' tiles that shape a prepared operand (csrc/dft_tiles.cuh), checked
# against the library at each launch: the fp32 fold's K-slab multiple and
# 128-wide half tiles, the bf16 path's 64-deep TMA boxes and 256-row tiles
FOLD_K, FOLD_TILE, BF16_K, BF16_TILE = 16, 128, 64, 256
SYMMETRY_TOL = 1e-6  # of the largest entry


def _ceil(a: int, b: int) -> int:
    return -(-a // b) * b


def fold_maps(w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The fold's index maps over the kh = W // 2 + 1 computed longitudes:
    `mirror[k] = (W - k) % W` and `paired[k]`, false where the mirror is k
    itself (k = 0, and k = W/2 for even W), whose longitude stands alone."""
    k = torch.arange(w // 2 + 1)
    mirror = (w - k) % w
    return mirror, mirror != k


def check_fold_symmetry(name: str, even, odd, axis: int) -> None:
    """Raise ValueError unless even[.., W-w] = even[.., w] and odd[.., W-w]
    = -odd[.., w] along `axis` (the longitude axis), to within SYMMETRY_TOL
    of each matrix's largest entry."""
    w = even.shape[axis]
    mirror = (-torch.arange(w, device=even.device)) % w
    for mat, sign, label in ((even, 1.0, "even"), (odd, -1.0, "odd")):
        mat = mat.double()
        scale = float(mat.abs().max()) or 1.0
        err = float((mat.index_select(axis, mirror) - sign * mat).abs().max()) / scale
        if not err <= SYMMETRY_TOL:
            raise ValueError(f"{name}: the {label} DFT matrix lacks the fold's symmetry in "
                             f"longitude ({err:.2e} of its largest entry > {SYMMETRY_TOL}); "
                             f"the kernel takes the matrices of ops.sht")


def merged_analysis(cmat, smat) -> torch.Tensor:
    """[C | -S] (W, 2M) fp32."""
    return torch.cat([cmat.float(), -smat.float()], dim=1)


def _check_shapes(cmat, smat) -> None:
    if cmat.dim() != 2 or cmat.shape != smat.shape:
        raise ValueError(f"dft_analysis: cmat / smat must be two (W, M) matrices, got "
                         f"{tuple(cmat.shape)} and {tuple(smat.shape)}")


def prepare(cmat, smat, mxu_dtype) -> torch.Tensor:
    """The kernel's operand for `mxu_dtype`.  fp32 operands: the fold's
    half matrices (kh_pad, 256 * ceil(M / 128)) fp32, kh = W // 2 + 1
    padded to FOLD_K; mode tile t holds C_h's modes [128 t, 128 t + 128)
    in columns [256 t, 256 t + 128) and -S_h's in the next 128.  bf16
    operands: [C | -S]^T (2M padded to BF16_TILE, W padded to BF16_K) in
    bf16, rounded to nearest even.  Raises ValueError on matrices whose
    shapes disagree or, for the fold, that lack its symmetry."""
    _check_shapes(cmat, smat)
    w, m = cmat.shape
    if mxu_dtype == "bfloat16":
        out = cmat.new_zeros((_ceil(2 * m, BF16_TILE), _ceil(w, BF16_K)), dtype=torch.float32)
        out[:2 * m, :w] = merged_analysis(cmat, smat).t()
        return out.to(torch.bfloat16)
    if mxu_dtype not in ("float32", "tensorfloat"):
        raise ValueError(f"dft_analysis: unknown mxu dtype {mxu_dtype!r}")
    check_fold_symmetry("dft_analysis", cmat, smat, axis=0)
    kh = w // 2 + 1
    tiles = -(-m // FOLD_TILE)
    out = cmat.new_zeros((_ceil(kh, FOLD_K), 2 * FOLD_TILE * tiles), dtype=torch.float32)
    half = out[:kh].view(kh, tiles, 2, FOLD_TILE)
    for t in range(tiles):
        mw = min(FOLD_TILE, m - t * FOLD_TILE)
        half[:, t, 0, :mw] = cmat[:kh, t * FOLD_TILE:t * FOLD_TILE + mw].float()
        half[:, t, 1, :mw] = -smat[:kh, t * FOLD_TILE:t * FOLD_TILE + mw].float()
    return out


def dft_analysis_plain(x, cmat, smat, mxu_dtype="float32"):
    """Plain version: x (..., W, C) fp32 or bf16, cmat / smat (W, M) ->
    (rows, 2M, C) fp32 with the kernel's rounding points: x and [C | -S]
    rounded to `mxu_dtype`, fp32 products and sums."""
    w, c = x.shape[-2:]
    return torch.matmul(mxu_round(merged_analysis(cmat, smat), mxu_dtype).t(),
                        mxu_round(x.reshape(-1, w, c), mxu_dtype))


def dft_analysis_folded(x, cmat, smat):
    """Plain mirror of the fp32 kernel's folded algebra (tests only): u / v
    from the index maps, then the two half products over `prepare`'s
    operand.  x (..., W, C) -> (rows, 2M, C) fp32."""
    w, c = x.shape[-2:]
    m = cmat.shape[1]
    at = prepare(cmat, smat, "float32")
    kh = w // 2 + 1
    xr = x.reshape(-1, w, c).float()
    mirror, paired = fold_maps(w)
    xm = xr[:, mirror] * paired[:, None].float()
    u, v = xr[:, :kh] + xm, xr[:, :kh] - xm
    half = at[:kh].view(kh, -1, 2, FOLD_TILE)
    ch = half[:, :, 0].reshape(kh, -1)[:, :m]
    nsh = half[:, :, 1].reshape(kh, -1)[:, :m]
    return torch.cat([torch.matmul(ch.t(), u), torch.matmul(nsh.t(), v)], dim=1)


def dft_analysis(x, cmat, smat, mxu_dtype="float32", prepared=None):
    """Forward longitude DFT of every latitude row (JAX `dft_analysis` with
    the output stacked): x (..., W, C) -> (rows, 2M, C) fp32.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel or raises.
    `prepared` is an optional `prepare(cmat, smat, mxu_dtype)` result cached
    by the caller.  With fp32 operands the kernel folds the DFT and takes
    only the symmetric matrices of ops.sht (see the module's note)."""
    return _DftAnalysis.apply(x, cmat, smat, mxu_dtype, prepared)


class _DftAnalysis(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, cmat, smat, mxu_dtype, prepared):
        return _forward(x, cmat, smat, mxu_dtype, prepared)

    @staticmethod
    def backward(ctx, g):
        raise NotImplementedError(NO_GRADIENT)


def operand_flags(name, x, mxu_dtype) -> tuple[int, int]:
    """(input is bf16, bf16 operands) for a DFT kernel call; raises on what
    the kernels do not take."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: input dtype {x.dtype} is not fp32 or bf16")
    if mxu_dtype not in ("float32", "tensorfloat", "bfloat16"):
        raise ValueError(f"{name}: unknown mxu dtype {mxu_dtype!r}")
    return int(x.dtype == torch.bfloat16), int(mxu_dtype == "bfloat16")


_TILES_CHECKED: set = set()


def check_operand(name, lib, at, want_shape, bf16_ops) -> None:
    """Raise unless `at` is the prepared operand of shape `want_shape` for
    this operand type, with the tiles the library was built with (asked of
    each library once)."""
    if id(lib) not in _TILES_CHECKED:
        tiles = getattr(lib, f"{name}_tile")
        tiles.restype = ctypes.c_int
        if tuple(tiles(i) for i in range(4)) != (FOLD_K, FOLD_TILE, BF16_K, BF16_TILE):
            raise RuntimeError(f"{name}: the kernel's tiles and the wrapper's differ")
        _TILES_CHECKED.add(id(lib))
    want = torch.bfloat16 if bf16_ops else torch.float32
    if at.dtype != want or not at.is_contiguous() or tuple(at.shape) != tuple(want_shape):
        raise ValueError(f"{name}: prepared operand {tuple(at.shape)} {at.dtype} is not "
                         f"{tuple(want_shape)} {want}: pass prepare(..., mxu_dtype) of "
                         f"these matrices")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """`t` contiguous, starting on a 16-byte boundary (TMA and the 16-byte
    vector paths need it; a view into a larger tensor may not)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward(x, cmat, smat, mxu_dtype, prepared):
    if x.device.type == "cpu":
        return dft_analysis_plain(x, cmat, smat, mxu_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"dft_analysis: unsupported device {x.device}")
    x_bf16, bf16_ops = operand_flags("dft_analysis", x, mxu_dtype)
    _check_shapes(cmat, smat)
    w, c = x.shape[-2:]
    m = cmat.shape[-1]
    if cmat.shape[0] != w:
        raise ValueError(f"dft_analysis: cmat / smat must be ({w}, M), got "
                         f"{tuple(cmat.shape)}")
    if bf16_ops and c > 128 and c * x.element_size() % 16:
        # JAX's kernel takes C <= 128 or a multiple of 128 only
        raise ValueError(f"dft_analysis: {c} channels of {x.dtype}: above 128 the rows "
                         "must be multiples of 16 bytes")
    at = prepared if prepared is not None else prepare(cmat, smat, mxu_dtype)
    want = ((_ceil(2 * m, BF16_TILE), _ceil(w, BF16_K)) if bf16_ops else
            (_ceil(w // 2 + 1, FOLD_K), 2 * FOLD_TILE * (-(-m // FOLD_TILE))))
    lib = library("dft_analysis")
    check_operand("dft_analysis", lib, at, want, bf16_ops)
    xc = aligned(x)
    rows = xc.numel() // (w * c)
    out = torch.empty((rows, 2 * m, c), device=x.device, dtype=torch.float32)
    fn = lib.dft_analysis
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [vp, vp, vp, ctypes.c_longlong, i32, i32, i32, i32, i32, i32, i32, vp]
    fn.restype = ctypes.c_int
    status = fn(at.data_ptr(), xc.data_ptr(), out.data_ptr(), rows, w, m, c, at.shape[0],
                at.shape[1], x_bf16, bf16_ops, stream_ptr(x))
    check(status, "dft_analysis")
    global LAUNCHES
    LAUNCHES += 1
    return out
