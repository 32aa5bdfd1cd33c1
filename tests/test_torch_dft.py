"""The longitude-DFT kernels of the PyTorch port (dft_analysis,
dft_synthesis): their plain versions against the JAX package's Pallas
kernels (interpret mode) at an odd latitude count and C in {8, 73, 256},
with fp32 and bf16 operands (rel-L2 <= 1e-5: bf16 x bf16 products are exact
in fp32, only the order of summation differs); the plain mirrors of the fp32
kernels' even/odd fold against the dense plain versions and the Pallas
kernels at even and odd W (rel-L2 <= 1e-6: the fold changes only rounding),
and `prepare` refusing matrices without the fold's symmetry; no gradient
through the lon_dft="pallas" SHT, as in JAX; on a card, each kernel against
its plain version."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import dft_analysis as ak
from msfno_torch.ops.kernels import dft_synthesis as sk
from msfno_torch.ops.sht import InverseRealSHT, RealSHT

torch.set_num_threads(2)

NLON, MMAX, H = 32, 9, 5


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_dft():
    pytest.importorskip("jax")
    from msfno_tpu.ops import sht
    from msfno_tpu.ops.pallas import dft

    return sht, dft


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("mxu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 73, 256])
def test_analysis_plain_matches_jax_kernel(c, mxu_dtype):
    sht, dft = _jax_dft()
    import jax.numpy as jnp

    cmat, smat = sht._dft_analysis_matrices(NLON, MMAX)
    x = _x((2, H, NLON, c), c)
    fr, fi = dft.dft_analysis(jnp.asarray(x), jnp.asarray(cmat), jnp.asarray(smat),
                              mxu_dtype=mxu_dtype, interpret=True)
    want = np.concatenate([np.asarray(fr), np.asarray(fi)], axis=-2).reshape(2 * H, 2 * MMAX, c)
    got = ak.dft_analysis(torch.from_numpy(x), torch.from_numpy(cmat), torch.from_numpy(smat),
                          mxu_dtype)
    assert got.shape == want.shape and got.dtype == torch.float32
    err = rel_l2(got, want)
    print(f"parity dft_analysis[C={c}, {mxu_dtype}] rel_l2={err:.3e}")
    assert err <= 1e-5


@pytest.mark.parametrize("mxu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [8, 73, 256])
def test_synthesis_plain_matches_jax_kernel(c, mxu_dtype):
    sht, dft = _jax_dft()
    import jax.numpy as jnp

    ci, si = sht._dft_synthesis_matrices(NLON, MMAX)
    re, im = _x((2, H, MMAX, c), c + 1), _x((2, H, MMAX, c), c + 2)
    want = np.asarray(dft.dft_synthesis(jnp.asarray(re), jnp.asarray(im), jnp.asarray(ci),
                                        jnp.asarray(si), mxu_dtype=mxu_dtype, interpret=True))
    hm = torch.from_numpy(np.concatenate([re, im], axis=-2))  # stacked [re | im]
    got = sk.dft_synthesis(hm, torch.from_numpy(ci), torch.from_numpy(si), mxu_dtype)
    assert got.shape == (2 * H, NLON, c) and got.dtype == torch.float32
    err = rel_l2(got, want.reshape(2 * H, NLON, c))
    print(f"parity dft_synthesis[C={c}, {mxu_dtype}] rel_l2={err:.3e}")
    assert err <= 1e-5
    assert sk.dft_synthesis(hm, torch.from_numpy(ci), torch.from_numpy(si), mxu_dtype,
                            "bfloat16").dtype == torch.bfloat16


@pytest.mark.parametrize("inverse", [False, True])
def test_pallas_path_has_no_gradient(inverse):
    """JAX cannot differentiate its Pallas DFT path; the port's backward
    raises instead of giving a gradient JAX would not."""
    sht, dft = _jax_dft()
    import functools

    import jax
    import jax.numpy as jnp

    kw = dict(lmax=8, mmax=9, lon_dft="pallas")
    x = _x((1, 16, 32, 4), 5)
    fwd = sht.RealSHT(16, 32, **kw)
    orig = dft.dft_analysis, dft.dft_synthesis
    dft.dft_analysis = functools.partial(orig[0], interpret=True)
    dft.dft_synthesis = functools.partial(orig[1], interpret=True)
    try:
        if inverse:
            c = fwd(jnp.asarray(x))
            fn = lambda c: jnp.sum(sht.InverseRealSHT(16, 32, **kw)(c) ** 2)  # noqa: E731
            arg = c
        else:
            fn = lambda x: jnp.sum(jnp.abs(fwd(x)) ** 2)  # noqa: E731
            arg = jnp.asarray(x)
        with pytest.raises(Exception):
            jax.grad(fn)(arg)
    finally:
        dft.dft_analysis, dft.dft_synthesis = orig
    if inverse:
        z = RealSHT(16, 32, **kw)(torch.from_numpy(x)).requires_grad_(True)
        y = InverseRealSHT(16, 32, **kw)(z)
    else:
        y = RealSHT(16, 32, **kw)(torch.from_numpy(x).requires_grad_(True))
    with pytest.raises(NotImplementedError, match="no gradient"):
        y.square().sum().backward()


@pytest.mark.parametrize("c", [8, 73, 256])
@pytest.mark.parametrize("w", [32, 31, 240])
@pytest.mark.parametrize("kernel", ["analysis", "synthesis"])
def test_fold_mirror_matches_dense_and_jax(kernel, w, c):
    """The fp32 kernels' folded algebra (`prepare`'s half matrices, the
    fold / unfold index maps) against the dense plain version and the JAX
    Pallas DFT, fp32."""
    sht, dft = _jax_dft()
    import jax.numpy as jnp

    m, h = min(MMAX, w // 2 + 1), 2
    if kernel == "analysis":
        cmat, smat = sht._dft_analysis_matrices(w, m)
        x = _x((h, w, c), w + c)
        args = (torch.from_numpy(x), torch.from_numpy(cmat), torch.from_numpy(smat))
        got = ak.dft_analysis_folded(*args)
        dense = ak.dft_analysis_plain(*args)
        fr, fi = dft.dft_analysis(jnp.asarray(x), jnp.asarray(cmat), jnp.asarray(smat),
                                  interpret=True)
        want = np.concatenate([np.asarray(fr), np.asarray(fi)], axis=-2)
    else:
        ci, si = sht._dft_synthesis_matrices(w, m)
        re, im = _x((h, m, c), w + c), _x((h, m, c), w + c + 1)
        args = (torch.from_numpy(np.concatenate([re, im], axis=-2)), torch.from_numpy(ci),
                torch.from_numpy(si))
        got = sk.dft_synthesis_folded(*args)
        dense = sk.dft_synthesis_plain(*args)
        want = np.asarray(dft.dft_synthesis(jnp.asarray(re), jnp.asarray(im), jnp.asarray(ci),
                                            jnp.asarray(si), interpret=True))
    assert got.shape == dense.shape == want.shape and got.dtype == torch.float32
    err_dense, err_jax = rel_l2(got, dense), rel_l2(got, want)
    print(f"parity fold {kernel}[W={w}, C={c}] rel_l2 vs dense={err_dense:.3e} "
          f"vs jax={err_jax:.3e}")
    assert err_dense <= 1e-6 and err_jax <= 1e-6


@pytest.mark.parametrize("case", ["asymmetric", "shapes"])
@pytest.mark.parametrize("kernel", ["analysis", "synthesis"])
def test_prepare_refuses_what_the_fold_cannot_take(kernel, case):
    """`prepare` raises on DFT matrices without the fold's symmetry in
    longitude, and on a matrix pair whose shapes disagree."""
    from msfno_torch.ops import sht

    mod = ak if kernel == "analysis" else sk
    mats = (sht._dft_analysis_matrices(32, 9) if kernel == "analysis"
            else sht._dft_synthesis_matrices(32, 9))
    p, q = (torch.from_numpy(a.copy()) for a in mats)
    mod.prepare(p, q, "float32")  # the matrices of ops.sht are taken
    if case == "asymmetric":
        (p if kernel == "analysis" else p.t())[3] += 1e-3  # longitude 3 only
        match = "symmetry"
    else:
        q = q[:-1] if kernel == "analysis" else q[:, :-1]
        match = "matrices"
    with pytest.raises(ValueError, match=match):
        mod.prepare(p, q, "float32")


# on the card: W = 1440 at a few rows, an even and an odd W at ragged row
# counts, and 2M > 256 (several mode tiles and chunks); (rows, W, M)
CARD_SHAPES = [(3, 1440, 121), (9, 240, 121), (5, 31, 16), (2, 600, 201)]


@pytest.mark.cuda
@pytest.mark.parametrize("mxu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("in_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [8, 73, 256])
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_kernels_match_plain_on_card(cuda, shape, c, in_dtype, mxu_dtype):
    from msfno_torch.ops.kernels import launch_counts, reset_launch_counts
    from msfno_torch.ops.sht import _dft_analysis_matrices, _dft_synthesis_matrices
    from msfno_torch.runtime import exact_fp32_matmuls

    exact_fp32_matmuls()
    h, w, m = shape
    cm, sm = (torch.from_numpy(a).to(cuda) for a in _dft_analysis_matrices(w, m))
    ci, si = (torch.from_numpy(a).to(cuda) for a in _dft_synthesis_matrices(w, m))
    x = torch.from_numpy(_x((1, h, w, c), 1)).to(cuda, in_dtype)
    hm = torch.from_numpy(_x((h, 2 * m, c), 2)).to(cuda, in_dtype)
    # non-contiguous views of the same values, which the wrappers make
    # contiguous
    xv = torch.zeros((1, h, w, c + 5), device=cuda, dtype=in_dtype)[..., :c]
    xv.copy_(x)
    hv = torch.zeros((2 * m, h, c), device=cuda, dtype=in_dtype).transpose(0, 1)
    hv.copy_(hm)
    reset_launch_counts()
    f = ak.dft_analysis(x, cm, sm, mxu_dtype)
    y = sk.dft_synthesis(hm, ci, si, mxu_dtype)
    yb = sk.dft_synthesis(hm, ci, si, mxu_dtype, "bfloat16")
    fv = ak.dft_analysis(xv, cm, sm, mxu_dtype)
    yv = sk.dft_synthesis(hv, ci, si, mxu_dtype)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["dft_analysis"] == 2 and counts["dft_synthesis"] == 3
    fp = ak.dft_analysis_plain(x, cm, sm, mxu_dtype)
    plain = sk.dft_synthesis_plain(hm, ci, si, mxu_dtype)
    assert f.shape == fp.shape and y.shape == plain.shape
    assert rel_l2(f.cpu(), fp.cpu()) <= 1e-5
    assert rel_l2(y.cpu(), plain.cpu()) <= 1e-5
    assert yb.dtype == torch.bfloat16 and rel_l2(yb.float().cpu(), plain.cpu()) <= 1e-2
    assert rel_l2(fv.cpu(), fp.cpu()) <= 1e-5 and rel_l2(yv.cpu(), plain.cpu()) <= 1e-5
