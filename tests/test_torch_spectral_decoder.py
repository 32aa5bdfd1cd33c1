"""spectral_decoder of the PyTorch port: its plain version against the JAX
package's Pallas kernel (interpret mode on the CPU), the spectral-space
statistics against the JAX package's and against pixel statistics of the
synthesized field, and the CUDA kernel against the plain version on a card."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import spectral_decoder as tk
from msfno_torch.ops.sht import InverseRealSHT

torch.set_num_threads(2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def report(name, value):
    """The measured error, for the parity table (pytest -s shows it)."""
    print(f"parity {name} rel_l2={value:.3e}")
    return value


def _jax():
    """The JAX side, imported in the tests that use it: the card's machine
    has no JAX, and runs only the cuda tests of this file."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas import spectral_decoder as jk

    return jnp, jk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


NAMES = ("hm", "skip", "mt", "a", "b", "w1", "b1", "w2", "b2")


def _case(seed=0, b=2, h=4, w=16, mmax=7, c=8, s=3, hidden=12, c_out=3, b2=True):
    """Operands as numpy: hm (B, H, 2M, C), skip (B, H, W, S), the merged
    synthesis matrix mt (W, 2M) of a (H, W) grid, the affine and the MLP."""
    rng = np.random.default_rng(seed)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    mt = np.asarray(InverseRealSHT(h, w, lmax=h, mmax=mmax).merged_matrix_t)
    return dict(hm=r(b, h, 2 * mmax, c), skip=r(b, h, w, s), mt=mt,
                a=1.0 + 0.2 * r(b, c), b=0.2 * r(b, c), w1=0.3 * r(c + s, hidden),
                b1=0.1 * r(hidden), w2=0.3 * r(hidden, c_out),
                b2=0.1 * r(c_out) if b2 else None)


def _call(fn, ops, to, **kw):
    return fn(*(None if ops[k] is None else to(ops[k]) for k in NAMES), **kw)


@pytest.mark.parametrize("b2", [True, False])
def test_plain_matches_jax_kernel_fp32(b2):
    jnp, jk = _jax()
    ops = _case(b2=b2)
    yj = _call(jk.spectral_decoder, ops, jnp.asarray, mxu_dtype="float32", interpret=True)
    yt = _call(tk.spectral_decoder, ops, torch.from_numpy, mxu_dtype="float32")
    assert yt.shape == yj.shape == (2, 4, 16, 3) and yt.dtype == torch.float32
    assert report(f"spectral_decoder[b2={b2}]", rel_l2(yt, yj)) <= 1e-5


def test_plain_matches_jax_kernel_bf16():
    # bf16 rounding of t, Mt, x, skip and the hidden activation on both
    # sides; exact bf16 products with fp32 sums in another order can flip a
    # bf16 value by one ulp where a sum sits on a rounding boundary
    jnp, jk = _jax()
    ops = _case(seed=3)
    yj = _call(jk.spectral_decoder, ops, jnp.asarray, mxu_dtype="bfloat16", interpret=True)
    yt = _call(tk.spectral_decoder, ops, torch.from_numpy, mxu_dtype="bfloat16")
    assert report("spectral_decoder[bf16]", rel_l2(yt, yj)) <= 1e-2


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
@pytest.mark.parametrize("b2", [True, False])
def test_tile_chain_mirror_matches_jax_kernel(b2, mxu):
    # the kernel's decomposition: three chained GEMMs per tile of 128
    # longitudes (W = 160: the last tile ragged), B = 2.  Tolerance 1e-5
    # with fp32 operands (fp32 sums in another order); 1e-3 with bf16 ones
    # (bf16 products are exact in fp32 on both sides, so only a rare
    # one-ulp flip of a rounded x or h where a sum sits on a rounding
    # boundary differs)
    jnp, jk = _jax()
    ops = _case(seed=13, b=2, h=4, w=160, mmax=9, c=16, s=5, hidden=16, c_out=5, b2=b2)
    yj = _call(jk.spectral_decoder, ops, jnp.asarray, mxu_dtype=mxu, interpret=True)
    yt = _call(tk.decoder_tiles, ops, torch.from_numpy, mxu_dtype=mxu)
    assert yt.shape == yj.shape == (2, 4, 160, 5) and yt.dtype == torch.float32
    tol = 1e-5 if mxu == "float32" else 1e-3
    assert report(f"spectral_decoder tile chain[b2={b2}, {mxu}]", rel_l2(yt, yj)) <= tol


def test_spectral_grid_stats():
    jnp, jk = _jax()
    itrans = InverseRealSHT(8, 32, lmax=8, mmax=9)
    hm = np.random.default_rng(1).standard_normal((2, 8, 18, 5)).astype(np.float32)
    omega = torch.from_numpy(itrans.mode_power_weights)
    mean, mean_sq = tk.spectral_grid_stats(torch.from_numpy(hm), omega)
    mj, qj = jk.spectral_grid_stats(jnp.asarray(hm), itrans.mode_power_weights)
    assert report("spectral_grid_stats mean", rel_l2(mean, mj)) <= 1e-5
    assert report("spectral_grid_stats mean_sq", rel_l2(mean_sq, qj)) <= 1e-5
    # the pixel statistics of the field x = Mt hm, in float64
    x = np.einsum("bhmc,wm->bhwc", hm.astype(np.float64), itrans.merged_matrix_t)
    np.testing.assert_allclose(mean, x.mean(axis=(1, 2)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mean_sq, (x * x).mean(axis=(1, 2)), rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,out", [
    # ragged last tile, 2M = 60, C = 32, no b2
    (dict(b=2, h=3, w=100, mmax=30, c=32, s=5, hidden=48, c_out=5, b2=False), "float32"),
    # the serving step's widths: 2M = 242 (padded to 256), 256 + 73 -> 256 -> 73
    (dict(b=1, h=2, w=240, mmax=121, c=256, s=73, hidden=256, c_out=73), "float32"),
    # W = 160 (128 + 32), B = 2, C = 64 and 256, c_out = 73, bf16 and fp32 out
    (dict(b=2, h=3, w=160, mmax=40, c=64, s=73, hidden=256, c_out=73), "bfloat16"),
    (dict(b=2, h=2, w=160, mmax=80, c=256, s=73, hidden=256, c_out=73), "float32"),
    (dict(b=2, h=2, w=160, mmax=80, c=256, s=73, hidden=128, c_out=73, b2=False),
     "bfloat16"),
])
def test_kernel_matches_plain(cuda, shape, out):
    ops = _case(seed=7, **shape)
    args = [None if ops[k] is None else torch.from_numpy(ops[k]).to(cuda) for k in NAMES]
    before = tk.LAUNCHES
    with torch.inference_mode():
        yk = tk.spectral_decoder(*args, mxu_dtype="bfloat16", out_dtype=out)
        torch.cuda.synchronize()
        yp = tk.spectral_decoder_reference(*args, mxu_dtype="bfloat16", out_dtype=out)
    assert tk.LAUNCHES == before + 1
    assert yk.shape == yp.shape and yk.dtype == getattr(torch, out)
    # one-ulp bf16 flips of x or hidden values, fp32 sums in another order
    assert rel_l2(yk.float().cpu(), yp.float().cpu()) <= 1e-2


@pytest.mark.cuda
def test_prepared_reaches_the_backward(cuda):
    """The forward's cached `prepare` tuple, handed on to
    spectral_decoder_bwd at the serving widths after a forward launch: the
    gradients match the plain backward's."""
    from msfno_torch.ops.kernels import spectral_decoder_bwd as tb

    ops = _case(seed=9, b=1, h=2, w=160, mmax=80, c=256, s=73, hidden=256, c_out=73)
    args = [None if ops[k] is None else torch.from_numpy(ops[k]).to(cuda) for k in NAMES]
    prepared = tk.prepare(args[5], args[7], args[2], 256)
    args[0].requires_grad_(True)
    args[1].requires_grad_(True)
    y = tk.spectral_decoder(*args, prepared=prepared)
    g = torch.randn(y.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    before = tb.LAUNCHES
    dhm, dskip = torch.autograd.grad(y, (args[0], args[1]), g)
    assert tb.LAUNCHES == before + 1
    want = tb.spectral_decoder_bwd_reference(g, *[a.detach() if a is not None else None
                                                  for a in args])
    assert rel_l2(dhm.cpu(), want[0].cpu()) <= 1e-2
    assert rel_l2(dskip.cpu(), want[1].cpu()) <= 1e-2


@pytest.mark.cuda
def test_cuda_input_with_grad_raises(cuda):
    """Inputs that need a gradient no longer raise on the card: the forward
    kernel records the backward kernel, whose gradients match the plain
    backward's."""
    from msfno_torch.ops.kernels import spectral_decoder_bwd as tb

    ops = _case(c=16, hidden=16)
    args = [None if ops[k] is None else torch.from_numpy(ops[k]).to(cuda) for k in NAMES]
    args[0].requires_grad_(True)
    args[3].requires_grad_(True)
    y = tk.spectral_decoder(*args)
    g = torch.randn(y.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
    before = tb.LAUNCHES
    dhm, da = torch.autograd.grad(y, (args[0], args[3]), g)
    assert tb.LAUNCHES == before + 1
    want = tb.spectral_decoder_bwd_reference(g, *[a.detach() if a is not None else None
                                                  for a in args])
    assert rel_l2(dhm.cpu(), want[0].cpu()) <= 1e-2
    assert rel_l2(da.cpu(), want[2].cpu()) <= 1e-2


@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("b2", [True, False])
def test_fp32_passes_mirror_matches_jax_kernel(b2, mxu):
    """The fp32 kernel's algebra: the folded inverse DFT of the unscaled hm,
    then the decoder MLP with (a, b) as its input affine (a scale folded
    past the DFT), against the Pallas kernel (interpret mode) on fp32
    operands; W = 160, an odd W / 2 + 1 = 81 of half longitudes."""
    jnp, jk = _jax()
    ops = _case(seed=14, b=2, h=4, w=160, mmax=9, c=16, s=5, hidden=16, c_out=5, b2=b2)
    yj = _call(jk.spectral_decoder, ops, jnp.asarray, mxu_dtype=mxu, interpret=True)
    yt = _call(tk.decoder_f32_passes, ops, torch.from_numpy)
    assert yt.shape == yj.shape == (2, 4, 160, 5) and yt.dtype == torch.float32
    assert report(f"spectral_decoder fp32 passes[b2={b2}, {mxu}]", rel_l2(yt, yj)) <= 1e-5


@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
def test_fp32_split_product_mirror_odd_widths_matches_jax(mxu):
    """The fp32 kernel's two products on the split-precision product
    (`decoder_f32_passes`: [a x + b | skip] W1 and h W2 by
    `tf32x3.matmul_tf32x3`) at the serving step's odd widths, a 73-wide skip
    and 73 output columns (K = C + 73 not a multiple of the core's 32-wide
    stages, N = 73 of an 80-column tile), W = 160, B = 2, against the
    Pallas kernel (interpret mode) on fp32 operands, to 1e-5."""
    jnp, jk = _jax()
    ops = _case(seed=15, b=2, h=2, w=160, mmax=20, c=32, s=73, hidden=48, c_out=73)
    yj = _call(jk.spectral_decoder, ops, jnp.asarray, mxu_dtype=mxu, interpret=True)
    yt = _call(tk.decoder_f32_passes, ops, torch.from_numpy)
    assert yt.shape == yj.shape == (2, 2, 160, 73) and yt.dtype == torch.float32
    assert report(f"spectral_decoder fp32 split product, S = C_out = 73[{mxu}]",
                  rel_l2(yt, yj)) <= 1e-5


def test_tensorfloat_is_float32_on_cpu():
    ops = _case(seed=6)
    a = _call(tk.spectral_decoder, ops, torch.from_numpy, mxu_dtype="tensorfloat")
    assert torch.equal(a, _call(tk.spectral_decoder, ops, torch.from_numpy,
                                mxu_dtype="float32"))


def test_prepare_fp32():
    """fp32 operands: the MLP's weights as they are, the fold operand of
    dft_synthesis for the (Ci, Si) pair of Mt and, for the backward's dhm,
    the fold operand of dft_analysis for Mt's cos columns and its negated
    sin columns; then the split-precision B operands (W1^T, W2, W1 and W2^T
    as `tf32x3.kmajor_split` lays them out); a bf16 pack is refused."""
    from msfno_torch.ops.kernels import check_prepared
    from msfno_torch.ops.kernels import dft_analysis as ak
    from msfno_torch.ops.kernels import dft_synthesis as sk
    from msfno_torch.ops.kernels.tf32x3 import kmajor_split

    t = {k: torch.from_numpy(v) for k, v in _case().items()}
    prepared = tk.prepare(t["w1"], t["w2"], t["mt"], 8, "float32")
    w1p, w2p, at, at_bwd, w1t_x3, w2_x3, w1_x3, w2t_x3 = prepared
    m = t["mt"].shape[1] // 2
    assert torch.equal(w1p, t["w1"]) and torch.equal(w2p, t["w2"])
    assert torch.equal(at, sk.prepare(t["mt"][:, :m].t(), -t["mt"][:, m:].t(), "float32"))
    assert torch.equal(at_bwd, ak.prepare(t["mt"][:, :m], -t["mt"][:, m:], "float32"))
    assert torch.equal(w1t_x3, kmajor_split(t["w1"]))
    assert torch.equal(w2_x3, kmajor_split(t["w2"].t()))
    assert torch.equal(w1_x3, kmajor_split(t["w1"].t()))
    assert torch.equal(w2t_x3, kmajor_split(t["w2"]))
    check_prepared("spectral_decoder", prepared, "tensorfloat")
    with pytest.raises(ValueError):
        check_prepared("spectral_decoder", tk.prepare(t["w1"], t["w2"], t["mt"], 8)[:3],
                       "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("shape,hm_dtype,out", [
    (dict(b=2, h=3, w=100, mmax=30, c=32, s=5, hidden=48, c_out=5, b2=False), "float32",
     "float32"),
    # the serving step's widths: 2M = 242, 256 + 73 -> 256 -> 73
    (dict(b=1, h=2, w=240, mmax=121, c=256, s=73, hidden=256, c_out=73), "float32",
     "float32"),
    (dict(b=2, h=3, w=160, mmax=40, c=64, s=73, hidden=256, c_out=73), "bfloat16",
     "bfloat16"),
])
def test_fp32_kernel_matches_plain(cuda, shape, hm_dtype, out, mxu):
    # the kernel's split-precision products (about 21 of fp32's 24
    # significand bits) against the true-fp32 plain version, and the sums'
    # order (the card folds the DFT and scales after it); a bf16 output
    # rounds the same fp32 value
    ops = _case(seed=7, **shape)
    args = [None if ops[k] is None else torch.from_numpy(ops[k]).to(cuda) for k in NAMES]
    args[0] = args[0].to(getattr(torch, hm_dtype))
    before = tk.LAUNCHES
    with torch.inference_mode():
        yk = tk.spectral_decoder(*args, mxu_dtype=mxu, out_dtype=out)
        torch.cuda.synchronize()
        yp = tk.spectral_decoder_reference(*args, mxu_dtype=mxu, out_dtype=out)
    assert tk.LAUNCHES == before + 1
    assert yk.shape == yp.shape and yk.dtype == getattr(torch, out)
    assert rel_l2(yk.float().cpu(), yp.float().cpu()) <= (1e-5 if out == "float32" else 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
def test_fp32_backward_launches_kernel(cuda, mxu):
    """Training through the fp32 tail: its backward launches the fp32
    spectral_decoder_bwd kernel once a call and gives the plain fp32
    gradients."""
    from msfno_torch.ops.kernels import spectral_decoder_bwd as tb

    ops = _case(c=16, hidden=16)
    args = [None if ops[k] is None else torch.from_numpy(ops[k]).to(cuda) for k in NAMES]
    leaves = {n: v.requires_grad_(True) for n, v in zip(NAMES, args)
              if n != "mt" and v is not None}
    y = tk.spectral_decoder(*args, mxu_dtype=mxu)
    before = tb.LAUNCHES
    gk = torch.autograd.grad(y.sum(), list(leaves.values()))
    torch.cuda.synchronize()
    assert tb.LAUNCHES == before + 1
    yp = tk.spectral_decoder_reference(*args, mxu_dtype="float32")
    gp = torch.autograd.grad(yp.sum(), list(leaves.values()))
    for n, a, b in zip(leaves, gk, gp):
        assert rel_l2(a.cpu(), b.cpu()) <= 1e-5, n


@pytest.mark.cuda
def test_fp32_bad_prepared_raises(cuda):
    """The fp32 tail's prepared split weights: a wrong shape raises before
    the launch, a misaligned one (not a 16-byte TMA operand) makes the
    kernel refuse it and the wrapper raise; nothing falls back to the
    plain version or to another product."""
    ops = _case(seed=8, c=16, hidden=16)
    args = [None if ops[k] is None else torch.from_numpy(ops[k]).to(cuda) for k in NAMES]
    prepared = tk.prepare(args[5], args[7], args[2], 16, "float32")
    w2t_x3 = prepared[7]
    wrong = (*prepared[:7], w2t_x3[:, :, :8].contiguous())
    shifted = torch.empty(w2t_x3.numel() + 1, device=cuda)[1:].view(w2t_x3.shape)
    shifted.copy_(w2t_x3)
    misaligned = (*prepared[:7], shifted)
    before = tk.LAUNCHES
    with torch.inference_mode():
        with pytest.raises(ValueError):
            tk.spectral_decoder(*args, mxu_dtype="float32", prepared=wrong)
        with pytest.raises(RuntimeError):
            tk.spectral_decoder(*args, mxu_dtype="float32", prepared=misaligned)
            torch.cuda.synchronize()
    assert tk.LAUNCHES == before
