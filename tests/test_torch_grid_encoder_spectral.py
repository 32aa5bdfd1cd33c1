"""grid_encoder_spectral of the PyTorch port: its plain version against the
JAX package's Pallas kernel (interpret mode on the CPU), the Legendre stage
that completes its output into the forward SHT, and the CUDA kernel against
the plain version on a card."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import grid_encoder_spectral as tk
from msfno_torch.ops.kernels.grid_mlp import grid_mlp_reference
from msfno_torch.ops.sht import RealSHT

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
    from msfno_tpu.ops.pallas.grid_mlp import grid_encoder_spectral

    return jnp, grid_encoder_spectral


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(seed=0, b=2, h=6, w=16, c_in=3, hidden=12, c=8, mmax=7, pe=True):
    """Operands as numpy: x (B, H, W, C_in), the MLP, pe (H, W, C) and the
    merged analysis matrix cs (W, 2M) of a (H, W) grid."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    ops = dict(x=r(b, h, w, c_in), w1=0.3 * r(c_in, hidden), b1=0.1 * r(hidden),
               w2=0.3 * r(hidden, c), pe=0.1 * r(h, w, c) if pe else None,
               cs=np.asarray(RealSHT(h, w, lmax=h, mmax=mmax).merged_analysis))
    return ops


def _call(fn, ops, to, **kw):
    args = [None if ops[k] is None else to(ops[k]) for k in ("x", "w1", "b1", "w2", "pe", "cs")]
    return fn(*args, **kw)


@pytest.mark.parametrize("pe", [True, False])
def test_plain_matches_jax_kernel_fp32(pe):
    jnp, jax_enc = _jax()
    ops = _case(pe=pe)
    fj, sj, qj = _call(jax_enc, ops, jnp.asarray, mxu_dtype="float32",
                       out_dtype=jnp.float32, interpret=True)
    ft, st, qt = _call(tk.grid_encoder_spectral, ops, torch.from_numpy,
                       mxu_dtype="float32", out_dtype="float32")
    assert ft.shape == fj.shape == (2, 6, 14, 8) and ft.dtype == torch.float32
    for part, a, b in (("f", ft, fj), ("ssum", st, sj), ("ssq", qt, qj)):
        assert report(f"grid_encoder_spectral[pe={pe}] {part}", rel_l2(a, b)) <= 1e-5


def test_plain_matches_jax_kernel_bf16():
    # bf16 operands, bf16 pe storage and a bf16 f: both sides take exact
    # bf16 products with fp32 sums, in another order, so a bf16 hidden value
    # or output can flip by one ulp where a sum sits on a rounding boundary
    jnp, jax_enc = _jax()
    ops = _case(seed=3)
    pe_j = jnp.asarray(ops["pe"], jnp.bfloat16)
    fj, sj, qj = jax_enc(*(jnp.asarray(ops[k]) for k in ("x", "w1", "b1", "w2")), pe_j,
                         jnp.asarray(ops["cs"]), mxu_dtype="bfloat16", interpret=True)
    pe_t = torch.from_numpy(ops["pe"]).to(torch.bfloat16)
    ft, st, qt = tk.grid_encoder_spectral(
        *(torch.from_numpy(ops[k]) for k in ("x", "w1", "b1", "w2")), pe_t,
        torch.from_numpy(ops["cs"]), mxu_dtype="bfloat16")
    assert ft.dtype == torch.bfloat16 and str(fj.dtype) == "bfloat16"
    assert report("grid_encoder_spectral[bf16] f",
                  rel_l2(ft.float(), np.asarray(fj, np.float32))) <= 1e-2
    assert rel_l2(st, sj) <= 1e-3 and rel_l2(qt, qj) <= 1e-3


def test_legendre_stacked_completes_the_forward_sht():
    # f of the fused head, through the Legendre stage, is the full forward
    # SHT of the encoder output it never stored
    ops = _case(seed=5, h=8, w=16, mmax=9)
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    sht = RealSHT(8, 16, lmax=8, mmax=9)
    f, _, _ = tk.grid_encoder_spectral(t["x"], t["w1"], t["b1"], t["w2"], t["pe"], t["cs"],
                                       mxu_dtype="float32", out_dtype="float32")
    y = grid_mlp_reference(t["x"], t["w1"], t["b1"], t["w2"], pe=t["pe"],
                           mxu_dtype="float32")
    assert report("legendre_stacked(f) vs RealSHT(y)",
                  rel_l2(sht.legendre_stacked(f), sht(y))) <= 1e-5


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
@pytest.mark.parametrize("pe", [None, "float32", "bfloat16"])
def test_two_pass_mirror_matches_jax_kernel(pe, mxu):
    # the kernel's decomposition: the encoder MLP over 128-pixel tiles of
    # each sample (B = 2, H*W = 5 * 160 = 6 * 128 + 32: the last tile
    # ragged), per-tile column sums added in the fixed order of
    # stats_reduce, then the DFT pass on the rounded y.  Tolerance 1e-5
    # with fp32 operands (fp32 sums in another order); 1e-3 with bf16 ones
    # (bf16 products are exact in fp32 on both sides, so only a rare
    # one-ulp flip of a rounded h, y or f where a sum sits on a rounding
    # boundary differs)
    jnp, jax_enc = _jax()
    ops = _case(seed=11, b=2, h=5, w=160, c_in=5, hidden=16, c=16, mmax=9, pe=pe is not None)
    tol = 1e-5 if mxu == "float32" else 1e-3
    out = "float32" if mxu == "float32" else "bfloat16"
    pe_j = None if pe is None else jnp.asarray(ops["pe"], getattr(jnp, pe))
    fj, sj, qj = jax_enc(*(jnp.asarray(ops[k]) for k in ("x", "w1", "b1", "w2")), pe_j,
                         jnp.asarray(ops["cs"]), mxu_dtype=mxu, out_dtype=getattr(jnp, out),
                         interpret=True)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in ops.items()}
    pe_t = None if pe is None else t["pe"].to(getattr(torch, pe))
    y, part_sum, part_sq = tk.encoder_mlp_tiles(t["x"], t["w1"], t["b1"], t["w2"], pe_t, mxu)
    assert part_sum.shape == (2, 7, 16)
    f = tk.dft_pass(y, t["cs"], 160, mxu, out)
    ssum, ssq = tk.tile_stats_reduce(part_sum), tk.tile_stats_reduce(part_sq)
    assert f.shape == fj.shape == (2, 5, 18, 16)
    for part, a, b in (("f", f.float(), np.asarray(fj, np.float32)), ("ssum", ssum, sj),
                       ("ssq", ssq, qj)):
        assert report(f"grid_encoder_spectral two-pass[pe={pe}, {mxu}] {part}",
                      rel_l2(a, b)) <= tol


@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("pe", [True, False])
def test_split_product_mirror_matches_jax_kernel(pe, mxu):
    # the card's fp32 passes (`encoder_f32_passes`): the MLP's products
    # split-precision, 128-row tiles' statistics partials (B = 2, H*W = 5 *
    # 160: the last tile ragged) added in a fixed order, the folded DFT,
    # against the Pallas kernel (interpret mode) on fp32 operands: 1e-5
    jnp, jax_enc = _jax()
    ops = _case(seed=13, b=2, h=5, w=160, c_in=73, hidden=32, c=16, mmax=9, pe=pe)
    fj, sj, qj = _call(jax_enc, ops, jnp.asarray, mxu_dtype=mxu, out_dtype=jnp.float32,
                       interpret=True)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in ops.items()}
    f, ssum, ssq = tk.encoder_f32_passes(*(t[k] for k in ("x", "w1", "b1", "w2", "pe", "cs")))
    assert f.shape == fj.shape == (2, 5, 18, 16) and f.dtype == torch.float32
    for part, a, b in (("f", f, fj), ("ssum", ssum, sj), ("ssq", ssq, qj)):
        assert report(f"grid_encoder_spectral split-product mirror[pe={pe}, {mxu}] {part}",
                      rel_l2(a, b)) <= 1e-5


def test_rational_erf_matches_erf():
    # the head's and tail's GELU take erf as a branch-free rational function
    # (chain_gemm.cuh:gelu_rational); its error against erf stays below
    # 5e-7 in fp32, under a tenth of a bf16 ulp at 1, so the GELU rounded
    # to bf16 differs from the exact one only where it sits within that of
    # a rounding boundary
    x = torch.linspace(-6.0, 6.0, 200001, dtype=torch.float64)
    err = (tk.erf_rational(x).double() - torch.erf(x)).abs().max().item()
    print(f"rational erf max abs err {err:.2e}")
    assert err <= 5e-7


@pytest.mark.cuda
@pytest.mark.parametrize("shape,pe,out", [
    # a ragged last tile (300 = 2 * 128 + 44 pixels a sample), two channel
    # halves (the second one partial), 2M = 60
    (dict(b=2, h=3, w=100, c_in=7, hidden=64, c=160, mmax=30), "bfloat16", "bfloat16"),
    # the serving step's 2M = 242 (padded to 256) at 73 -> 256 -> 256
    (dict(b=1, h=2, w=240, c_in=73, hidden=256, c=256, mmax=121), "bfloat16", "bfloat16"),
    # W = 160, B = 2, C = 64 and 256, c_in 73, pe fp32 / none, f fp32 / bf16
    (dict(b=2, h=3, w=160, c_in=73, hidden=256, c=64, mmax=40), "float32", "float32"),
    (dict(b=2, h=2, w=160, c_in=73, hidden=256, c=256, mmax=80), None, "bfloat16"),
    (dict(b=2, h=3, w=160, c_in=73, hidden=128, c=256, mmax=80), "float32", "bfloat16"),
])
def test_kernel_matches_plain(cuda, shape, pe, out):
    ops = _case(seed=7, pe=pe is not None, **shape)
    t = {k: None if v is None else torch.from_numpy(v).to(cuda) for k, v in ops.items()}
    if pe is not None:
        t["pe"] = t["pe"].to(getattr(torch, pe))
    args = [t[k] for k in ("x", "w1", "b1", "w2", "pe", "cs")]
    before = tk.LAUNCHES
    with torch.inference_mode():
        fk, sk, qk = tk.grid_encoder_spectral(*args, mxu_dtype="bfloat16", out_dtype=out)
        torch.cuda.synchronize()
        fp, sp, qp = tk.grid_encoder_spectral_reference(*args, mxu_dtype="bfloat16",
                                                        out_dtype=out)
    assert tk.LAUNCHES == before + 1
    assert fk.shape == fp.shape and fk.dtype == getattr(torch, out)
    # one-ulp bf16 flips of hidden values; the statistics are fp32 sums in
    # another order (tile partials added in a fixed order)
    assert rel_l2(fk.float().cpu(), fp.float().cpu()) <= 1e-2
    assert rel_l2(sk.cpu(), sp.cpu()) <= 1e-4 and rel_l2(qk.cpu(), qp.cpu()) <= 1e-4


def test_tensorfloat_is_float32_on_cpu():
    ops = _case(seed=6)
    a = _call(tk.grid_encoder_spectral, ops, torch.from_numpy, mxu_dtype="tensorfloat",
              out_dtype="float32")
    b = _call(tk.grid_encoder_spectral, ops, torch.from_numpy, mxu_dtype="float32",
              out_dtype="float32")
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_prepare_fp32():
    """fp32 operands: the MLP's weights as they are, the fold operand of
    dft_analysis for the (C, S) pair of cs, and the split-precision B
    operands of W1^T and W2^T (`tf32x3.kmajor_split`); a bf16 pack is
    refused."""
    from msfno_torch.ops.kernels import check_prepared
    from msfno_torch.ops.kernels import dft_analysis as ak
    from msfno_torch.ops.kernels.tf32x3 import kmajor_split

    t = {k: torch.from_numpy(v) for k, v in _case().items()}
    prepared = tk.prepare(t["w1"], t["w2"], t["cs"], "float32")
    w1p, w2p, at, w1t_x3, w2t_x3 = prepared
    m = t["cs"].shape[1] // 2
    assert torch.equal(w1p, t["w1"]) and torch.equal(w2p, t["w2"])
    assert torch.equal(at, ak.prepare(t["cs"][:, :m], -t["cs"][:, m:], "float32"))
    assert w1t_x3.shape == (2, 12, 16) and w2t_x3.shape == (2, 8, 16)
    assert torch.equal(w1t_x3, kmajor_split(t["w1"]))
    assert torch.equal(w2t_x3, kmajor_split(t["w2"]))
    check_prepared("grid_encoder_spectral", prepared, "tensorfloat")
    with pytest.raises(ValueError):
        check_prepared("grid_encoder_spectral", tk.prepare(t["w1"], t["w2"], t["cs"]),
                       "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("shape,pe,out", [
    (dict(b=2, h=3, w=100, c_in=7, hidden=64, c=160, mmax=30), "float32", "float32"),
    # the serving step's widths, 2M = 242
    (dict(b=1, h=2, w=240, c_in=73, hidden=256, c=256, mmax=121), "float32", "float32"),
    (dict(b=2, h=3, w=160, c_in=73, hidden=256, c=64, mmax=40), "bfloat16", "bfloat16"),
    (dict(b=2, h=2, w=160, c_in=73, hidden=128, c=256, mmax=80), None, "float32"),
])
def test_fp32_kernel_matches_plain(cuda, shape, pe, out, mxu):
    # the kernel's split-precision MLP and folded DFT against the plain
    # version's true fp32 products: the fp32 class (B = 2 with ragged last
    # tiles, a partial second column tile at C = 160, K = 7 and 73 in one
    # stage's k8 steps); a bf16 f rounds nearly the same fp32 value on
    # both sides
    ops = _case(seed=7, pe=pe is not None, **shape)
    t = {k: None if v is None else torch.from_numpy(v).to(cuda) for k, v in ops.items()}
    if pe is not None:
        t["pe"] = t["pe"].to(getattr(torch, pe))
    args = [t[k] for k in ("x", "w1", "b1", "w2", "pe", "cs")]
    before = tk.LAUNCHES
    with torch.inference_mode():
        fk, sk, qk = tk.grid_encoder_spectral(*args, mxu_dtype=mxu, out_dtype=out)
        torch.cuda.synchronize()
        fp, sp, qp = tk.grid_encoder_spectral_reference(*args, mxu_dtype=mxu, out_dtype=out)
    assert tk.LAUNCHES == before + 1
    assert fk.shape == fp.shape and fk.dtype == getattr(torch, out)
    assert rel_l2(fk.float().cpu(), fp.float().cpu()) <= (1e-5 if out == "float32" else 1e-3)
    assert rel_l2(sk.cpu(), sp.cpu()) <= 1e-5 and rel_l2(qk.cpu(), qp.cpu()) <= 1e-5
