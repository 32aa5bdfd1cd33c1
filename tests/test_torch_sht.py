"""SHT of the PyTorch port against the JAX package: the numpy quadrature and
Legendre copies, analysis, synthesis, the merged-layout helpers and the
round trip, in fp32 (rel-L2 <= 1e-5)."""

import numpy as np
import pytest
import torch

from msfno_torch.ops import legendre as t_leg
from msfno_torch.ops import quadrature as t_quad
from msfno_torch.ops.sht import InverseRealSHT, RealSHT

torch.set_num_threads(2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def report(name, value):
    """The measured error, for the parity table (pytest -s shows it)."""
    print(f"parity {name} rel_l2={value:.3e}")
    return value


def _jax_sht():
    pytest.importorskip("jax")
    from msfno_tpu.ops import sht

    return sht


GRIDS = [
    dict(nlat=17, nlon=32, lmax=8, mmax=9, grid="equiangular", spectral_rescale=1e5),
    dict(nlat=12, nlon=24, grid="legendre-gauss"),
]


def _spectral(z) -> np.ndarray:
    z = np.asarray(z)
    return np.stack([z.real, z.imag])


@pytest.mark.parametrize("grid", ["legendre-gauss", "equiangular"])
def test_numpy_copies_match(grid):
    pytest.importorskip("jax")
    from msfno_tpu.ops import legendre, quadrature

    for a, b in zip(t_quad.grid_quadrature(grid, 13), quadrature.grid_quadrature(grid, 13)):
        np.testing.assert_array_equal(a, b)
    x, _ = t_quad.grid_quadrature(grid, 13)
    np.testing.assert_array_equal(t_leg.legendre_matrix(9, 7, x),
                                  legendre.legendre_matrix(9, 7, x))


@pytest.mark.parametrize("kw", GRIDS)
def test_analysis_and_synthesis_match_jax(kw):
    sht = _jax_sht()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, kw["nlat"], kw["nlon"], 3)).astype(np.float32)
    jf, ji = sht.RealSHT(**kw), sht.InverseRealSHT(**kw)
    tf, ti = RealSHT(**kw), InverseRealSHT(**kw)
    zj = _spectral(jf(x))
    zt = tf(torch.from_numpy(x))
    assert zt.shape == zj.shape
    assert report(f"RealSHT[{kw['grid']}]", rel_l2(zt, zj)) <= 1e-5
    # synthesis of arbitrary coefficients, and the merged-layout helpers
    c = rng.standard_normal(zj.shape).astype(np.float32)
    cj = c[0] + 1j * c[1]
    assert report(f"InverseRealSHT[{kw['grid']}]", rel_l2(ti(torch.from_numpy(c)), ji(cj))) <= 1e-5
    assert rel_l2(ti.synthesis_hm(torch.from_numpy(c)), ji.synthesis_hm(cj)) <= 1e-5
    np.testing.assert_array_equal(ti.mode_power_weights, ji.mode_power_weights)
    f = rng.standard_normal((2, kw["nlat"], 2 * jf.mmax, 3)).astype(np.float32)
    assert rel_l2(tf.legendre_stacked(torch.from_numpy(f)),
                  _spectral(jf.legendre_stacked(f))) <= 1e-5


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("kw", GRIDS)
def test_bf16_synthesis_hm_keeps_fp32_output(kw):
    """The fused tail's hm on bf16 operands: JAX's one-pass bf16 matmul
    keeps an fp32 output (preferred_element_type).  XLA on the CPU runs it
    in full fp32, so the TPU's bf16 operand rounding is handed to JAX's
    function as its input (bf16-rounded coefficients and pct2).  An hm
    rounded to bf16 misses by ~1e-3."""
    sht = _jax_sht()
    rng = np.random.default_rng(3)
    ti = InverseRealSHT(**kw, mxu_dtype="bfloat16")
    ji = sht.InverseRealSHT(**kw, mxu_dtype="bfloat16")
    ji.__dict__["pct2"] = _bf16(ji.pct2)
    c = rng.standard_normal((2, 2, ti.lmax, ti.mmax, 5)).astype(np.float32)
    c16 = _bf16(c)
    hm = ti.synthesis_hm(torch.from_numpy(c))
    assert hm.dtype == torch.float32
    assert report(f"synthesis_hm bf16[{kw['grid']}]",
                  rel_l2(hm, ji.synthesis_hm(c16[0] + 1j * c16[1]))) <= 1e-6


def test_mxu_matmul_bf16_fp32_output():
    """bf16 operands, fp32 sums and an fp32 output, broadcast as matmul
    does: the fp64 product of the bf16-rounded operands within 1e-6."""
    from msfno_torch.runtime import mxu_matmul

    rng = np.random.default_rng(4)
    a = rng.standard_normal((6, 40, 33)).astype(np.float32)
    b = rng.standard_normal((3, 1, 33, 7)).astype(np.float32)
    want = np.matmul(_bf16(a).astype(np.float64), _bf16(b).astype(np.float64))
    y = mxu_matmul(torch.from_numpy(a), torch.from_numpy(b), "bfloat16")
    assert y.dtype == torch.float32 and y.shape == want.shape
    assert rel_l2(y, want) <= 1e-6
    assert mxu_matmul(torch.from_numpy(a), torch.from_numpy(b), "bfloat16",
                      out_dtype=None).dtype == torch.bfloat16


def test_round_trip_band_limited():
    kw = dict(nlat=16, nlon=32, grid="legendre-gauss", spectral_rescale=1e5)
    tf, ti = RealSHT(**kw), InverseRealSHT(**kw)
    rng = np.random.default_rng(1)
    c = torch.from_numpy(rng.standard_normal((2, 1, 16, 17, 2)).astype(np.float32))
    l_idx = torch.arange(16)[:, None]
    m_idx = torch.arange(17)[None, :]
    c = c * (l_idx >= m_idx)[None, None, :, :, None]  # triangular truncation
    c[1, :, :, 0] = 0.0  # real m = 0 column
    c[:, :, :, 16] = 0.0  # Nyquist
    c[:, :, 12:] = 0.0  # band limit below the grid's
    x = ti(c)
    assert report("SHT round trip", rel_l2(ti(tf(x)), x)) <= 1e-5


def test_bf16_knob_stays_near_fp32():
    # bf16 operands (and bf16 GEMM outputs): the one-pass precision class
    kw = dict(nlat=17, nlon=32, lmax=8, mmax=9, grid="equiangular")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 17, 32, 4)).astype(np.float32))
    z32 = RealSHT(**kw)(x)
    z16 = RealSHT(**kw, mxu_dtype="bfloat16")(x)
    assert 0.0 < report("RealSHT bf16 knob vs fp32", rel_l2(z16, z32)) <= 1e-2


@pytest.mark.parametrize("lon_dft", ["pallas", "fft"])
@pytest.mark.parametrize("kw", GRIDS)
def test_longitude_paths_match_jax(kw, lon_dft):
    """The dft_analysis / dft_synthesis kernels' path (plain versions here,
    JAX's Pallas kernels in interpret mode) and the rfft path."""
    sht = _jax_sht()
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, kw["nlat"], kw["nlon"], 3)).astype(np.float32)
    jf, ji = sht.RealSHT(**kw, lon_dft=lon_dft), sht.InverseRealSHT(**kw, lon_dft=lon_dft)
    tf, ti = RealSHT(**kw, lon_dft=lon_dft), InverseRealSHT(**kw, lon_dft=lon_dft)
    assert tf.dft_path == ti.dft_path == lon_dft
    zj = _spectral(jf(x))
    name = f"{lon_dft}[{kw['grid']}]"
    assert report(f"RealSHT {name}", rel_l2(tf(torch.from_numpy(x)), zj)) <= 1e-5
    c = rng.standard_normal(zj.shape).astype(np.float32)
    yt = ti(torch.from_numpy(c))
    assert report(f"InverseRealSHT {name}", rel_l2(yt, ji(c[0] + 1j * c[1]))) <= 1e-5


@pytest.mark.parametrize("lon_dft", ["pallas", "fft"])
def test_unported_longitude_paths_raise(lon_dft):
    """What the JAX package refuses on these paths, the port refuses too:
    synthesis_hm off the matmul path, and the forward with mmax past the
    nlon/2 + 1 frequencies (where "pallas" and "matmul" fall back to rfft)."""
    sht = _jax_sht()
    kw = dict(nlat=8, nlon=16, lon_dft=lon_dft)
    c = np.zeros((2, 1, 8, 9, 2), np.float32)
    with pytest.raises(ValueError):
        sht.InverseRealSHT(**kw).synthesis_hm(c[0] + 1j * c[1])
    with pytest.raises(ValueError, match="matmul"):
        InverseRealSHT(**kw).synthesis_hm(torch.from_numpy(c))
    x = np.zeros((1, 8, 16, 2), np.float32)
    with pytest.raises(Exception):
        sht.RealSHT(**kw, mmax=12)(x)
    big = RealSHT(**kw, mmax=12)
    assert big.dft_path == "fft"
    with pytest.raises(ValueError, match="mmax"):
        big(torch.from_numpy(x))
