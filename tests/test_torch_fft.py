"""Building blocks of the port's other spectral configurations against the
JAX package, fp32, rel-L2 <= 1e-5: the planar FFT pair (with the
reference's not-mutually-inverse zero padding), every ComplexReLU mode and
the generic complex activation on real pairs, and the complex contractions
(mode-shared, dense per mode, triangular, tensor-train)."""

import numpy as np
import pytest
import torch

from msfno_torch.ops import activations as tact
from msfno_torch.ops import contractions as tcon
from msfno_torch.ops.fft import InverseRealFFT2, RealFFT2

torch.set_num_threads(2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _pair(z) -> np.ndarray:
    z = np.asarray(z)
    return np.stack([z.real, z.imag])


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops import activations, contractions, fft

    return jnp, fft, activations, contractions


@pytest.mark.parametrize("nlat,nlon,lmax,mmax", [(16, 32, None, None), (16, 32, 8, 9),
                                                  (15, 30, 6, 7)])
def test_fft_pair_matches_jax(nlat, nlon, lmax, mmax):
    jnp, fft, _, _ = _jax()
    x = _x((2, nlat, nlon, 3), 0)
    jf, ji = fft.RealFFT2(nlat, nlon, lmax, mmax), fft.InverseRealFFT2(nlat, nlon, lmax, mmax)
    tf, ti = RealFFT2(nlat, nlon, lmax, mmax), InverseRealFFT2(nlat, nlon, lmax, mmax)
    zj = _pair(jf(jnp.asarray(x)))
    zt = tf(torch.from_numpy(x))
    assert zt.shape == zj.shape and (tf.lmax, tf.mmax) == (jf.lmax, jf.mmax)
    assert rel_l2(zt, zj) <= 1e-5
    # the inverse of the forward's own output: the padding quirk included
    yj = np.asarray(ji(jnp.asarray(zj[0] + 1j * zj[1])))
    yt = ti(zt, out_dtype=torch.float32)
    assert yt.shape == yj.shape == x.shape
    err = rel_l2(yt, yj)
    print(f"parity InverseRealFFT2[{nlat}x{nlon}, lmax={lmax}] rel_l2={err:.3e}")
    assert err <= 1e-5
    if lmax is not None:
        assert rel_l2(yt, x) > 1e-2  # truncated and re-placed: not an inverse


def test_fft_needs_even_lmax():
    with pytest.raises(ValueError, match="even"):
        RealFFT2(16, 32, lmax=7)


@pytest.mark.parametrize("mode", ["real", "cartesian", "modulus", "halfplane", "identity"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_complex_relu_matches_jax(mode, with_bias):
    jnp, _, act, _ = _jax()
    z = _x((2, 3, 5, 8), 1)
    bias = 0.3 * _x((8,), 2) if with_bias else None
    zj = jnp.asarray(z[0] + 1j * z[1])
    want = _pair(act.complex_relu(zj, mode=mode, negative_slope=0.1,
                                  bias=None if bias is None else jnp.asarray(bias)))
    got = tact.complex_relu(torch.from_numpy(z), mode, 0.1,
                            None if bias is None else torch.from_numpy(bias))
    assert rel_l2(got, want) <= 1e-5


@pytest.mark.parametrize("mode", ["cartesian", "modulus", "identity"])
def test_complex_activation_matches_jax(mode):
    jnp, _, act, _ = _jax()
    import jax

    z = _x((2, 4, 6), 3)
    bias = 0.2 * _x((6,), 4)
    want = _pair(act.complex_activation(jnp.asarray(z[0] + 1j * z[1]), jax.nn.gelu, mode,
                                        jnp.asarray(bias)))
    got = tact.complex_activation(torch.from_numpy(z),
                                  lambda v: torch.nn.functional.gelu(v, approximate="tanh"),
                                  mode, torch.from_numpy(bias))
    assert rel_l2(got, want) <= 1e-5


def _cw(shape, seed):
    """A complex weight in the JAX package's (..., 2) storage."""
    return 0.2 * _x(shape + (2,), seed)


@pytest.mark.parametrize("kind", ["compl_mul", "dense", "tril", "tt"])
def test_contractions_match_jax(kind):
    jnp, _, _, con = _jax()
    b, l, m, k, c, r = 2, 4, 5, 7, 6, 3
    cplx = lambda w: con.to_complex(jnp.asarray(w))  # noqa: E731
    if kind == "compl_mul":
        x, ws = _x((2, b, l, m, c), 5), [_cw((c, 8), 6)]
        want = con.compl_mul(jnp.asarray(x[0] + 1j * x[1]), cplx(ws[0]))
        got = tcon.compl_mul(torch.from_numpy(x), torch.from_numpy(ws[0]))
    elif kind == "dense":
        x, ws = _x((2, b, l, m, c), 7), [_cw((l, m, c, c), 8)]
        want = con.compl_contract_dense(jnp.asarray(x[0] + 1j * x[1]), cplx(ws[0]))
        got = tcon.compl_contract_dense(torch.from_numpy(x), torch.from_numpy(ws[0]))
    elif kind == "tril":
        x, ws = _x((2, b, k, c), 9), [_cw((k, c, c), 10)]
        want = con.compl_contract_tril(jnp.asarray(x[0] + 1j * x[1]), cplx(ws[0]))
        got = tcon.compl_contract_tril(torch.from_numpy(x), torch.from_numpy(ws[0]))
    else:
        x = _x((2, b, k, c), 11)
        ws = [_cw((c, r), 12), _cw((r, c, r), 13), _cw((r, k), 14)]
        want = con.contract_tt(jnp.asarray(x[0] + 1j * x[1]), *map(cplx, ws))
        got = tcon.contract_tt(torch.from_numpy(x), *map(torch.from_numpy, ws))
    assert rel_l2(got, _pair(want)) <= 1e-5
