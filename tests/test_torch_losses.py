"""The port's training losses against the JAX package's: every `get_loss`
entry, value and gradient, on the same numpy inputs (the spectral family
also with its SHT truncated to a model's modes, and its options)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfno_torch.training import losses as tl
from msfno_tpu.training import losses as jl

torch.set_num_threads(2)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _inputs(seed=0, shape=(2, 12, 24, 3)):
    rng = np.random.default_rng(seed)
    tar = rng.standard_normal(shape).astype(np.float32)
    prd = (tar + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    return prd, tar


@pytest.mark.parametrize("name", sorted(tl.LOSSES))
def test_loss_and_gradient_match_jax(name):
    prd, tar = _inputs()
    fj = jl.get_loss(name)
    vj, gj = jax.value_and_grad(lambda p: fj(p, jnp.asarray(tar)))(jnp.asarray(prd))
    p = torch.from_numpy(prd).requires_grad_(True)
    vt = tl.get_loss(name)(p, torch.from_numpy(tar))
    vt.backward()
    assert abs(vt.item() - float(vj)) <= 1e-6 * abs(float(vj))
    err = rel(p.grad, gj)
    print(f"parity loss {name} grad rel_l2={err:.3e}")
    assert err <= 1e-6


@pytest.mark.parametrize("kw", [dict(relative=False, squared=True),
                                dict(relative=True, squared=False),
                                dict(reduction="none")])
@pytest.mark.parametrize("fn", ["l2_sphere", "l2_sphere_nosine"])
def test_l2_sphere_options_match_jax(fn, kw):
    prd, tar = _inputs(seed=1)
    vj = getattr(jl, fn)(jnp.asarray(prd), jnp.asarray(tar), **kw)
    vt = getattr(tl, fn)(torch.from_numpy(prd), torch.from_numpy(tar), **kw)
    assert rel(vt, vj) <= 1e-6


def test_default_is_relative_squared():
    prd, tar = _inputs(seed=2)
    p, t = torch.from_numpy(prd), torch.from_numpy(tar)
    want = tl.l2_sphere_nosine(p, t, relative=True, squared=True)
    assert float(tl.get_loss("L2Sphere_noSine")(p, t)) == float(want)


SPECTRAL = ("SpectralL2Sphere", "SpectralSphere", "H1Sphere")


@pytest.mark.parametrize("name", SPECTRAL)
def test_spectral_losses_truncated_to_the_model_match_jax(name):
    """`get_loss(name, model_cfg)`: the loss SHT at the model's modes_lat /
    modes_lon (12x24 grid, scale 2: lmax 6, mmax 7)."""
    from msfno_torch.config import SFNOConfig
    from msfno_tpu.utils.config import SFNOConfig as JConfig

    kw = dict(img_size=(12, 24), scale_factor=2)
    prd, tar = _inputs(seed=3)
    fj = jl.get_loss(name, JConfig(**kw))
    vj, gj = jax.value_and_grad(lambda p: fj(p, jnp.asarray(tar)))(jnp.asarray(prd))
    p = torch.from_numpy(prd).requires_grad_(True)
    vt = tl.get_loss(name, SFNOConfig(**kw))(p, torch.from_numpy(tar))
    vt.backward()
    assert tl._loss_sht(12, 24, 6, 7).lmax == 6
    assert abs(vt.item() - float(vj)) <= 1e-6 * abs(float(vj))
    err = rel(p.grad, gj)
    print(f"parity loss {name} (truncated) grad rel_l2={err:.3e}")
    assert err <= 1e-6


@pytest.mark.parametrize("kw", [dict(relative=True, squared=True),
                                dict(relative=True, squared=False),
                                dict(relative=False, squared=False)])
@pytest.mark.parametrize("fn", ["spectral_l2loss_sphere", "spectral_loss_sphere"])
def test_spectral_loss_options_match_jax(fn, kw):
    from msfno_tpu.ops.sht import RealSHT as JSHT

    prd, tar = _inputs(seed=4)
    sht_kw = dict(lmax=8, mmax=9, grid="equiangular")
    vj = getattr(jl, fn)(JSHT(12, 24, **sht_kw), jnp.asarray(prd), jnp.asarray(tar), **kw)
    vt = getattr(tl, fn)(tl.RealSHT(12, 24, **sht_kw), torch.from_numpy(prd),
                         torch.from_numpy(tar), **kw)
    assert rel(vt, vj) <= 1e-6


def test_h1_loss_unsquared_matches_jax():
    from msfno_tpu.ops.sht import RealSHT as JSHT

    prd, tar = _inputs(seed=5)
    vj = jl.h1loss_sphere(JSHT(12, 24, grid="equiangular"), jnp.asarray(prd),
                          jnp.asarray(tar), squared=False)
    vt = tl.h1loss_sphere(tl.RealSHT(12, 24, grid="equiangular"), torch.from_numpy(prd),
                          torch.from_numpy(tar), squared=False)
    assert rel(vt, vj) <= 1e-6


def test_unknown_loss_raises():
    with pytest.raises(ValueError):
        tl.get_loss("nope")
