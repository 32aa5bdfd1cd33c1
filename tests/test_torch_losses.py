"""The port's training losses against the JAX package's: every ported
`get_loss` entry, value and gradient, on the same numpy inputs."""

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


def test_unported_losses_raise():
    for name in ("SpectralL2Sphere", "SpectralSphere", "H1Sphere"):
        with pytest.raises(NotImplementedError, match="later slice"):
            tl.get_loss(name)
    with pytest.raises(ValueError):
        tl.get_loss("nope")
