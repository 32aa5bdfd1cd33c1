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


# the four library losses that get_loss does not reach (JAX losses.py:150-254):
# name -> its call on the (jax or torch) losses module and the inputs; each
# value and its gradient held to JAX at 1e-6 rel-L2 (fp32 against fp32)
def _dist_inputs(seed=5, shape=(2, 6, 8, 3)):
    rng = np.random.default_rng(seed)
    mu = rng.standard_normal(shape).astype(np.float32)
    sigma = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    obs = (mu + rng.standard_normal(shape)).astype(np.float32)
    mask = (rng.random(shape) > 0.3).astype(np.float32)
    ens = (obs[..., None] + 0.5 * rng.standard_normal(shape + (4,))).astype(np.float32)
    w = np.abs(rng.standard_normal(shape[1])).astype(np.float32)
    inp = (obs + 0.7 * rng.standard_normal(shape)).astype(np.float32)
    return dict(mu=mu, sigma=sigma, obs=obs, mask=mask, ens=ens, w=w, inp=inp)


NEW_LOSSES = {
    "fluct_l2loss_sphere": lambda m, d: m.fluct_l2loss_sphere(d["w"], d["mu"], d["obs"], d["inp"]),
    "fluct_l2loss_sphere/relative": lambda m, d: m.fluct_l2loss_sphere(
        d["w"], d["mu"], d["obs"], d["inp"], relative=True),
    "normal_crps": lambda m, d: m.normal_crps(d["mu"], d["sigma"], d["obs"]),
    "normal_crps/mask/exp": lambda m, d: m.normal_crps(
        d["mu"], d["sigma"], d["obs"], mask=d["mask"], sigma_transform="exp"),
    "normal_crps/sum": lambda m, d: m.normal_crps(d["mu"], d["sigma"], d["obs"],
                                                  reduction="sum"),
    "beta_nll": lambda m, d: m.beta_nll(d["mu"], d["sigma"], d["obs"]),
    "beta_nll/beta0/exp/sum": lambda m, d: m.beta_nll(
        d["mu"], d["sigma"], d["obs"], beta=0.0, sigma_transform="exp", reduction="sum"),
    "statistical_loss": lambda m, d: m.statistical_loss(d["ens"], d["obs"]),
    "statistical_loss/corrected": lambda m, d: m.statistical_loss(d["ens"], d["obs"],
                                                                  corrected=True),
}


@pytest.mark.parametrize("name", sorted(NEW_LOSSES))
def test_library_loss_and_gradient_match_jax(name):
    """Value and the gradient in the prediction (mu, or the ensemble) against
    JAX at 1e-6 rel-L2."""
    d = _dist_inputs()
    key = "ens" if name.startswith("statistical") else "mu"
    call = NEW_LOSSES[name]

    def jfn(x):
        return call(jl, {**{k: jnp.asarray(v) for k, v in d.items()}, key: x})

    vj, gj = jax.value_and_grad(jfn)(jnp.asarray(d[key]))
    x = torch.from_numpy(d[key]).requires_grad_(True)
    vt = call(tl, {**{k: torch.from_numpy(v) for k, v in d.items()}, key: x})
    vt.backward()
    assert abs(vt.item() - float(vj)) <= 1e-6 * abs(float(vj))
    err = rel(x.grad, gj)
    print(f"parity loss {name} grad rel_l2={err:.3e}")
    assert err <= 1e-6


def test_normal_crps_none_reduction_matches_jax():
    d = _dist_inputs(seed=6)
    vj = jl.normal_crps(jnp.asarray(d["mu"]), jnp.asarray(d["sigma"]), jnp.asarray(d["obs"]),
                        reduction="none")
    vt = tl.normal_crps(torch.from_numpy(d["mu"]), torch.from_numpy(d["sigma"]),
                        torch.from_numpy(d["obs"]), reduction="none")
    assert vt.shape == vj.shape and rel(vt, vj) <= 1e-6


def test_library_losses_stay_out_of_get_loss():
    """As in JAX, get_loss does not reach the four library losses."""
    for name in ("fluct_l2loss_sphere", "normal_crps", "beta_nll", "statistical_loss"):
        assert name not in tl.LOSSES and name not in jl.LOSSES
        with pytest.raises(ValueError):
            tl.get_loss(name)
