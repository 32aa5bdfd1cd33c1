"""The SFNO family's other spectral configurations in the PyTorch port
against the JAX package: the planar FFT transform, the linear filter (dense
on the SHT and on the FFT, tensor-train on the SHT), the layer norm and the
non-"real" ComplexReLU modes, each as a small filmed net with JAX weights
carried by `from_flax_params` (fp32, rel-L2 <= 1e-4); the carried weights
against `export_sfno_state_dict`, key for key; and the kernel gates."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.convert import from_flax_params
from msfno_torch.models import FourierNeuralOperatorNetFilmed

torch.set_num_threads(2)

FILM = tcfg.FilmConfig(model_depth=1, embed_dim=16, num_film_features=16,
                       sst_shape=(8, 16), temporal_step=2, pallas_gcn=False)
# the spectral_mlp switch on (its plain version on the CPU); the grid-MLP
# kernels, which the JAX package runs in interpret mode here, off for time
BASE = tcfg.SFNOConfig(img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3,
                       embed_dim=16, num_layers=3, spectral_layers=2, rank=8, film=FILM,
                       use_pallas=True, grid_mlp_mxu_dtype="float32")
CONFIGS = {
    "fft": dict(spectral_transform="fft"),
    "linear_sht": dict(filter_type="linear"),
    "linear_tt": dict(filter_type="linear", compression="tt"),
    "linear_fft": dict(filter_type="linear", spectral_transform="fft"),
    "layer_norm": dict(normalization_layer="layer_norm"),
    "cartesian": dict(complex_activation="cartesian"),
    "modulus": dict(complex_activation="modulus"),
    "halfplane": dict(complex_activation="halfplane"),
}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def cfg_of(name):
    return dataclasses.replace(BASE, **CONFIGS[name])


def inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    h, w = cfg.img_size
    x = rng.standard_normal((2, h, w, cfg.in_chans)).astype(np.float32)
    hs, ws = cfg.film.sst_shape
    sst = rng.standard_normal((2, cfg.film.temporal_step, hs, ws)).astype(np.float32)
    return x, sst


def _random_params(shapes, rng):
    """Seeded numpy weights for a JAX parameter tree of `shapes`: 0.1 times
    a standard normal, norm scales 1 + 0.3 times one (so that the modulus
    mode's trained bias and the layer norm's per-pixel affine are not at
    their trivial inits).  Filling the tree from numpy skips the JAX
    initializers' compile, the bulk of a first `init` on the CPU."""
    out = {}
    for k, v in shapes.items():
        if isinstance(v, dict):
            out[k] = _random_params(v, rng)
        else:
            base, std = (1.0, 0.3) if k == "scale" else (0.0, 0.1)
            out[k] = (base + std * rng.standard_normal(v.shape)).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def jax_run(name):
    """(params as numpy, JAX output) of configuration `name`."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from msfno_tpu.models import FourierNeuralOperatorNetFilmed as JFilmed
    from msfno_tpu.utils import config as jcfg

    cfg = cfg_of(name)
    model = JFilmed(jcfg.from_json(tcfg.to_json(cfg)))
    x, sst = inputs(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(sst))["params"]
    params = _random_params(shapes, np.random.default_rng(1))
    y = model.apply({"params": params}, jnp.asarray(x), jnp.asarray(sst), 0.8)
    return params, np.asarray(y)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_config_matches_jax(name):
    params, yj = jax_run(name)
    cfg = cfg_of(name)
    net = FourierNeuralOperatorNetFilmed(cfg, device="cpu")
    net.load_state_dict(from_flax_params(params), strict=True)
    x, sst = inputs(cfg)
    with torch.no_grad():
        yt = net(torch.from_numpy(x), torch.from_numpy(sst), 0.8)
    assert yt.shape == yj.shape and torch.isfinite(yt).all()
    err = rel_l2(yt, yj)
    print(f"parity spectral config[{name}] rel_l2={err:.3e}")
    assert err <= 1e-4


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weight_carry_matches_export(name):
    pytest.importorskip("jax")
    from msfno_tpu.models.convert import export_sfno_state_dict

    params, _ = jax_run(name)
    ours, theirs = from_flax_params(params), export_sfno_state_dict(params)
    # the GCN generator's layers are this package's own
    assert set(theirs) <= set(ours)
    assert all(k.startswith("film_gen.film_gen.conv") for k in set(ours) - set(theirs))
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_gates_are_the_jax_gates(name):
    """With every kernel switch on: the fused head and tail and the norm fold
    only on the non-linear SHT with instance norm (any ComplexReLU mode), the
    spectral_mlp kernel only on the non-linear SHT with the "real"
    activation."""
    cfg = dataclasses.replace(cfg_of(name), pallas_grid_mlp=True)
    net = FourierNeuralOperatorNetFilmed(cfg, device="cpu")
    sht_mlp = cfg.filter_type == "non-linear" and cfg.spectral_transform == "sht"
    fold = sht_mlp and cfg.normalization_layer == "instance_norm"
    assert net.fuse_dft == net.blocks[-1].fuse_tail == net.want_stats == fold
    for blk in net.blocks:
        assert blk.fuse_norm == fold
        want = sht_mlp and cfg.complex_activation == "real"
        assert getattr(blk.filter_layer.filter, "use_kernel", False) == want


@pytest.mark.parametrize("mode", ["cartesian", "modulus", "halfplane"])
def test_fused_head_and_tail_with_other_activations(mode):
    """The fused head and tail engage with every ComplexReLU mode (the JAX
    gates do not look at it): the fused net against the unfused one with the
    same weights, which reorder fp32 sums (1e-3, as for the "real" mode in
    tests/test_torch_model.py)."""
    cfg = dataclasses.replace(cfg_of(mode), pallas_grid_mlp=True)
    fused = FourierNeuralOperatorNetFilmed(cfg, device="cpu", seed=3)
    unfused = FourierNeuralOperatorNetFilmed(
        dataclasses.replace(cfg, fuse_encoder_dft=False, fuse_decoder_tail=False), device="cpu")
    with torch.no_grad():
        for name, p in fused.named_parameters():
            if name.endswith("activation.bias"):
                p.normal_(0.0, 0.3, generator=torch.Generator().manual_seed(4))
    unfused.load_state_dict(fused.state_dict())
    assert fused.fuse_dft and fused.blocks[-1].fuse_tail and not unfused.fuse_dft
    x, sst = inputs(cfg, seed=2)
    with torch.no_grad():
        args = (torch.from_numpy(x), torch.from_numpy(sst), 0.7)
        yf, yu = fused(*args), unfused(*args)
    err = rel_l2(yf, yu)
    print(f"parity fused vs unfused port net[{mode}] rel_l2={err:.3e}")
    assert err <= 1e-3
