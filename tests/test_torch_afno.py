"""FourCastNet (AFNO) of the PyTorch port (msfno_torch/models/afno/
afnonet.py, models/registry_fcn.py) against the JAX package's: AFNO2D at
hard_thresholding_fraction 1 and 0.5, AFNONet and PrecipNet forward (1e-5)
and their input gradients (1e-4), unlog_tp, `from_flax_afno_params`
composed with JAX's `convert_afno_state_dict` (exactly equal, both ways),
the four version names of `get_model("fcn", ...)` with their orderings, a
reference-layout checkpoint, a JAX `.npz` and `running`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfno_torch.config import SFNOConfig
from msfno_torch.convert import from_flax_afno_params
from msfno_torch.models import registry
from msfno_torch.models.afno import AFNO2D, AFNONet, PrecipNet, unlog_tp
from msfno_torch.models.registry_fcn import FCN0_ORDERING, FCN1_ORDERING, fcn_config
from msfno_tpu.models import afno as jafno
from msfno_tpu.models.convert import convert_afno_state_dict
from test_torch_model import rel_l2, report

torch.set_num_threads(2)

# a 16 x 32 grid of 4 x 4 patches (4 x 8 tokens), embed 16 in 4 blocks, depth 2
SMALL = dict(img_size=(16, 32), patch_size=(4, 4), in_chans=3, out_chans=3, embed_dim=16,
             depth=2, num_blocks=4)
TOL, GRAD_TOL = 1e-5, 1e-4


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_afnonet(seed=0, **kw):
    net = jafno.AFNONet(**{**SMALL, **kw})
    x = _x((2, 16, 32, SMALL["in_chans"]), seed)
    params = _np(jax.jit(net.init)(jax.random.PRNGKey(seed), jnp.asarray(x))["params"])
    return net, params, x


def _torch_afnonet(params, **kw):
    net = AFNONet(**{**SMALL, **kw}, device="cpu")
    net.load_state_dict(from_flax_afno_params(params, SMALL["patch_size"]), strict=True)
    return net


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_afno2d_matches_jax(fraction):
    """The kept mode region, rows [total - kept, total + kept) clamped at h
    and columns [0, kept), on an 8 x 12 grid (total 5: at 1.0 rows 0-8 of
    8, at 0.5 rows 3-7) and an odd 7 x 10 one."""
    for shape in ((2, 8, 12, 16), (1, 7, 10, 16)):
        m = jafno.AFNO2D(hidden_size=16, num_blocks=4, hard_thresholding_fraction=fraction)
        x = _x(shape, 1)
        params = _np(m.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"])
        # b1 / b2 at scale 1, so that the soft shrink acts on part of the modes
        params = {k: v * (50.0 if k.startswith("b") else 1.0) for k, v in params.items()}
        yj = np.asarray(m.apply({"params": params}, jnp.asarray(x)))
        t = AFNO2D(16, 4, hard_thresholding_fraction=fraction, device="cpu")
        t.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()}, strict=True)
        with torch.no_grad():
            yt = t(torch.from_numpy(x))
        assert yt.dtype == torch.float32
        assert report(f"afno2d[{fraction}, {shape[1:3]}] vs jax", rel_l2(yt, yj)) <= TOL
        with torch.no_grad():  # bf16 in, bf16 out; the mixing in fp32
            assert t(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def test_afnonet_forward_and_input_gradient_match_jax():
    net, params, x = _jax_afnonet()
    yj = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(x)))
    gj = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(net.apply({"params": params}, v) ** 2)))(
        jnp.asarray(x)))
    t = _torch_afnonet(params)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = t(xt)
    (yt ** 2).sum().backward()
    assert yt.shape == x.shape[:3] + (SMALL["out_chans"],)
    assert report("afnonet vs jax", rel_l2(yt.detach(), yj)) <= TOL
    assert report("afnonet input grad vs jax", rel_l2(xt.grad, gj)) <= GRAD_TOL


def test_precipnet_matches_jax():
    backbone = jafno.AFNONet(**{**SMALL, "out_chans": 1})
    net = jafno.PrecipNet(backbone)
    x = _x((2, 16, 32, SMALL["in_chans"]), 3)
    params = _np(jax.jit(net.init)(jax.random.PRNGKey(4), jnp.asarray(x))["params"])
    yj = np.asarray(jax.jit(net.apply)({"params": params}, jnp.asarray(x)))
    gj = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(net.apply({"params": params}, v))))(
        jnp.asarray(x)))
    t = PrecipNet(AFNONet(**{**SMALL, "out_chans": 1}, device="cpu"))
    t.load_state_dict(from_flax_afno_params(params, SMALL["patch_size"]), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = t(xt)
    yt.sum().backward()
    assert (yt >= 0).all() and (yt > 0).any()
    assert report("precipnet vs jax", rel_l2(yt.detach(), yj)) <= TOL
    assert report("precipnet input grad vs jax", rel_l2(xt.grad, gj)) <= GRAD_TOL


def test_unlog_tp_matches_jax():
    x = _x((4, 5), 5)
    np.testing.assert_allclose(unlog_tp(torch.from_numpy(x)).numpy(),
                               np.asarray(jafno.unlog_tp(jnp.asarray(x))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("precip", [False, True])
def test_conversion_inverts_convert_afno_state_dict(precip):
    """flax -> reference names (the port) -> flax (the JAX package) gives
    the tree back, and reference -> flax -> reference the state dict back,
    bit for bit."""
    if precip:
        net = jafno.PrecipNet(jafno.AFNONet(**{**SMALL, "out_chans": 1}))
        params = _np(jax.jit(net.init)(jax.random.PRNGKey(0),
                                       jnp.zeros((1, 16, 32, SMALL["in_chans"])))["params"])
    else:
        params = _jax_afnonet()[1]
    state = from_flax_afno_params(params, SMALL["patch_size"])
    back = convert_afno_state_dict({k: v.numpy() for k, v in state.items()},
                                   img_size=SMALL["img_size"], patch_size=SMALL["patch_size"])
    assert back["unconverted"] == []
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(params), flat(back["params"])
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), a[k], err_msg=str(k))
    again = from_flax_afno_params(back["params"], SMALL["patch_size"])
    assert set(again) == set(state)
    assert all(torch.equal(again[k], v) for k, v in state.items())
    if not precip:  # the reference's shapes
        assert state["patch_embed.proj.weight"].shape == (16, 3, 4, 4)
        assert state["pos_embed"].shape == (1, 32, 16)
        assert state["head.weight"].shape == (3 * 16, 16)
        assert state["blocks.1.filter.w1"].shape == (2, 4, 4, 4)


@pytest.mark.parametrize("version,channels,ordering", [
    ("0", 20, FCN0_ORDERING), ("release", 20, FCN0_ORDERING),
    ("1", 26, FCN1_ORDERING), ("latest", 26, FCN1_ORDERING),
])
def test_get_model_versions(version, channels, ordering):
    """Each version name builds its wrapper and ordering, as the JAX
    registry does (at a small grid: the full 720 x 1440 net runs on the
    card, `chip_smoke.py`)."""
    from msfno_tpu.models.registry import get_model as jax_get_model

    jw = jax_get_model("fcn", version)
    assert jw.ordering == ordering and jw.cfg.in_chans == channels
    assert fcn_config(channels) == SFNOConfig(
        img_size=(720, 1440), scale_factor=8, in_chans=channels, out_chans=channels,
        embed_dim=768, num_layers=12, spectral_transform="fft", film=None)
    cfg = dataclasses.replace(fcn_config(channels), img_size=(16, 32), scale_factor=4,
                              embed_dim=16, num_layers=1)
    w = registry.get_model("fcn", version, cfg=cfg, device="cpu")
    assert w.ordering == ordering and len(ordering) == channels
    assert isinstance(w.module, AFNONet)
    assert w.module.patch_embed.proj.weight.shape == (16, channels, 4, 4)


def _small_wrapper(seed):
    cfg = dataclasses.replace(fcn_config(3), img_size=(16, 32), scale_factor=4, embed_dim=16,
                              num_layers=2)
    return cfg, registry.get_model("fcn", "1", cfg=cfg, device="cpu", seed=seed)


def test_checkpoints_load_and_running_matches_jax(tmp_path):
    """A JAX `.npz` of the wrapper's net serves JAX's `running`; a
    reference checkpoint (DDP prefixes, the dead final norm, under
    "model_state") and the port's `.pt` load bit for bit."""
    from msfno_tpu.models.registry import get_model as jax_get_model
    from msfno_tpu.training import checkpoint as jckpt
    from msfno_tpu.utils import config as jcfg

    from msfno_torch.config import to_json

    cfg, tw = _small_wrapper(1)
    jw = jax_get_model("fcn", "1", cfg=jcfg.from_json(to_json(cfg)))
    jw.init_params(jax.random.PRNGKey(3))
    npz = str(tmp_path / "fcn.npz")
    jckpt.save_checkpoint(npz, jw.params, config_json=jcfg.to_json(jw.cfg))
    tw.load_model(npz)
    x0 = _x((1, 16, 32, 3), 6)
    outs_j = list(jw.running(x0, lead_time_h=12))
    outs_t = list(tw.running(x0, lead_time_h=12))
    assert len(outs_t) == len(outs_j) == 2
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        assert a.dtype == np.float32 and a.shape == x0.shape
        assert report(f"fcn running step {i + 1} vs jax", rel_l2(a, b)) <= TOL

    state = {f"module.{k}": v for k, v in tw.module.state_dict().items()}
    state["module.norm.weight"], state["module.norm.bias"] = torch.ones(16), torch.zeros(16)
    tar = tmp_path / "weights.tar"
    torch.save({"model_state": state, "iters": 3}, tar)
    pt = tw.save_checkpoint(str(tmp_path / "fcn.pt"))
    for path in (str(tar), pt):
        other = _small_wrapper(2)[1]
        other.load_model(path)
        for k, v in tw.module.state_dict().items():
            assert torch.equal(other.module.state_dict()[k], v), (path, k)


def test_dropout_draws_from_the_generator():
    _, params, x = _jax_afnonet()
    t = _torch_afnonet(params, drop_rate=0.2)
    plain = _torch_afnonet(params)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        a, b = t(xt), plain(xt)
        c = t(xt, rng=torch.Generator().manual_seed(0))
        d = t(xt, rng=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)
