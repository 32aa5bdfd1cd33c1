"""The serving entry point of the PyTorch port (msfno_torch.models.registry):
a checkpoint written by the JAX package loads into the port and serves the
same step and the same forecast (`running`, with statistics from an assets
directory) as the JAX wrapper; a reference PyTorch checkpoint loads; the
MAE and FourCastNet families build; the paths not ported yet raise."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.models import registry
from test_torch_model import FUSED_FP32, inputs, rel_l2, report

torch.set_num_threads(2)

FILM_SCALE = 0.37


def _jax_wrapper(tmp_path):
    """The JAX filmed wrapper over FUSED_FP32, with seeded params and
    statistics in an assets directory, and its checkpoint (.npz) carrying a
    trained film_scale."""
    pytest.importorskip("jax")
    from msfno_tpu.models.registry import get_model as jax_get_model
    from msfno_tpu.training import checkpoint as ckpt_io
    from msfno_tpu.utils import config as jcfg

    rng = np.random.default_rng(11)
    c = FUSED_FP32.in_chans
    np.save(tmp_path / "global_means.npy", rng.standard_normal((1, c, 1, 1)).astype(np.float32))
    np.save(tmp_path / "global_stds.npy",
            (1.0 + rng.random((1, c, 1, 1))).astype(np.float32))
    cfg_j = jcfg.from_json(tcfg.to_json(FUSED_FP32))
    wrapper = jax_get_model("sfno", "film", cfg=cfg_j, assets=str(tmp_path))
    wrapper.init_params()
    path = str(tmp_path / "checkpoint.npz")
    ckpt_io.save_checkpoint(path, wrapper.params, config_json=jcfg.to_json(cfg_j),
                            extra={"film_scale": FILM_SCALE})
    wrapper.load_model(path)
    return wrapper, path


def test_jax_checkpoint_serves_the_same_step(tmp_path):
    import jax.numpy as jnp

    jw, path = _jax_wrapper(tmp_path)
    tw = registry.get_model("sfno", "film", cfg=FUSED_FP32, device="cpu", seed=5)
    tw.load_model(path)
    assert tw.film_scale == jw.film_scale == pytest.approx(FILM_SCALE)
    x, sst = inputs(FUSED_FP32)
    yj = np.asarray(jw.module.apply({"params": jw.params}, jnp.asarray(x), jnp.asarray(sst),
                                    jw.film_scale))
    with torch.no_grad():
        yt = tw.module(torch.from_numpy(x), torch.from_numpy(sst), tw.film_scale)
    assert report("registry step from a JAX .npz", rel_l2(yt, yj)) <= 1e-4


def test_running_matches_jax_wrapper(tmp_path):
    jw, path = _jax_wrapper(tmp_path)
    tw = registry.get_model("sfno", "film", cfg=FUSED_FP32, assets=str(tmp_path),
                            device="cpu")
    tw.load_model(path)
    np.testing.assert_array_equal(tw.normalizer.means, np.asarray(jw.normalizer.means))
    x0, sst = inputs(FUSED_FP32)
    rng = np.random.default_rng(12)
    sst_seq = sst[None] + 0.1 * rng.standard_normal((3,) + sst.shape).astype(np.float32)
    outs_j = list(jw.running(x0, lead_time_h=18, sst_seq=sst_seq))
    outs_t = list(tw.running(x0, lead_time_h=18, sst_seq=sst_seq))
    assert len(outs_t) == len(outs_j) == 3
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        assert a.dtype == np.float32 and a.shape == np.asarray(b).shape
        assert report(f"registry running step {i + 1}", rel_l2(a, b)) <= 1e-4


def test_reference_torch_checkpoint_loads(tmp_path):
    src = registry.get_model("sfno", "film", cfg=FUSED_FP32, device="cpu", seed=1)
    # the reference trainer's layout: DDP prefixes, the dead top-level norm
    # and the state dict nested under "model_state"
    state = {f"module.{k}": v for k, v in src.module.state_dict().items()}
    state["module.norm.weight"] = torch.ones(3)
    path = tmp_path / "weights.tar"
    torch.save({"model_state": state, "iters": 7}, path)
    dst = registry.get_model("sfno", "film", cfg=FUSED_FP32, device="cpu", seed=2)
    dst.load_model(str(path))
    for k, v in src.module.state_dict().items():
        torch.testing.assert_close(dst.module.state_dict()[k], v, rtol=0, atol=0)


# the lat and channel mesh axes are not ported (a data-only mesh is)
LAT_MESH = types.SimpleNamespace(mesh_dim_names=("data", "lat", "channel"), shape=(1, 2, 1))


@pytest.mark.parametrize("call", [
    lambda tmp: registry.get_model("sfno", cfg=dataclasses.replace(FUSED_FP32, film=None),
                                   device="cpu").trainer(tcfg.TrainConfig(), mesh=LAT_MESH),
    lambda tmp: registry.get_model("sfno", "film", cfg=FUSED_FP32,
                                   device="cpu").load_model(str(tmp)),
])
def test_unported_entry_points_raise(call, tmp_path):
    with pytest.raises(NotImplementedError):
        call(tmp_path)


_FILM_SMALL = tcfg.FilmConfig(film_gen_type="mae", embed_dim=16, mlp_dim=16, sst_shape=(8, 16),
                              temporal_step=2, patch_size=(2, 4, 4))
_FCN_SMALL = dict(img_size=(16, 32), scale_factor=4, embed_dim=16, num_layers=1)


@pytest.mark.parametrize("model_type,version,kind", [
    ("mae", "latest", "MAEWrapper"), ("mae", "lin-probe", "LinProbeWrapper"),
    ("fcn", "0", "FCNWrapper"), ("fcn", "1", "FCNWrapper"),
])
def test_mae_and_fcn_entry_points_build(model_type, version, kind):
    """The MAE and FourCastNet families build on device="cpu" (at small
    sizes; held against JAX in tests/test_torch_{mae,afno}.py) and, with
    no card, refuse to run anywhere else."""
    from msfno_torch.models.registry_fcn import fcn_config

    if model_type == "fcn":
        cfg = dataclasses.replace(fcn_config(20 if version == "0" else 26), **_FCN_SMALL)
    else:
        cfg = dataclasses.replace(FUSED_FP32, film=_FILM_SMALL)
    w = registry.get_model(model_type, version, cfg=cfg, device="cpu")
    assert type(w).__name__ == kind
    assert all(p.device.type == "cpu" for p in w.module.parameters())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            registry.get_model(model_type, version, cfg=cfg)
