"""The slice as a whole: the PyTorch port's filmed SFNO against the JAX
package's at a small config, with the JAX Pallas kernels in interpret mode
and the port's kernel wrappers on their plain versions (CPU), weights carried
with `from_flax_params`; unfused (BASE) and with the fused head and tail
(FUSED).  On a card, the kernel path against the plain path."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.convert import from_flax_params
from msfno_torch.data.synthetic import synthetic_land_mask
from msfno_torch.models import FourierNeuralOperatorNet, FourierNeuralOperatorNetFilmed
from msfno_torch.ops.kernels import launch_counts, reset_launch_counts

torch.set_num_threads(2)

FILM = tcfg.FilmConfig(model_depth=2, embed_dim=32, mlp_dim=32, num_film_features=32,
                       sst_shape=(16, 32), temporal_step=4)
BASE = tcfg.SFNOConfig(img_size=(32, 64), scale_factor=2, in_chans=4, out_chans=4,
                       embed_dim=32, num_layers=3, spectral_layers=2, film=FILM,
                       use_pallas=True, pallas_grid_mlp=True,
                       fuse_encoder_dft=False, fuse_decoder_tail=False)
# every knob fp32, the three kernels' plain versions on
FP32 = dataclasses.replace(BASE, grid_mlp_mxu_dtype="float32")
# the serving tier's knobs at the small size
SERVING = dataclasses.replace(
    BASE, compute_dtype="bfloat16", spectral_mxu_dtype="bfloat16",
    sht_mxu_dtype="bfloat16", film=dataclasses.replace(FILM, compute_dtype="bfloat16"),
)
# the same with the fused head and tail: all five kernels' plain versions
FUSED = dict(fuse_encoder_dft=True, fuse_decoder_tail=True)
FUSED_FP32 = dataclasses.replace(FP32, **FUSED)
FUSED_SERVING = dataclasses.replace(SERVING, **FUSED)
# a serving step launches none of the backward kernels, and no net runs the
# lon_dft="pallas" DFT kernels
NO_BACKWARD = {"gcn_layer_bwd": 0, "spectral_decoder_bwd": 0, "spectral_mlp_bwd": 0,
               "dft_analysis": 0, "dft_synthesis": 0}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def report(name, value):
    """The measured error, for the parity table (pytest -s shows it)."""
    print(f"parity {name} rel_l2={value:.3e}")
    return value


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def inputs(cfg, seed=0, batch=1):
    rng = np.random.default_rng(seed)
    h, w = cfg.img_size
    x = rng.standard_normal((batch, h, w, cfg.in_chans)).astype(np.float32)
    if cfg.film is None:
        return x, None
    hs, ws = cfg.film.sst_shape
    sst = rng.standard_normal((batch, cfg.film.temporal_step, hs, ws)).astype(np.float32)
    sst[..., synthetic_land_mask(hs, ws)] = np.nan
    return x, sst


def jax_net(cfg_t, filmed=True):
    """The JAX net of the same JSON config and its params (numpy)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from msfno_tpu.models import FourierNeuralOperatorNet as JNet
    from msfno_tpu.models import FourierNeuralOperatorNetFilmed as JFilmed
    from msfno_tpu.utils import config as jcfg

    cfg_j = jcfg.from_json(tcfg.to_json(cfg_t))
    model = (JFilmed if filmed else JNet)(cfg_j)
    x, sst = inputs(cfg_t)
    args = (jnp.asarray(x), jnp.asarray(sst)) if filmed else (jnp.asarray(x),)
    params = model.init(jax.random.PRNGKey(0), *args)["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def torch_net(cfg, params, filmed=True, device="cpu"):
    net = (FourierNeuralOperatorNetFilmed if filmed else FourierNeuralOperatorNet)(
        cfg, device=device)
    net.load_state_dict(from_flax_params(params), strict=True)
    return net


@pytest.mark.parametrize("name,cfg,tol", [
    ("fp32", FP32, 1e-4),
    # JAX's "bfloat16" SHT knob is true fp32 on the CPU, the port rounds its
    # operands: the bf16 class of the JAX fast-vs-exact drift (1.73e-2)
    ("serving", SERVING, 3e-2),
    ("fused fp32", FUSED_FP32, 1e-4),
    ("fused serving", FUSED_SERVING, 3e-2),
])
def test_filmed_net_matches_jax(name, cfg, tol):
    import jax.numpy as jnp

    model, params = jax_net(cfg)
    x, sst = inputs(cfg)
    yj = np.asarray(model.apply({"params": params}, jnp.asarray(x), jnp.asarray(sst), 0.8))
    net = torch_net(cfg, params)
    with torch.no_grad():
        yt = net(torch.from_numpy(x), torch.from_numpy(sst), 0.8)
    assert yt.shape == yj.shape and yt.dtype == torch.float32
    assert report(f"filmed net[{name}]", rel_l2(yt, yj)) <= tol


def test_plain_net_matches_jax():
    import jax.numpy as jnp

    cfg = dataclasses.replace(BASE, use_pallas=False, pallas_grid_mlp=False, film=None)
    model, params = jax_net(cfg, filmed=False)
    x, _ = inputs(FP32)
    yj = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        yt = torch_net(cfg, params, filmed=False)(torch.from_numpy(x))
    assert report("plain net[fp32, no kernels]", rel_l2(yt, yj)) <= 1e-4


@pytest.mark.parametrize("filmed", [True, False])
def test_fused_net_matches_unfused_net(filmed):
    # the fused head and tail reorder the fp32 sums of the unfused path (the
    # JAX package holds its own pair to 1e-3, tests/test_encoder_spectral.py)
    cfg = FUSED_FP32 if filmed else dataclasses.replace(FUSED_FP32, film=None)
    x, sst = inputs(FP32)
    fused = (FourierNeuralOperatorNetFilmed if filmed else FourierNeuralOperatorNet)(
        cfg, device="cpu", seed=4)
    unfused = type(fused)(dataclasses.replace(cfg, fuse_encoder_dft=False,
                                              fuse_decoder_tail=False), device="cpu")
    unfused.load_state_dict(fused.state_dict())
    assert fused.fuse_dft and fused.blocks[-1].fuse_tail and not unfused.fuse_dft
    args = (torch.from_numpy(x),) + ((torch.from_numpy(sst), 0.7) if filmed else ())
    with torch.no_grad():
        yf, yu = fused(*args), unfused(*args)
    assert report(f"fused vs unfused port net[filmed={filmed}]", rel_l2(yf, yu)) <= 1e-3


def test_backbone_mapping_matches_export():
    pytest.importorskip("jax")
    from msfno_tpu.models.convert import export_sfno_state_dict

    _, params = jax_net(FP32)
    ours = from_flax_params(params)
    theirs = export_sfno_state_dict(params)
    # the export also names the film head (its ViT layout is the same); the
    # GCN layers are this package's own
    assert set(theirs) <= set(ours)
    assert all(k.startswith("film_gen.film_gen.conv") for k in set(ours) - set(theirs))
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)


@pytest.mark.cuda
def test_kernel_path_matches_plain_path(cuda):
    from msfno_torch.config import exact_config

    x, sst = inputs(SERVING, seed=3)
    net = FourierNeuralOperatorNetFilmed(SERVING, device=cuda, seed=1)
    plain = FourierNeuralOperatorNetFilmed(exact_config(SERVING), device=cuda)
    plain.load_state_dict(net.state_dict())
    xt, st = torch.from_numpy(x).to(cuda), torch.from_numpy(sst).to(cuda)
    with torch.inference_mode():
        reset_launch_counts()
        yk = net(xt, st)
        counts = launch_counts()
        yp = plain(xt, st)
    assert counts == {"spectral_mlp": 3, "grid_mlp": 4, "gcn_layer": 3,
                      "grid_encoder_spectral": 0, "spectral_decoder": 0, **NO_BACKWARD}
    assert torch.isfinite(yk).all()
    assert rel_l2(yk.cpu(), yp.cpu()) <= 3e-2


@pytest.mark.cuda
def test_fused_kernel_path_matches_plain_path(cuda):
    from msfno_torch.config import exact_config

    x, sst = inputs(FUSED_SERVING, seed=3)
    net = FourierNeuralOperatorNetFilmed(FUSED_SERVING, device=cuda, seed=1)
    plain = FourierNeuralOperatorNetFilmed(exact_config(FUSED_SERVING), device=cuda)
    plain.load_state_dict(net.state_dict())
    xt, st = torch.from_numpy(x).to(cuda), torch.from_numpy(sst).to(cuda)
    with torch.inference_mode():
        reset_launch_counts()
        yk = net(xt, st)
        counts = launch_counts()
        yp = plain(xt, st)
    # the last block has no channel MLP; the encoder and decoder sites of
    # grid_mlp are the fused head and tail
    assert counts == {"spectral_mlp": 3, "grid_mlp": 2, "gcn_layer": 3,
                      "grid_encoder_spectral": 1, "spectral_decoder": 1, **NO_BACKWARD}
    assert torch.isfinite(yk).all()
    assert rel_l2(yk.cpu(), yp.cpu()) <= 3e-2


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,counts", [
    # JAX's `--use-pallas --pallas-grid-mlp --grid-mlp-mxu-dtype float32` at
    # the small size: every kernel on fp32 operands; unfused, the encoder,
    # the two inner MLPs and the decoder are grid_mlp sites
    ("fp32", FP32, {"spectral_mlp": 3, "grid_mlp": 4, "gcn_layer": 3,
                    "grid_encoder_spectral": 0, "spectral_decoder": 0}),
    ("fused fp32", FUSED_FP32, {"spectral_mlp": 3, "grid_mlp": 2, "gcn_layer": 3,
                                "grid_encoder_spectral": 1, "spectral_decoder": 1}),
])
def test_fp32_kernel_path_matches_plain_path(cuda, name, cfg, counts):
    """The fp32-operand kernel tier against its exact_config twin (the plain
    path, same weights) on the card: the exact tier's limits, 1e-4 for the
    step and 1e-5 for the FiLM generator's gamma and beta."""
    from msfno_torch.config import exact_config

    x, sst = inputs(cfg, seed=3)
    net = FourierNeuralOperatorNetFilmed(cfg, device=cuda, seed=1)
    plain = FourierNeuralOperatorNetFilmed(exact_config(cfg), device=cuda)
    plain.load_state_dict(net.state_dict())
    xt, st = torch.from_numpy(x).to(cuda), torch.from_numpy(sst).to(cuda)
    films = []
    hooks = [m.film_gen.register_forward_hook(lambda mod, i, out: films.append(out))
             for m in (net, plain)]
    with torch.inference_mode():
        reset_launch_counts()
        yk = net(xt, st)
        got = launch_counts()
        yp = plain(xt, st)
    for h in hooks:
        h.remove()
    assert got == {**counts, **NO_BACKWARD}
    assert torch.isfinite(yk).all()
    assert report(f"fp32 kernel path[{name}] vs plain", rel_l2(yk.cpu(), yp.cpu())) <= 1e-4
    assert rel_l2(films[0].cpu(), films[1].cpu()) <= 1e-5
