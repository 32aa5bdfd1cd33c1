"""Layers and blocks of the PyTorch port: the InstanceNorm statistics
contract, the norm_affine fold into the SHT, and one SFNO block (plain and
filmed, with the spectral_mlp and grid_mlp plain versions; block 0 fed the
fused head's longitude modes; the last block in fused-tail mode) against the
JAX package."""

import numpy as np
import pytest
import torch

from msfno_torch.convert import from_flax_params
from msfno_torch.models.sfno.blocks import FourierNeuralOperatorBlock
from msfno_torch.models.sfno.layers import (
    InstanceNorm,
    SpectralAttentionS2,
    SpectralGridIn,
    spatial_stats,
)
from msfno_torch.ops.sht import InverseRealSHT, RealSHT

torch.set_num_threads(2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def report(name, value):
    """The measured error, for the parity table (pytest -s shows it)."""
    print(f"parity {name} rel_l2={value:.3e}")
    return value


def _x(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


def test_instance_norm_stats_contract():
    norm = InstanceNorm(6, device="cpu")
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    x = 3.0 + 2.0 * _x((2, 5, 7, 6))
    with torch.no_grad():
        y = norm(x)
        np.testing.assert_allclose(norm(x, stats=spatial_stats(x)), y, rtol=1e-5, atol=1e-5)
        a, b = norm(x, return_affine=True)
        np.testing.assert_allclose(a * x + b, y, rtol=1e-5, atol=1e-5)
    # normalized per (sample, channel): mean = bias, std = |weight|
    np.testing.assert_allclose(y.mean(dim=(1, 2)), norm.bias.detach().expand(2, 6), atol=1e-4)


def test_norm_affine_fold_is_exact():
    kw = dict(nlat=16, nlon=32, grid="legendre-gauss", spectral_rescale=1e5)
    filt = SpectralAttentionS2(RealSHT(**kw), InverseRealSHT(**kw), 16,
                               spectral_layers=2, device="cpu",
                               gen=torch.Generator().manual_seed(0))
    norm = InstanceNorm(16, device="cpu")
    x = 1.0 + _x((2, 16, 32, 16), 1)
    with torch.no_grad():
        folded = filt(x, norm_affine=norm(x, return_affine=True))
        plain = filt(norm(x))
    assert report("norm_affine fold", rel_l2(folded, plain)) <= 1e-5


def _jax_block(i, filmed, x, gamma, beta):
    """The JAX block i of a 3-block net, its params and its output."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from msfno_tpu.models.sfno.blocks import FourierNeuralOperatorBlock as JBlock
    from msfno_tpu.models.sfno.sfnonet import _block_kwargs, build_transforms
    from msfno_tpu.utils.config import SFNOConfig

    cfg = _cfg(SFNOConfig)
    kw = _block_kwargs(cfg, i, build_transforms(cfg))
    blk = JBlock(**kw, filmed=filmed)
    args = (jnp.asarray(x),) + ((jnp.asarray(gamma), jnp.asarray(beta), 0.7) if filmed else ())
    params = blk.init(jax.random.PRNGKey(i), *args)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    # non-trivial norm affines
    rng = np.random.default_rng(10 + i)
    for n in ("norm0", "norm1"):
        params[n]["scale"] = (1.0 + 0.2 * rng.standard_normal(16)).astype(np.float32)
        params[n]["bias"] = (0.2 * rng.standard_normal(16)).astype(np.float32)
    return cfg, params, np.asarray(blk.apply({"params": params}, *args))


def _cfg(cls, **kw):
    return cls(img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3,
               embed_dim=16, num_layers=3, spectral_layers=2, use_pallas=True,
               pallas_grid_mlp=True, grid_mlp_mxu_dtype="float32",
               fuse_encoder_dft=False, fuse_decoder_tail=False, **kw)


@pytest.mark.parametrize("i,filmed", [(0, False), (1, False), (1, True), (2, True)])
def test_block_matches_jax(i, filmed):
    from msfno_torch.config import SFNOConfig
    from msfno_torch.models.sfno.sfnonet import _block_kwargs, build_transforms

    shape = (2, 16, 32, 16) if i == 0 else (2, 8, 16, 16)
    x = _x(shape, 2).numpy()
    gamma, beta = 0.3 * _x((2, 16), 3).numpy(), 0.3 * _x((2, 16), 4).numpy()
    jcfg, params, yj = _jax_block(i, filmed, x, gamma, beta)
    cfg = _cfg(SFNOConfig)
    blk = FourierNeuralOperatorBlock(**_block_kwargs(cfg, i, build_transforms(cfg)),
                                     filmed=filmed, device="cpu")
    prefix = f"blocks.{i}."
    sd = from_flax_params({f"blocks_{i}": params})
    blk.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    args = (torch.from_numpy(gamma), torch.from_numpy(beta), 0.7) if filmed else ()
    with torch.no_grad():
        yt = blk(torch.from_numpy(x), *args)
    assert yt.shape == yj.shape
    assert report(f"block[{i}, filmed={filmed}]", rel_l2(yt, yj)) <= 1e-5


@pytest.mark.parametrize("mode,i,filmed", [
    ("spectral_in", 0, False),
    ("fuse_tail", 2, True),
    ("fuse_tail", 2, False),
])
def test_fused_block_matches_jax(mode, i, filmed):
    """Block 0 fed a SpectralGridIn (longitude modes + encoder statistics),
    and the last block in fused-tail mode returning (hm, a, b)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from msfno_tpu.models.sfno.blocks import FourierNeuralOperatorBlock as JBlock
    from msfno_tpu.models.sfno.layers import SpectralGridIn as JSpectralGridIn
    from msfno_tpu.models.sfno.sfnonet import _block_kwargs as jkw
    from msfno_tpu.models.sfno.sfnonet import build_transforms as jtransforms
    from msfno_tpu.utils.config import SFNOConfig as JConfig

    from msfno_torch.config import SFNOConfig
    from msfno_torch.models.sfno.sfnonet import _block_kwargs, build_transforms

    x = _x((2, 16, 32, 16) if i == 0 else (2, 8, 16, 16), 5).numpy()
    gamma, beta = 0.3 * _x((2, 16), 6).numpy(), 0.3 * _x((2, 16), 7).numpy()
    jcfg, cfg = _cfg(JConfig), _cfg(SFNOConfig)
    fuse_tail = mode == "fuse_tail"
    jblk = JBlock(**jkw(jcfg, i, jtransforms(jcfg)), filmed=filmed, fuse_tail=fuse_tail)
    blk = FourierNeuralOperatorBlock(**_block_kwargs(cfg, i, build_transforms(cfg)),
                                     filmed=filmed, fuse_tail=fuse_tail, device="cpu")
    film_j = (jnp.asarray(gamma), jnp.asarray(beta), 0.7) if filmed else (None, None, 1.0)
    film_t = (torch.from_numpy(gamma), torch.from_numpy(beta), 0.7) if filmed else ()
    if mode == "spectral_in":
        cs = blk.filter_layer.filter.forward_transform.merged_analysis
        f = np.einsum("bhwc,wm->bhmc", x, cs).astype(np.float32)
        stats = (x.sum((1, 2)), (x * x).sum((1, 2)), 16 * 32)
        xj, xt = JSpectralGridIn(jnp.asarray(f)), SpectralGridIn(torch.from_numpy(f))
        stats_j = (jnp.asarray(stats[0]), jnp.asarray(stats[1]), stats[2])
        stats_t = (torch.from_numpy(stats[0]), torch.from_numpy(stats[1]), stats[2])
    else:
        xj, xt, stats_j, stats_t = jnp.asarray(x), torch.from_numpy(x), None, None
    params = jblk.init(jax.random.PRNGKey(i), xj, *film_j, norm0_stats=stats_j)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    rng = np.random.default_rng(20 + i)
    for n in ("norm0", "norm1"):
        params[n]["scale"] = (1.0 + 0.2 * rng.standard_normal(16)).astype(np.float32)
        params[n]["bias"] = (0.2 * rng.standard_normal(16)).astype(np.float32)
    yj = jblk.apply({"params": params}, xj, *film_j, norm0_stats=stats_j)
    prefix = f"blocks.{i}."
    sd = from_flax_params({f"blocks_{i}": params})
    blk.load_state_dict({k[len(prefix):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        yt = blk(xt, *film_t, norm0_stats=stats_t)
    if fuse_tail:
        for part, a, b in zip(("hm", "a", "b"), yt, yj):
            assert a.shape == b.shape
            assert report(f"block[{i}, fuse_tail, filmed={filmed}] {part}",
                          rel_l2(a, b)) <= 1e-5
    else:
        assert yt.shape == yj.shape
        assert report(f"block[{i}, SpectralGridIn]", rel_l2(yt, yj)) <= 1e-5
