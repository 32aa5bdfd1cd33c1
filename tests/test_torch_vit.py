"""The ViT FiLM generator of the PyTorch port (msfno_torch/models/film/
{attention,vit}.py) against the JAX package's: patchify / unpatchify /
token validity / masked mean, the generator's gamma / beta at fp32 (1e-5)
and bf16 (the bf16 class), a filmed net step with it (fp32, 1e-5), the
reference names from_flax_params gives its weights, the masking of
NaN-heavy tokens, and a film-only train step against the JAX trainer
(loss 1e-5, gradient 1e-4), with film dropout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.convert import from_flax_params, from_flax_train_state
from msfno_torch.models import FourierNeuralOperatorNetFilmed
from msfno_torch.models.film import attention as tatt
from msfno_torch.models.film.wrapper import FilmWrapper
from msfno_torch.training.trainer import Trainer as TTrainer
from msfno_tpu.data.synthetic import gen_batch
from msfno_tpu.models.film import attention as jatt
from msfno_tpu.models.film.wrapper import FilmWrapper as JFilmWrapper
from msfno_tpu.training.partition import merge_params
from msfno_tpu.training.trainer import Trainer as JTrainer
from msfno_tpu.utils import config as jcfg
from test_torch_model import inputs, rel_l2, report, torch_net
from tests.test_training import small_cfg

torch.set_num_threads(2)

# a small ViT: 2 x 2 x 4 = 16 tokens of 2 x 8 x 8, 3 layers
VIT = tcfg.FilmConfig(film_gen_type="transformer", model_depth=3, embed_dim=32, mlp_dim=48,
                      num_film_features=32, sst_shape=(16, 32), temporal_step=4,
                      patch_size=(2, 8, 8))
# bf16 operands against fp32: the class of one bf16 rounding per layer
BF16_TOL = 3e-2


def _sst(film, seed=0, batch=2):
    """SST with NaN over land: of the 8 patches of a time slot, 3 wholly
    land, one half land (masked: the share is not below 0.5), one a quarter
    land (valid)."""
    rng = np.random.default_rng(seed)
    t, (h, w) = film.temporal_step, film.sst_shape
    sst = rng.standard_normal((batch, t, h, w)).astype(np.float32)
    sst[:, :, :8, :24] = np.nan
    sst[:, :, 8:12, 24:32] = np.nan  # half the rows of that patch: ratio 0.5, masked
    sst[:, :, 8:10, :8] = np.nan  # a quarter: valid
    return sst


def _jax_vit(film, seed=0):
    """The JAX film wrapper's params with a random (non-zero) film head."""
    cfg_j = jcfg.from_json(tcfg.to_json(film))
    mod = JFilmWrapper(cfg_j)
    sst = _sst(film)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(mod.init)(jax.random.PRNGKey(seed), jnp.asarray(sst))["params"])
    head = params["film_gen"]["head_film"]
    rng = np.random.default_rng(seed + 1)
    head["kernel"] = (rng.standard_normal(head["kernel"].shape) * 0.2).astype(np.float32)
    head["bias"] = (rng.standard_normal(head["bias"].shape) * 0.1).astype(np.float32)
    return mod, params, sst


def _torch_vit(film, params):
    """The port's film wrapper with the JAX wrapper's params: the net's
    names (from_flax_params of the net-level tree) less "film_gen."."""
    wrap = FilmWrapper(film, device="cpu")
    state = from_flax_params({"film_gen": params})
    wrap.load_state_dict({k.removeprefix("film_gen."): v for k, v in state.items()},
                         strict=True)
    return wrap


def test_patchify_validity_and_masked_mean_match_jax():
    x = _sst(VIT)
    tj = np.asarray(jatt.patchify(jnp.asarray(x), 2, 8, 8))
    tt = tatt.patchify(torch.from_numpy(x), 2, 8, 8)
    np.testing.assert_array_equal(tt.numpy(), tj)
    back = tatt.unpatchify(tt, 2, 8, 8, 2, 2, 4)
    np.testing.assert_array_equal(back.numpy(), x)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jatt.unpatchify(jnp.asarray(tj), 2, 8, 8, 2, 2, 4)))
    (mj, vj), (mt, vt) = jatt.token_validity(jnp.asarray(tj), 0.5), tatt.token_validity(tt, 0.5)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.sum() == 2 * 8  # 8 of the 16 tokens are masked in each sample
    y = np.random.default_rng(1).standard_normal(tj.shape[:2] + (5,)).astype(np.float32)
    np.testing.assert_allclose(tatt.masked_mean(torch.from_numpy(y), vt).numpy(),
                               np.asarray(jatt.masked_mean(jnp.asarray(y), vj)), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gamma_beta_match_jax(dtype):
    film = dataclasses.replace(VIT, compute_dtype=dtype)
    mod, params, sst = _jax_vit(film)
    yj = np.asarray(jax.jit(mod.apply)({"params": params}, jnp.asarray(sst)), np.float32)
    wrap = _torch_vit(film, params)
    with torch.no_grad():
        yt = wrap(torch.from_numpy(sst))
    assert yt.shape == yj.shape == (2, 2, 1, 32) and yt.dtype == torch.float32
    tol = 1e-5 if dtype == "float32" else BF16_TOL
    assert report(f"vit gamma/beta[{dtype}] vs jax", rel_l2(yt, yj)) <= tol
    if dtype == "bfloat16":  # and the bf16 generator against the fp32 one
        fp32 = _torch_vit(VIT, params)
        with torch.no_grad():
            y32 = fp32(torch.from_numpy(sst))
        assert report("vit gamma/beta bf16 vs fp32", rel_l2(yt, y32)) <= BF16_TOL


def test_masked_tokens_are_neither_keys_nor_pooled():
    """A land-heavy token's finite values change nothing (masked as a key
    and in the pooling); an all-land history stays finite."""
    _, params, sst = _jax_vit(VIT)
    wrap = _torch_vit(VIT, params)
    other = sst.copy()
    other[:, :, 12:16, 24:32] += 5.0  # the finite rows of the half-land patch
    with torch.no_grad():
        a, b = wrap(torch.from_numpy(sst)), wrap(torch.from_numpy(other))
        land = wrap(torch.full_like(torch.from_numpy(sst), float("nan")))
    torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    assert torch.isfinite(land).all()
    changed = sst.copy()
    changed[:, :, 8:10, :8] = 5.0  # the 1/4-land patch is valid: it counts
    with torch.no_grad():
        assert not torch.allclose(wrap(torch.from_numpy(changed)), a)


def test_parameter_names_are_the_reference_export():
    """from_flax_params names the ViT's weights as the JAX package's export
    to the reference layout does, value for value."""
    from msfno_tpu.models.convert import export_sfno_state_dict

    _, params, _ = _jax_vit(VIT)
    ours = from_flax_params({"film_gen": params})
    ref = export_sfno_state_dict({"film_gen": params})
    assert set(ours) == set(ref)
    assert "film_gen.film_gen.transformer.layers.2.0.to_qkv.weight" in ours
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)


def test_filmed_step_with_vit_matches_jax():
    # the backbone's kernels are held against JAX in tests/test_torch_model.py
    from msfno_tpu.models import FourierNeuralOperatorNetFilmed as JFilmed

    base = small_cfg()
    cfg = dataclasses.replace(base, film=dataclasses.replace(
        VIT, num_film_features=base.embed_dim))
    model = JFilmed(jcfg.from_json(tcfg.to_json(cfg)))
    x, sst = (jnp.asarray(a) for a in inputs(cfg))
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x, sst)["params"])
    head = params["film_gen"]["film_gen"]["head_film"]
    head["kernel"] = (0.05 * np.random.default_rng(3).standard_normal(head["kernel"].shape)
                      ).astype(np.float32)
    yj = np.asarray(jax.jit(model.apply)({"params": params}, x, sst, 0.8))
    net = torch_net(cfg, params)
    with torch.no_grad():
        yt = net(torch.from_numpy(np.array(x)), torch.from_numpy(np.array(sst)), 0.8)
    assert report("filmed net[fp32, vit generator]", rel_l2(yt, yj)) <= 1e-5


def _vit_small(dropout=0.0):
    cfg = small_cfg(film=True)
    return dataclasses.replace(cfg, film=dataclasses.replace(
        cfg.film, film_gen_type="transformer", dropout=dropout))


def test_film_only_train_step_matches_jax():
    """The JAX trainer's film-only step at small_cfg with the ViT generator
    (its head random, so that the gradient reaches the transformer)."""
    cfg = _vit_small()
    train = jcfg.TrainConfig(film_scale_start=0.8)
    jt = JTrainer(cfg, train)
    js = jt.init_state()
    head = js.trainable["film_gen"]["film_gen"]["head_film"]
    head["kernel"] = jnp.asarray(0.1 * np.random.default_rng(4).standard_normal(
        head["kernel"].shape), jnp.float32)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pt = TTrainer(tcfg.from_json(jcfg.to_json(cfg)), tcfg.from_json(jcfg.to_json(train)),
                  device="cpu")
    pt.model.load_state_dict(from_flax_train_state(np_tree(js.trainable), np_tree(js.frozen)))
    ps = pt.init_state()
    batch = gen_batch(cfg, 1, 0, seed=6)

    def loss_fn(trainable):
        return jt._rollout_loss(merge_params(trainable, js.frozen), jnp.asarray(batch.era5),
                                jnp.asarray(batch.sst), js.film_scale)[0]

    jl, jg = jax.jit(jax.value_and_grad(loss_fn))(js.trainable)
    pl, _, pg = pt.loss_and_grads(ps, *pt._device_batch(batch))
    assert report("vit trainer loss", abs(float(pl) - float(jl)) / float(jl)) <= 1e-5
    ref = from_flax_params(np_tree(jg))
    num = sum(float(((pg[k].double() - ref[k].double()) ** 2).sum()) for k in ref)
    den = sum(float((ref[k].double() ** 2).sum()) for k in ref)
    assert set(pg) == set(ref) and any(".transformer." in k for k in pg)
    assert report("vit trainer film grad", (num / den) ** 0.5) <= 1e-4


def test_film_dropout_acts_in_training_only():
    """film.dropout is accepted for the ViT: an eval forward is the
    no-dropout net's, bit for bit; a train step draws masks and differs."""
    cfg = _vit_small(dropout=0.3)
    pt = TTrainer(cfg, tcfg.TrainConfig(film_scale_start=0.8), device="cpu")
    assert pt._has_dropout
    plain = FourierNeuralOperatorNetFilmed(_vit_small(), device="cpu")
    plain.load_state_dict(pt.model.state_dict())
    head = pt.model.film_gen.film_gen.head_film.weight
    with torch.no_grad():
        head.copy_(0.1 * torch.randn(head.shape, generator=torch.Generator().manual_seed(2)))
        plain.film_gen.film_gen.head_film.weight.copy_(head)
    batch = gen_batch(cfg, 1, 0, seed=7)
    x, sst = torch.from_numpy(batch.era5[0]), torch.from_numpy(batch.sst[1])
    with torch.no_grad():
        a, b = pt.model(x, sst, 0.8), plain(x, sst, 0.8)
        c = pt.model(x, sst, 0.8, rng=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    ps = pt.init_state()
    ps, m = pt._train_step(ps, *pt._device_batch(batch))
    assert np.isfinite(float(m["loss"])) and ps.step == 1
