"""The MAE of the PyTorch port (msfno_torch/models/film/mae.py,
models/registry_mae.py, the "mae" generator of FilmWrapper) against the
JAX package's: ContextCast at mask ratio 0, a float ratio and a tensor
ratio (the JAX draws handed to the port as `noise`; mean, std and class
tokens 1e-5, masks exactly equal), the kept count where n (1 - r) lands on
an integer, an all-land window, the pretraining loss (1e-5) and gradient
(1e-4), parameters after 3 Adam steps (1e-5), filmed nets with the MAE
generator and with class-token input (1e-5), a film-only train step
(loss 1e-5, gradient 1e-4), film dropout, the linear probe (1e-6) and a
miniature of examples/mae_oni_demo.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.convert import from_flax_mae_params, from_flax_params, from_flax_train_state
from msfno_torch.models import registry
from msfno_torch.models.film.mae import ContextCast
from msfno_torch.training.optim import Optimizer
from msfno_torch.training.trainer import Trainer as TTrainer
from msfno_tpu.data.synthetic import gen_batch
from msfno_tpu.models.film.mae import ContextCast as JContextCast
from msfno_tpu.models.registry import get_model as jax_get_model
from msfno_tpu.training.partition import merge_params
from msfno_tpu.training.trainer import Trainer as JTrainer
from msfno_tpu.utils import config as jcfg
from test_torch_model import inputs, rel_l2, report, torch_net
from tests.test_training import small_cfg

torch.set_num_threads(2)

# 2 x 2 x 5 = 20 tokens of 2 x 4 x 4; embed 32, 4 heads
FILM = tcfg.FilmConfig(film_gen_type="mae", embed_dim=32, mlp_dim=24, num_film_features=8,
                       sst_shape=(8, 20), temporal_step=4, patch_size=(2, 4, 4))
CFG = tcfg.SFNOConfig(img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3, embed_dim=8,
                      num_layers=2, spectral_layers=1, film=FILM)
N_TOKENS = 20
TOL, GRAD_TOL = 1e-5, 1e-4


def _sst(seed=0, batch=2):
    """SST with NaN over land: one token wholly land (invalid), one half
    land (invalid: the share is not below 0.5), one an eighth (valid)."""
    rng = np.random.default_rng(seed)
    sst = rng.standard_normal((batch, FILM.temporal_step, *FILM.sst_shape)).astype(np.float32)
    sst[:, :2, :4, :4] = np.nan
    sst[:, 2:, 4:8, 8:10] = np.nan
    sst[:, :1, 4:5, 16:20] = np.nan
    return sst


@functools.lru_cache(maxsize=None)
def _jax_module(heads=4):
    f = FILM
    jm = JContextCast(patch_size=f.patch_size, encoder_dim=f.embed_dim, decoder_dim=f.embed_dim,
                      heads=heads)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.asarray(_sst()))["params"])
    return jm, params


def _module(heads=4):
    """The JAX ContextCast, its params and the port's with them."""
    f = FILM
    jm, params = _jax_module(heads)
    tm = ContextCast((f.temporal_step, *f.sst_shape), patch_size=f.patch_size,
                     encoder_dim=f.embed_dim, decoder_dim=f.embed_dim, heads=heads, device="cpu")
    tm.load_state_dict(from_flax_mae_params(params), strict=True)
    return jm, params, tm


def _jax_noise(key, batch=2):
    return np.array(jax.random.uniform(key, (batch, N_TOKENS)))


@pytest.mark.parametrize("ratio", [0.0, 0.75, "tensor"])
def test_context_cast_matches_jax(ratio):
    jm, params, tm = _module()
    sst = _sst()
    key = jax.random.PRNGKey(3)
    r = np.float32(0.55) if ratio == "tensor" else ratio
    jr = jnp.asarray(r) if ratio == "tensor" else r
    outs_j = jax.jit(lambda p, x, k: jm.apply({"params": p}, x, mask_ratio=jr, rng=k))(
        params, jnp.asarray(sst), key)
    tr = torch.tensor(r) if ratio == "tensor" else r
    noise = None if ratio == 0.0 else torch.from_numpy(_jax_noise(key))
    with torch.no_grad():
        outs_t = tm(torch.from_numpy(sst), mask_ratio=tr, noise=noise)
    (mj, sj), (lmj, nej), cej, cdj = outs_j
    (mt, st), (lmt, net), cet, cdt = outs_t
    for name, a, b in (("mean", mt, mj), ("std", st, sj), ("cls encoder", cet, cej),
                       ("cls decoder", cdt, cdj)):
        assert a.shape == b.shape
        assert report(f"mae {name}[ratio {ratio}] vs jax", rel_l2(a, b)) <= TOL, name
    np.testing.assert_array_equal(lmt.numpy(), np.asarray(lmj))
    np.testing.assert_array_equal(net.numpy(), np.asarray(nej))
    assert lmt.shape == (2, *sst.shape[1:]) and (lmt.sum() > 0) == (ratio != 0.0)
    if ratio == 0.0:  # the film generator's encoder-only path: the same token
        with torch.no_grad():
            assert torch.equal(tm.encoder_class_token(torch.from_numpy(sst)), cet)


def test_layer_scale_matches_jax():
    """LayerScaled's per-channel gamma (`enc_attn_{i}/gamma` in flax)."""
    f = FILM
    jm = JContextCast(patch_size=f.patch_size, encoder_dim=f.embed_dim, decoder_dim=f.embed_dim,
                      heads=4, layer_scale=0.5)
    sst = _sst()
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(6), jnp.asarray(sst))["params"])
    params["dec_ff_1"]["gamma"] = np.linspace(0.1, 2.0, f.embed_dim, dtype=np.float32)
    key = jax.random.PRNGKey(7)
    cej = jax.jit(lambda p, x, k: jm.apply({"params": p}, x, mask_ratio=0.75, rng=k)[2:])(
        params, jnp.asarray(sst), key)
    tm = ContextCast((f.temporal_step, *f.sst_shape), patch_size=f.patch_size,
                     encoder_dim=f.embed_dim, decoder_dim=f.embed_dim, heads=4, layer_scale=0.5,
                     device="cpu")
    state = from_flax_mae_params(params)
    assert "dec_ff_1.gamma" in state and "enc_attn_0.gamma" in state
    tm.load_state_dict(state, strict=True)
    with torch.no_grad():
        cet = tm(torch.from_numpy(sst), mask_ratio=0.75,
                 noise=torch.from_numpy(_jax_noise(key)))[2:]
    for name, a, b in zip(("encoder", "decoder"), cet, cej):
        assert report(f"mae layer-scaled cls {name} vs jax", rel_l2(a, b)) <= TOL


def test_kept_count_at_an_integer_boundary():
    """n (1 - r) with n = 20, r = 0.9: 1.9999999999999996 in fp64 (a float
    ratio keeps 1 token), 2.0000005 in fp32 (a tensor ratio keeps 2); each
    path keeps JAX's count and the same tokens."""
    jm, params, tm = _module()
    sst = _sst()
    key = jax.random.PRNGKey(4)
    noise = torch.from_numpy(_jax_noise(key))
    scored = {}
    for name, jr, tr in (("float", 0.9, 0.9),
                         ("tensor", jnp.float32(0.9), torch.tensor(0.9, dtype=torch.float32))):
        lmj = jax.jit(lambda p, x, k, jr=jr: jm.apply({"params": p}, x, mask_ratio=jr,
                                                     rng=k)[1][0])(params, jnp.asarray(sst), key)
        with torch.no_grad():
            lmt = tm(torch.from_numpy(sst), mask_ratio=tr, noise=noise)[1][0]
        np.testing.assert_array_equal(lmt.numpy(), np.asarray(lmj))
        scored[name] = int(lmt.sum())
    assert scored["float"] > scored["tensor"]  # one token fewer kept, more scored


def test_all_land_window_stays_finite():
    _, _, tm = _module()
    sst = torch.full((2, FILM.temporal_step, *FILM.sst_shape), float("nan"))
    w = registry.get_model("mae", cfg=CFG, device="cpu")
    w.module.load_state_dict(tm.state_dict())
    (mean, std), (lm, ne), ce, cd = w.module(sst, mask_ratio=0.5,
                                             gen=torch.Generator().manual_seed(0))
    assert all(torch.isfinite(t).all() for t in (mean, std, ce, cd))
    assert lm.sum() == 0 and ne.all()
    loss = w.loss(sst, 0.5, gen=torch.Generator().manual_seed(1))
    loss.backward()
    assert torch.isfinite(loss)
    assert all(torch.isfinite(p.grad).all() for p in w.module.parameters())


def _wrappers():
    """The JAX MAEWrapper with seeded params and the port's with them."""
    jw = jax_get_model("mae", cfg=jcfg.from_json(tcfg.to_json(CFG)))
    jw.init_params(jax.random.PRNGKey(1))
    params = jax.tree_util.tree_map(np.asarray, jw.params)
    tw = registry.get_model("mae", cfg=CFG, device="cpu", seed=9)
    tw.module.load_state_dict(from_flax_mae_params(params), strict=True)
    return jw, params, tw


def _tree_rel(got: dict, jax_tree) -> float:
    """rel-L2 over every leaf of a MAEWrapper tree, matched by name."""
    ref = from_flax_mae_params(jax.tree_util.tree_map(np.asarray, jax_tree))
    assert set(got) == set(ref)
    num = sum(float(((got[k].detach().double() - ref[k].double()) ** 2).sum()) for k in ref)
    den = sum(float((ref[k].double() ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


@pytest.mark.parametrize("ratio", [0.75, "train_step"])
def test_loss_and_gradient_match_jax(ratio):
    """`MAEWrapper.loss` at a float ratio, and the loss of JAX's
    `make_train_step` (the ratio drawn U(0.4, 0.8) inside the step), with
    the JAX draws rebuilt: loss 1e-5, gradient 1e-4."""
    jw, params, tw = _wrappers()
    sst = _sst(seed=1)
    key = jax.random.PRNGKey(5)
    if ratio == "train_step":
        ratio_key, mask_key = jax.random.split(key)
        jr = jax.random.uniform(ratio_key, (), minval=0.4, maxval=0.8)
        tr = torch.tensor(np.asarray(jr))
    else:
        mask_key, jr, tr = key, ratio, ratio
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jw.loss(p, jnp.asarray(sst), jr, mask_key)))(
        jw.params)
    noise = torch.from_numpy(_jax_noise(jax.random.split(mask_key)[0]))
    loss = tw.loss(sst, tr, noise=noise)
    loss.backward()
    tl = float(loss.detach())
    assert report(f"mae loss[{ratio}] vs jax", abs(tl - float(jl)) / float(jl)) <= TOL
    grads = {n: p.grad for n, p in tw.module.named_parameters()}
    assert report(f"mae grad[{ratio}] vs jax", _tree_rel(grads, jg)) <= GRAD_TOL
    if ratio == "train_step":  # and the JAX step's own loss
        tx = optax.adam(1e-3)
        _, _, sl = jw.make_train_step(tx)(jw.params, tx.init(jw.params), jnp.asarray(sst), key)
        assert abs(float(sl) - float(jl)) <= 1e-6 * abs(float(jl))


def test_three_adam_steps_match_jax():
    jw, params, tw = _wrappers()
    tx = optax.adam(1e-3)
    step = jw.make_train_step(tx)
    jp, js = jw.params, tx.init(jw.params)
    opt = Optimizer(tcfg.TrainConfig(optimizer="adam", learning_rate=1e-3))
    named = dict(tw.module.named_parameters())
    state = opt.init(named)
    for i in range(3):
        sst = _sst(seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        jp, js, jl = step(jp, js, jnp.asarray(sst), key)
        ratio_key, mask_key = jax.random.split(key)
        tr = torch.tensor(np.asarray(jax.random.uniform(ratio_key, (), minval=0.4, maxval=0.8)))
        noise = torch.from_numpy(_jax_noise(jax.random.split(mask_key)[0]))
        for p in named.values():
            p.grad = None
        tl = tw.loss(sst, tr, noise=noise)
        tl.backward()
        state = opt.step(named, {n: p.grad for n, p in named.items()}, state)
        assert abs(float(tl) - float(jl)) <= TOL * abs(float(jl))
    assert report("mae params after 3 adam steps vs jax", _tree_rel(named, jp)) <= TOL


def test_train_step_and_pretrain():
    """The port's own draws: a step changes every parameter; `pretrain`
    reads every loss, finite; the class tokens of a dataset."""
    w = registry.get_model("mae", cfg=CFG, device="cpu", seed=2)
    before = {k: v.clone() for k, v in w.module.state_dict().items()}
    batches = [_sst(seed=30 + i) for i in range(4)]
    _, losses = w.pretrain(batches, steps=3, learning_rate=1e-3, seed=0)
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert all(not torch.equal(before[k], v) for k, v in w.module.state_dict().items())
    enc, dec = w.compute_cls_tokens(batches[:2])
    assert enc.shape == dec.shape == (4, FILM.embed_dim) and np.isfinite(enc).all()
    with pytest.raises(ValueError, match="noise"):
        w.module(torch.from_numpy(batches[0]), mask_ratio=0.5)


def test_checkpoints_round_trip(tmp_path):
    """The port's `.pt` and a JAX `.npz` of a MAEWrapper load."""
    from msfno_tpu.training import checkpoint as jckpt

    jw, params, tw = _wrappers()
    npz = str(tmp_path / "mae.npz")
    jckpt.save_checkpoint(npz, jw.params, config_json=jcfg.to_json(jw.cfg))
    a = registry.get_model("mae", cfg=CFG, device="cpu", seed=3)
    a.load_model(npz)
    pt = a.save_checkpoint(str(tmp_path / "mae.pt"))
    b = registry.get_model("mae", cfg=CFG, device="cpu", seed=4)
    b.load_model(pt)
    for k, v in tw.module.state_dict().items():
        assert torch.equal(a.module.state_dict()[k], v) and torch.equal(b.module.state_dict()[k], v)


def _mae_cfg(cls_input=False):
    base = small_cfg(film=True)
    return dataclasses.replace(base, film=dataclasses.replace(
        base.film, film_gen_type="mae", cls_input=cls_input, num_film_features=base.embed_dim))


@pytest.mark.parametrize("cls_input", [False, True])
def test_filmed_net_matches_jax(cls_input):
    from msfno_tpu.models import FourierNeuralOperatorNetFilmed as JFilmed

    cfg = tcfg.from_json(jcfg.to_json(_mae_cfg(cls_input)))
    model = JFilmed(jcfg.from_json(tcfg.to_json(cfg)))
    x, sst = inputs(cfg, batch=2)
    if cls_input:
        sst = np.random.default_rng(2).standard_normal((2, cfg.film.embed_dim)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(sst))["params"])
    assert ("film_gen" in params["film_gen"]) != cls_input
    yj = np.asarray(jax.jit(model.apply)({"params": params}, jnp.asarray(x), jnp.asarray(sst),
                                         0.8))
    net = torch_net(cfg, params)
    with torch.no_grad():
        yt = net(torch.from_numpy(x), torch.from_numpy(sst), 0.8)
    assert report(f"filmed net[mae generator, cls_input={cls_input}]", rel_l2(yt, yj)) <= TOL


def test_film_head_names_are_the_reference_export():
    from msfno_tpu.models.convert import export_sfno_state_dict
    from msfno_tpu.models.film.wrapper import FilmWrapper as JFilmWrapper

    cfg = jcfg.from_json(tcfg.to_json(_mae_cfg()))
    sst = inputs(_mae_cfg())[1]
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JFilmWrapper(cfg.film).init)(
        jax.random.PRNGKey(0), jnp.asarray(sst))["params"])
    ours = from_flax_params({"film_gen": params})
    ref = {k: v for k, v in export_sfno_state_dict({"film_gen": params}).items()
           if k.startswith("film_gen.film_head.")}
    assert set(ref) == {f"film_gen.film_head.net.{i}.{k}" for i in "014"
                        for k in ("weight", "bias")}
    for k, v in ref.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    assert "film_gen.film_gen.enc_attn_3.inner.to_qkv.weight" in ours
    assert "film_gen.film_gen.dec_ff_1.inner.net.4.weight" in ours


def test_film_only_train_step_matches_jax():
    """The JAX trainer's film-only step at small_cfg with the MAE generator:
    the whole film_gen subtree (ContextCast and the film head) trains."""
    cfg = _mae_cfg()
    train = jcfg.TrainConfig(film_scale_start=0.8)
    jt = JTrainer(cfg, train)
    js = jt.init_state()
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
    assert report("mae trainer loss", abs(float(pl) - float(jl)) / float(jl)) <= TOL
    ref = from_flax_params(np_tree(jg))
    num = sum(float(((pg[k].double() - ref[k].double()) ** 2).sum()) for k in ref)
    den = sum(float((ref[k].double() ** 2).sum()) for k in ref)
    assert set(pg) == set(ref) and any(".enc_attn_" in k for k in pg)
    assert any(k.startswith("film_gen.film_head.") for k in pg)
    assert report("mae trainer film grad", (num / den) ** 0.5) <= GRAD_TOL


def test_lin_probe_matches_jax():
    rng = np.random.default_rng(0)
    cls = rng.standard_normal((64, FILM.embed_dim)).astype(np.float32)
    oni = cls @ rng.standard_normal(FILM.embed_dim) + 0.3 * rng.standard_normal(64)
    jp = jax_get_model("mae", "lin-probe", cfg=jcfg.from_json(tcfg.to_json(CFG)))
    tp = registry.get_model("mae", "lin-probe", cfg=CFG, device="cpu")
    jparams = jp.fit(cls[:48], oni[:48], l2=1e-2)
    tp.fit(cls[:48], oni[:48], l2=1e-2)
    ref = from_flax_mae_params(jax.tree_util.tree_map(np.asarray, jparams))
    for k, v in tp.module.state_dict().items():
        assert report(f"lin probe {k} vs jax", rel_l2(v, ref[k])) <= 1e-6
    jm, tm = jp.mae_metric(cls[48:], oni[48:]), tp.mae_metric(cls[48:], oni[48:])
    assert report("lin probe mae_metric vs jax", abs(tm - jm) / jm) <= 1e-6


def test_probe_beats_climatology():
    """A port miniature of examples/mae_oni_demo.py: pretrain the MAE on
    SST windows, ridge-fit the probe on the class tokens, and beat the
    day-of-year climatology of the ONI on held-out time (the reference's
    LinearProbingMAE yardstick: 0.25-0.40 against 0.628)."""
    from examples.mae_oni_demo import make_synthetic_sst_series
    from msfno_torch.data.sst import compute_oni

    window, n_days, steps = 4, 240, 10
    sst, doy, lat, lon, _ = make_synthetic_sst_series(n_days=n_days, seed=0)
    oni = compute_oni(sst, doy, lat, lon, smooth_days=30)
    h, w = sst.shape[-2:]
    cfg = tcfg.SFNOConfig(img_size=(h, w), scale_factor=2, in_chans=3, out_chans=3, embed_dim=8,
                          num_layers=1, spectral_layers=1, film=tcfg.FilmConfig(
                              model_depth=1, embed_dim=64, mlp_dim=64, sst_shape=(h, w),
                              temporal_step=window, patch_size=(window, 4, 4)))
    mae = registry.get_model("mae", cfg=cfg, device="cpu")
    idx = np.arange(window, n_days)
    windows = np.stack([sst[i - window:i] for i in idx])
    targets, doy_idx = oni[idx], doy[idx]
    order = np.random.default_rng(0).permutation(len(windows))
    mae.pretrain((windows[order[(s * 8) % len(order):][:8]] for s in range(steps)),
                 steps=steps, learning_rate=1e-3)
    cls_enc, _ = mae.compute_cls_tokens(windows[i:i + 32] for i in range(0, len(windows), 32))
    split = int(0.7 * len(windows))
    probe = registry.get_model("mae", "lin-probe", cfg=cfg, device="cpu")
    probe.fit(cls_enc[:split], targets[:split], l2=1e-3)
    model_mae = probe.mae_metric(cls_enc[split:], targets[split:])
    clim, cnt = np.zeros(367), np.zeros(367)
    np.add.at(clim, doy_idx[:split], targets[:split])
    np.add.at(cnt, doy_idx[:split], 1)
    clim_mae = float(np.mean(np.abs(clim[doy_idx[split:]] / np.maximum(cnt[doy_idx[split:]], 1)
                                    - targets[split:])))
    print(f"mae_oni_demo (port): probe {model_mae:.4f}, climatology {clim_mae:.4f}")
    assert np.isfinite(model_mae) and model_mae < clim_mae
