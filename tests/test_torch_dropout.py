"""Dropout and drop-path in the port: the keep rate of the masks within a
binomial bound, a forward outside training bit-identical with the rates set
and unset (where the JAX gates do not depend on the rates), the kernels each
forward reaches counted against the JAX package's gates (the wrappers' calls
on both sides, JAX's traced by `jax.eval_shape`), and a Trainer that trains
with the rates set.  `film.dropout` is a no-op for the GCN generators, as in
JAX.  The masks' random streams differ from JAX's, so nothing here compares
a training forward's values with JAX."""

import dataclasses
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.config import from_json
from msfno_torch.models import FourierNeuralOperatorNet, FourierNeuralOperatorNetFilmed
from msfno_torch.models.sfno import layers as tlayers
from msfno_torch.training.trainer import Trainer as TTrainer
from msfno_tpu.data.synthetic import gen_batch
from msfno_tpu.models import FourierNeuralOperatorNetFilmed as JNet
from msfno_tpu.utils import config as jcfg
from test_torch_model import inputs
from tests.test_torch_trainer import CFG, pair, report

torch.set_num_threads(2)

FILM = tcfg.FilmConfig(model_depth=1, embed_dim=16, mlp_dim=16, num_film_features=16,
                       sst_shape=(8, 16), temporal_step=2)
# every kernel of the JAX fast path, at a small size: spectral_mlp, grid_mlp
# (the inner MLP folding norm1 + FiLM), the fused head and the fused tail
KERNELS = tcfg.SFNOConfig(img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3,
                          embed_dim=16, num_layers=4, spectral_layers=2, film=FILM,
                          use_pallas=True, pallas_grid_mlp=True, fuse_inner_mlp=True)
RATES = [(0.0, 0.0), (0.2, 0.0), (0.0, 0.2), (0.2, 0.2)]


def binomial_ok(kept: int, n: int, keep: float) -> bool:
    """Within 5 standard deviations of n * keep."""
    return abs(kept - n * keep) <= 5 * math.sqrt(n * keep * (1 - keep))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_keep_rates_within_binomial_bound(rate):
    g = torch.Generator().manual_seed(0)
    keep = 1 - rate
    x = torch.ones(200, 300)
    y = tlayers.dropout(x, rate, g)
    kept = int((y != 0).sum())
    assert binomial_ok(kept, x.numel(), keep)
    assert torch.allclose(y[y != 0], torch.full((kept,), 1 / keep))
    # drop-path: one draw a sample, the whole sample kept or zeroed
    p = tlayers.drop_path(torch.ones(4000, 3, 5, 2), rate, g)
    per_sample = p.reshape(4000, -1)
    assert bool(((per_sample == 0).all(1) | (per_sample == 1 / keep).all(1)).all())
    assert binomial_ok(int((per_sample[:, 0] != 0).sum()), 4000, keep)
    # the spectral layers' mask: one draw a complex value, shared by re and im
    z = torch.ones(2, 20, 30, 40)
    zd = tlayers.dropout(z, rate, g, z.shape[1:])
    assert torch.equal(zd[0] == 0, zd[1] == 0)
    assert binomial_ok(int((zd[0] != 0).sum()), zd[0].numel(), keep)


def test_model_keep_rate_of_the_channel_mlp():
    """Inside a net: the channel MLP's hidden activation keeps 1 - rate of
    its elements in training (captured at its second product)."""
    cfg = dataclasses.replace(KERNELS, use_pallas=False, pallas_grid_mlp=False, film=None,
                              drop_rate=0.3)
    net = FourierNeuralOperatorNet(cfg, device="cpu", seed=0)
    seen = []
    mlp = net.blocks[1].mlp
    orig = tlayers.dense

    def spy(x, conv, dtype):
        if conv is mlp.fwd["2"]:
            seen.append(x.detach())
        return orig(x, conv, dtype)

    tlayers.dense = spy
    try:
        with torch.no_grad():
            net(torch.randn(2, 16, 32, 3, generator=torch.Generator().manual_seed(1)),
                rng=torch.Generator().manual_seed(2))
    finally:
        tlayers.dense = orig
    h = seen[0]
    assert binomial_ok(int((h != 0).sum()), h.numel(), 0.7)


EVAL_CONFIGS = {
    "plain": dataclasses.replace(KERNELS, use_pallas=False, pallas_grid_mlp=False,
                                 fuse_inner_mlp=False),
    # the kernels whose JAX gates do not depend on the rates: all of them stay on
    "kernels": dataclasses.replace(KERNELS, fuse_inner_mlp=False, fuse_decoder_tail=False),
}


@pytest.mark.parametrize("name", sorted(EVAL_CONFIGS))
def test_eval_forward_bit_identical_with_rates_set(name):
    cfg = EVAL_CONFIGS[name]
    x, sst = (torch.from_numpy(a) for a in inputs(cfg, seed=3))
    base = FourierNeuralOperatorNetFilmed(cfg, device="cpu", seed=1)
    rated = FourierNeuralOperatorNetFilmed(
        dataclasses.replace(cfg, drop_rate=0.2, drop_path_rate=0.2,
                            film=dataclasses.replace(cfg.film, dropout=0.2)),
        device="cpu", seed=1)
    with torch.no_grad():
        a, b = base(x, sst, 0.7), rated(x, sst, 0.7)
        c = rated(x, sst, 0.7, rng=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
    assert not torch.equal(b, c)  # training does drop


def test_training_forward_reproducible_from_the_generator():
    cfg = dataclasses.replace(KERNELS, drop_rate=0.2, drop_path_rate=0.2)
    net = FourierNeuralOperatorNetFilmed(cfg, device="cpu", seed=1)
    # 4 samples: drop-path draws a sample's blocks on their own
    x, sst = (torch.from_numpy(a) for a in inputs(cfg, seed=4, batch=4))
    with torch.no_grad():
        a = net(x, sst, rng=torch.Generator().manual_seed(5))
        b = net(x, sst, rng=torch.Generator().manual_seed(5))
        c = net(x, sst, rng=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)


# ----------------------------------------------------------- kernel gates

# (package, module, function) of each kernel wrapper the nets reach
PORT_WRAPPERS = {
    "spectral_mlp": (tlayers, "spectral_mlp"),
    "grid_mlp": (tlayers, "grid_mlp"),
    "grid_encoder_spectral": (tlayers.enc_kernel, "grid_encoder_spectral"),
    "spectral_decoder": (tlayers.dec_kernel, "spectral_decoder"),
}
JAX_WRAPPERS = {
    "spectral_mlp": ("msfno_tpu.ops.pallas.spectral_mlp", "spectral_mlp"),
    "grid_mlp": ("msfno_tpu.ops.pallas.grid_mlp", "grid_mlp"),
    "grid_encoder_spectral": ("msfno_tpu.ops.pallas.grid_mlp", "grid_encoder_spectral"),
    "spectral_decoder": ("msfno_tpu.ops.pallas.spectral_decoder", "spectral_decoder"),
}


def counting(monkeypatch, targets):
    """Wrap each target function with a counter of its calls (and, for
    grid_mlp, of the calls that fold an affine)."""
    counts = {name: 0 for name in targets}
    counts["grid_mlp/affine"] = 0
    for name, (mod, attr) in targets.items():
        mod = importlib.import_module(mod) if isinstance(mod, str) else mod
        fn = getattr(mod, attr)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            if _name == "grid_mlp" and kw.get("affine") is not None:
                counts["grid_mlp/affine"] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, attr, wrapped)
    return counts


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("rates", RATES)
def test_kernel_gates_follow_jax(monkeypatch, rates, training):
    drop_rate, drop_path_rate = rates
    cfg = dataclasses.replace(KERNELS, drop_rate=drop_rate, drop_path_rate=drop_path_rate)
    x, sst = inputs(cfg, seed=5)
    # JAX: the wrappers each traced call of the forward reaches
    jnet = JNet(jcfg.from_json(tcfg.to_json(cfg)))
    params = jax.eval_shape(lambda: jnet.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                              jnp.asarray(sst)))
    jcounts = counting(monkeypatch, JAX_WRAPPERS)
    rngs = ({"dropout": jax.random.PRNGKey(1), "droppath": jax.random.PRNGKey(2)}
            if training else None)
    jax.eval_shape(lambda p: jnet.apply(p, jnp.asarray(x), jnp.asarray(sst), 1.0,
                                        deterministic=not training, rngs=rngs), params)
    # the port: the wrappers one forward calls
    net = FourierNeuralOperatorNetFilmed(cfg, device="cpu", seed=0)
    tcounts = counting(monkeypatch, PORT_WRAPPERS)
    with torch.no_grad():
        net(torch.from_numpy(x), torch.from_numpy(sst), 1.0,
            rng=torch.Generator().manual_seed(0) if training else None)
    assert tcounts == jcounts
    if not training:  # every kernel stays on (the tail's gate is the rate's own)
        assert tcounts["spectral_mlp"] == cfg.num_layers
        assert tcounts["grid_encoder_spectral"] == 1
        assert tcounts["spectral_decoder"] == int(drop_path_rate == 0.0)
    if training and drop_rate:
        assert tcounts["spectral_mlp"] == 0


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("gen", ["gcn", "gcn_custom"])
def test_film_dropout_is_a_noop_for_gcn_generators(gen):
    """film.dropout is accepted for the GCN generators and, as in JAX, changes
    nothing: one step's loss equals JAX's and the dropout-free trainer's."""
    cfg = dataclasses.replace(CFG, film=dataclasses.replace(CFG.film, film_gen_type=gen,
                                                            dropout=0.3))
    jt, js, pt, ps = pair(cfg, jcfg.TrainConfig(film_scale_start=1.0))
    free = TTrainer(dataclasses.replace(pt.cfg, film=dataclasses.replace(pt.cfg.film,
                                                                         dropout=0.0)),
                    pt.tcfg, device="cpu")
    free.model.load_state_dict(pt.model.state_dict())
    pf = free.init_state()
    batch = gen_batch(cfg, 1, 0, seed=8)
    _, jm = jt._train_step(js, jnp.asarray(batch.era5), jnp.asarray(batch.sst))
    _, pm = pt._train_step(ps, *pt._device_batch(batch))
    _, mf = free._train_step(pf, *free._device_batch(batch))
    err = abs(float(pm["loss"]) - float(jm["loss"])) / float(jm["loss"])
    assert report(f"film.dropout {gen} loss", err) <= 1e-5
    assert float(pm["loss"]) == float(mf["loss"])


def test_trainer_trains_with_dropout_and_drop_path():
    cfg = dataclasses.replace(from_json(jcfg.to_json(CFG)), drop_rate=0.1, drop_path_rate=0.2)
    tc = tcfg.TrainConfig(film_scale_start=1.0, seed=3)
    a, b = TTrainer(cfg, tc, device="cpu"), TTrainer(cfg, tc, device="cpu")
    b.model.load_state_dict(a.model.state_dict())
    sa, sb = a.init_state(), b.init_state()
    batches = [gen_batch(CFG, 1, 0, seed=20 + i) for i in range(2)]
    losses = []
    for batch in batches:
        sa, ma = a._train_step(sa, *a._device_batch(batch))
        sb, mb = b._train_step(sb, *b._device_batch(batch))
        assert np.isfinite(float(ma["loss"])) and np.isfinite(float(ma["grad_norm"]))
        assert float(ma["loss"]) == float(mb["loss"])  # the same seed and step
        losses.append(float(ma["loss"]))
    # the masks are drawn: the loss differs from the deterministic forward's
    with torch.no_grad():
        e, s = a._device_batch(batches[0])
        det = float(a._rollout_loss(e, s, 1.0)[0])
        drawn = float(a._rollout_loss(e, s, 1.0, a._train_rng(7))[0])
    assert det != drawn
    a.train(sa, loader=[batches[0]], val_loader=lambda: iter(batches))
    assert sa.step == 3
