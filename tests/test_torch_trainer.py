"""The fine-tune slice as a whole: the PyTorch port's Trainer against the JAX
package's at `small_cfg(film=True)` (tests/test_training.py), both starting
from the JAX trainer's `init_state`, plus the port trainer's own contract:
frozen weights, `train_steps`, bf16 frozen storage, the kernels' operand
cache, checkpoints and resume, validation and its film-scale ramp, the loop's
cadence and the time-limit stop."""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from msfno_torch.config import TrainConfig as TTrainConfig
from msfno_torch.config import from_json
from msfno_torch.convert import from_flax_params, from_flax_train_state
from msfno_torch.runtime import DerivedCache
from msfno_torch.training import checkpoint as tckpt
from msfno_torch.training.trainer import Trainer as TTrainer
from msfno_tpu.data.synthetic import gen_batch, synthetic_loader
from msfno_tpu.training.partition import merge_params
from msfno_tpu.training.trainer import Trainer as JTrainer
from msfno_tpu.utils.config import TrainConfig, to_json
from tests.test_training import small_cfg

torch.set_num_threads(2)


def report(name, value):
    """The measured error, for the parity table (pytest -s shows it)."""
    print(f"parity {name} rel_l2={value:.3e}")
    return value


def tree_rel(port: dict, jax_tree) -> float:
    """rel-L2 over every parameter of a JAX tree, matched by name."""
    ref = from_flax_params(jax.tree_util.tree_map(np.asarray, jax_tree))
    num = sum(float(((port[k].detach().double() - ref[k].double()) ** 2).sum()) for k in ref)
    den = sum(float((ref[k].double() ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


def pair(model_cfg, train_cfg):
    """A JAX trainer and state, and the port trainer started from the same
    state (the JSON configs carried across, weights by name)."""
    jt = JTrainer(model_cfg, train_cfg)
    js = jt.init_state()
    pt = TTrainer(from_json(to_json(model_cfg)), from_json(to_json(train_cfg)), device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pt.model.load_state_dict(from_flax_train_state(np_tree(js.trainable), np_tree(js.frozen)))
    return jt, js, pt, pt.init_state()


def jax_loss_and_grads(jt, js, era5, sst):
    def loss_fn(trainable):
        params = merge_params(trainable, js.frozen)
        return jt._rollout_loss(params, era5, sst, js.film_scale)[0]

    return jax.jit(jax.value_and_grad(loss_fn))(js.trainable)


CFG = small_cfg(film=True)
TCFG = TrainConfig(film_scale_start=0.8)


@pytest.fixture(scope="module")
def trained():
    """One step of both trainers on one batch, with the film gradient."""
    jt, js, pt, ps = pair(CFG, TCFG)
    batch = gen_batch(CFG, 1, 0, seed=3)
    era5, sst = jnp.asarray(batch.era5), jnp.asarray(batch.sst)
    jl, jg = jax_loss_and_grads(jt, js, era5, sst)
    e, s = pt._device_batch(batch)
    pl, _, pg = pt.loss_and_grads(ps, e, s)
    frozen0 = {k: v.detach().clone() for k, v in ps.frozen.items()}
    js1, jm = jt._train_step(js, era5, sst)
    ps1, pm = pt._train_step(ps, e, s)
    return dict(jl=jl, jg=jg, pl=pl, pg=pg, js1=js1, jm=jm, ps1=ps1, pm=pm, pt=pt,
                frozen0=frozen0)


def test_train_step_matches_jax(trained):
    t = trained
    assert report("trainer loss", abs(float(t["pl"]) - float(t["jl"])) / float(t["jl"])) <= 1e-5
    assert report("trainer film grad", tree_rel(t["pg"], t["jg"])) <= 1e-4
    assert report("trainer updated trainable", tree_rel(t["ps1"].trainable,
                                                        t["js1"].trainable)) <= 1e-4
    assert float(t["pm"]["grad_norm"]) == pytest.approx(float(t["jm"]["grad_norm"]), rel=1e-4)
    assert t["ps1"].step == 1 and set(t["pg"]) == set(t["ps1"].trainable)
    assert all(k.startswith("film_gen.") for k in t["ps1"].trainable)


def test_frozen_params_unchanged(trained):
    ps = trained["ps1"]
    assert ps.frozen and all(not p.requires_grad for p in ps.frozen.values())
    for k, p in ps.frozen.items():
        assert torch.equal(p, trained["frozen0"][k]), k


def _port_trainer(tcfg, seed_state=None):
    pt = TTrainer(from_json(to_json(CFG)), tcfg, device="cpu")
    if seed_state is not None:
        pt.model.load_state_dict(seed_state)
    return pt, pt.init_state()


def test_train_steps_equals_single_steps():
    tcfg = from_json(to_json(TCFG))
    a, sa = _port_trainer(tcfg)
    b, sb = _port_trainer(tcfg, a.model.state_dict())
    batches = [gen_batch(CFG, 1, 0, seed=20 + i) for i in range(3)]
    era5, sst = a._device_chunk(batches)
    sa, ma = a.train_steps(sa, era5, sst)
    losses = []
    for batch in batches:
        sb, m = b._train_step(sb, *b._device_batch(batch))
        losses.append(float(m["loss"]))
    assert sa.step == sb.step == 3
    assert ma["loss"].shape == (3,) and ma["loss"].tolist() == losses
    for k in sa.trainable:
        assert torch.equal(sa.trainable[k], sb.trainable[k]), k


def test_bf16_frozen_params_keep_film_fp32():
    pt, ps = _port_trainer(dataclasses.replace(from_json(to_json(TCFG)),
                                               bf16_frozen_params=True))
    assert all(p.dtype == torch.bfloat16 for p in ps.frozen.values())
    assert all(p.dtype == torch.float32 for p in ps.trainable.values())
    ps, m = pt._train_step(ps, *pt._device_batch(gen_batch(CFG, 1, 0, seed=4)))
    assert np.isfinite(float(m["loss"]))
    assert all(p.dtype == torch.float32 for p in ps.trainable.values())


def test_derived_cache_rebuilds_after_update():
    """The kernels' cached bf16 copy of a gcn weight follows the optimizer's
    in-place update."""
    pt, ps = _port_trainer(from_json(to_json(TCFG)))
    w = pt.model.film_gen.film_gen.conv_0.weight
    cache = DerivedCache()
    build = lambda: w.to(torch.bfloat16)  # noqa: E731
    before = cache.get("w", (w,), build)
    assert cache.get("w", (w,), build) is before
    pt._train_step(ps, *pt._device_batch(gen_batch(CFG, 1, 0, seed=5)))
    after = cache.get("w", (w,), build)
    assert after is not before and torch.equal(after, w.detach().to(torch.bfloat16))
    assert not torch.equal(after, before)


def test_checkpoint_round_trip_and_resume(tmp_path):
    tcfg = from_json(to_json(TCFG))
    a, sa = _port_trainer(tcfg)
    a.checkpoint_dir = str(tmp_path)
    batches = [gen_batch(CFG, 1, 0, seed=30 + i) for i in range(2)]
    sa, _ = a._train_step(sa, *a._device_batch(batches[0]))
    a.iter, a.epoch = 1, 0
    path = a.save_checkpoint(sa)
    meta = tckpt.peek(path)
    assert (meta["step"], meta["epoch"], meta["film_scale"]) == (1, 0, pytest.approx(0.8))
    assert from_json(meta["config"]) == a.cfg
    b, sb = _port_trainer(tcfg)
    sb = b.restore(sb, path, resume_optimizer=True)
    assert (sb.step, b.iter, b.start_epoch) == (1, 1, 1)
    for k, p in sa.params.items():
        assert torch.equal(p, dict(b.model.named_parameters())[k]), k
    sa, ma = a._train_step(sa, *a._device_batch(batches[1]))
    sb, mb = b._train_step(sb, *b._device_batch(batches[1]))
    assert float(ma["loss"]) == float(mb["loss"])
    for k in sa.trainable:
        assert torch.equal(sa.trainable[k], sb.trainable[k]), k


def test_jax_npz_checkpoint_params_load(tmp_path, trained):
    """A JAX-written .npz training checkpoint: its parameters load by name;
    its optax state needs the train config that orders its leaves
    (tests/test_torch_checkpoint_optax.py resumes from it); Orbax
    directories raise."""
    from msfno_tpu.training import checkpoint as jckpt

    js1 = trained["js1"]
    path = os.path.join(tmp_path, "jax.npz")
    jckpt.save_checkpoint(path, js1.params, opt_state=js1.opt_state, step=1, epoch=0,
                          config_json=to_json(CFG), extra={"film_scale": 0.8})
    params, opt, meta = tckpt.load_checkpoint(path)
    assert opt is None and meta["step"] == 1 and tckpt.peek(path)["step"] == 1
    ref = from_flax_params(jax.tree_util.tree_map(np.asarray, js1.params))
    assert set(params) == set(ref) and all(torch.equal(params[k], ref[k]) for k in ref)
    with pytest.raises(ValueError, match="train_cfg"):
        tckpt.load_checkpoint(path, with_opt_state=True)
    _, opt, _ = tckpt.load_checkpoint(path, with_opt_state=True,
                                      train_cfg=from_json(to_json(TCFG)))
    assert opt["inner"]["count"] == 1 and set(opt["inner"]["mu"]) == set(trained["ps1"].trainable)
    with pytest.raises(NotImplementedError, match="imports jax"):
        tckpt.load_checkpoint(str(tmp_path))
    merged = tckpt.merge_film_checkpoint(ref, {"film_gen.film_gen.conv1.bias": 0})
    assert merged["film_gen.film_gen.conv1.bias"] == 0 and len(merged) == len(ref)


def test_validation_and_film_scale_ramp():
    tcfg = dataclasses.replace(from_json(to_json(TCFG)), film_scale_start=0.5,
                               film_scale_step=0.3)
    pt, ps = _port_trainer(tcfg)
    ps = pt.validation(ps)
    rec = pt.writer.records[-1]
    assert ps.film_scale == pytest.approx(0.8)
    assert {"validation loss step=0", "MSE var0 step=0", "gamma mean", "beta mean"} <= set(rec)
    assert all(np.isfinite(v) for v in rec.values())
    ps = pt.validation(ps)
    assert ps.film_scale == 1.0


def test_train_loop_cadence_and_chunks(tmp_path):
    """train() with validation every 3 steps logs the same losses whether it
    chunks 2 steps at a time or runs them singly, and checkpoints each
    validation and epoch."""
    logs = {}
    for k in (1, 2):
        tcfg = dataclasses.replace(from_json(to_json(TCFG)), scan_steps=k,
                                   validation_interval=3, training_epochs=1)
        pt, ps = _port_trainer(tcfg)
        pt.model.load_state_dict(_port_trainer(tcfg)[0].model.state_dict())
        pt.checkpoint_dir = str(tmp_path / f"k{k}")
        ps = pt.train(ps, num_batches=4)
        assert ps.step == 4 and pt.iter == 4
        logs[k] = [(r.get("_step"), r.get("loss")) for r in pt.writer.records if "loss" in r]
        names = sorted(os.listdir(pt.checkpoint_dir))
        assert names == ["checkpoint_iter=3_epoch=0.pt", "checkpoint_iter=4_epoch=0.pt"]
    assert [s for s, _ in logs[1]] == [1, 2, 3, 4]
    assert logs[1] == logs[2]


def test_time_limit_stops_training(tmp_path):
    tcfg = dataclasses.replace(from_json(to_json(TCFG)), time_limit_s=1e-3)
    pt, ps = _port_trainer(tcfg)
    pt.checkpoint_dir = str(tmp_path)
    ps = pt.train(ps, num_batches=3)
    assert ps.step == 0
    assert os.listdir(tmp_path) == ["checkpoint_iter=0_epoch=0.pt"]


def test_gen_batch_matches_jax():
    """The port's synthetic batches are the JAX package's, array for array."""
    from msfno_torch.data import synthetic as tsyn

    for ms in (0, 1):
        a, b = gen_batch(CFG, 2, ms, seed=9), tsyn.gen_batch(from_json(to_json(CFG)), 2, ms, seed=9)
        for k in ("era5", "sst", "times"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    pairs = zip(synthetic_loader(CFG, 1, 0, 2, seed=3),
                tsyn.synthetic_loader(from_json(to_json(CFG)), 1, 0, 2, seed=3))
    for a, b in pairs:
        np.testing.assert_array_equal(a.sst, b.sst)


def test_unported_options_raise():
    # a data-only mesh is ported (tests/test_torch_distributed.py); the lat
    # and channel axes are not
    lat_mesh = types.SimpleNamespace(mesh_dim_names=("data", "lat", "channel"), shape=(1, 2, 1))
    with pytest.raises(NotImplementedError):
        TTrainer(from_json(to_json(CFG)), TTrainConfig(), device="cpu", mesh=lat_mesh)
    # dropout and drop-path are ported (tests/test_torch_dropout.py), and the
    # ViT's and the MAE's film.dropout (tests/test_torch_vit.py, below)
    # the spectral losses are ported (tests/test_torch_trainer_spectral_loss.py)
    TTrainer(from_json(to_json(CFG)), TTrainConfig(loss_fn="SpectralL2Sphere"), device="cpu")


def test_mae_film_dropout_draws_from_the_step_generator():
    """film.dropout with the MAE generator: the Trainer accepts it, an eval
    forward is the no-dropout net's bit for bit, a forward given a
    generator draws its masks from it (the same seed, the same output), and
    a train step runs."""
    from msfno_torch.models import FourierNeuralOperatorNetFilmed

    def mae(dropout):
        cfg = from_json(to_json(CFG))
        return dataclasses.replace(cfg, film=dataclasses.replace(
            cfg.film, film_gen_type="mae", dropout=dropout))

    pt = TTrainer(mae(0.3), TTrainConfig(film_scale_start=0.8), device="cpu")
    assert pt._has_dropout
    plain = FourierNeuralOperatorNetFilmed(mae(0.0), device="cpu")
    plain.load_state_dict(pt.model.state_dict())
    batch = gen_batch(CFG, 1, 0, seed=7)
    x, sst = torch.from_numpy(batch.era5[0]), torch.from_numpy(batch.sst[1])
    with torch.no_grad():
        a, b = pt.model(x, sst, 0.8), plain(x, sst, 0.8)
        c = pt.model(x, sst, 0.8, rng=pt._train_rng(0))
        d = pt.model(x, sst, 0.8, rng=pt._train_rng(0))
    assert torch.equal(a, b) and torch.equal(c, d) and not torch.equal(a, c)
    ps = pt.init_state()
    ps, m = pt._train_step(ps, *pt._device_batch(batch))
    assert np.isfinite(float(m["loss"])) and ps.step == 1
