"""Resume from a JAX-written `.npz` with its optax state: for every chain
that `msfno_tpu.training.optim.create_optimizer` builds (adam / adamw / sgd
with momentum, schedule none / cosine / step, accumulation_steps 0 and 2 as
`optax.MultiSteps`), the JAX trainer's step takes 2 steps and saves with its
optimizer state; the port's `Trainer.restore(..., resume_optimizer=True)`
maps the leaves onto its `Optimizer` state (held field by field against the
optax NamedTuples) and takes step 3, which must land within 1e-6 (rel-L2
over the trainable parameters) of the JAX trainer's step 3."""

import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msfno_torch.config import from_json
from msfno_torch.convert import from_flax_params, from_flax_train_state
from msfno_torch.training import checkpoint as tckpt
from msfno_torch.training.trainer import Trainer as TTrainer
from msfno_tpu.data.synthetic import gen_batch
from msfno_tpu.training import checkpoint as jckpt
from msfno_tpu.training.optim import create_optimizer
from msfno_tpu.training.partition import merge_params
from msfno_tpu.training.trainer import Trainer as JTrainer
from msfno_tpu.utils.config import TrainConfig, to_json
from tests.test_training import small_cfg

torch.set_num_threads(2)

CFG = small_cfg(film=True)
CHAINS = list(itertools.product(("adam", "adamw", "sgd"), ("none", "cosine", "step"), (0, 2)))
TOL = 1e-6
# retrain_film also trains the decoder and the last block, whose port and
# JAX gradients differ more than the generator's; Adam's per-element
# normalisation carries that into the update at lr 1e-2
RETRAIN_TOL = 1e-5
# step 3's update alone: Adam moves an element whose gradient is rounding
# noise by a full lr, whatever the noise's size
UPDATE_TOL = 1e-2


def report(name, value):
    print(f"parity {name} rel_l2={value:.3e}")
    return value


def _tc(opt="adam", sched="none", acc=0, **kw):
    # a short schedule horizon, so that steps 1-3 sit at different rates
    return TrainConfig(optimizer=opt, scheduler=sched, accumulation_steps=acc,
                       scheduler_horizon=6, learning_rate=1e-2, weight_decay=0.1,
                       film_scale_start=0.8, **kw)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _Jax:
    """The JAX trainer's train step, its gradient compiled once for every
    chain: `Trainer._train_step_impl`'s value_and_grad of `_rollout_loss`,
    then `tx.update` and `optax.apply_updates` of the chain's own `tx`."""

    def __init__(self, retrain_film=False):
        self.jt = JTrainer(CFG, _tc(retrain_film=retrain_film))
        self.state = self.jt.init_state()
        jt = self.jt

        def loss(trainable, frozen, era5, sst, scale):
            return jt._rollout_loss(merge_params(trainable, frozen), era5, sst, scale)[0]

        self.grad = jax.jit(jax.grad(loss))
        self.batches = [gen_batch(CFG, 1, 0, seed=40 + i) for i in range(3)]

    def step(self, tx, trainable, opt_state, batch):
        g = self.grad(trainable, self.state.frozen, jnp.asarray(batch.era5),
                      jnp.asarray(batch.sst), self.state.film_scale)
        updates, opt_state = tx.update(g, opt_state, trainable)
        return optax.apply_updates(trainable, updates), opt_state


@pytest.fixture(scope="module")
def jax_steps():
    return {False: _Jax(False), True: _Jax(True)}


def _expected_port_state(opt_state, tcfg):
    """The optax state read by attribute name (not by leaf order) and put in
    the port's `Optimizer` state layout."""
    to_port = lambda t: from_flax_params(_np(t))  # noqa: E731
    multi = tcfg.accumulation_steps > 0
    chain = opt_state.inner_opt_state if multi else opt_state
    first, sched = chain[0], chain[-1]
    inner = {}
    if tcfg.optimizer == "sgd":
        inner["trace"] = to_port(first.trace)
    else:
        inner.update(count=int(first.count), mu=to_port(first.mu), nu=to_port(first.nu))
    if isinstance(sched, optax.ScaleByScheduleState):
        inner["sched_count"] = int(sched.count)
    out = {"inner": inner}
    if multi:
        out.update(mini_step=int(opt_state.mini_step),
                   gradient_step=int(opt_state.gradient_step),
                   acc=to_port(opt_state.acc_grads))
    return out


def _assert_state_equal(got, want, where=""):
    if isinstance(want, dict):
        for k, v in want.items():
            _assert_state_equal(got[k], v, f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert torch.equal(got, want), where
    else:
        assert got == want, where


def _tree_rel(port: dict, jax_tree) -> float:
    ref = from_flax_params(_np(jax_tree))
    num = sum(float(((port[k].detach().double() - ref[k].double()) ** 2).sum()) for k in ref)
    den = sum(float((ref[k].double() ** 2).sum()) for k in ref)
    return (num / den) ** 0.5


def _save_after_two_steps(js, tcfg, path):
    tx = create_optimizer(tcfg)
    trainable, opt_state = js.state.trainable, tx.init(js.state.trainable)
    for batch in js.batches[:2]:
        trainable, opt_state = js.step(tx, trainable, opt_state, batch)
    jckpt.save_checkpoint(path, merge_params(trainable, js.state.frozen), opt_state=opt_state,
                          step=2, epoch=0, config_json=to_json(CFG),
                          extra={"film_scale": 0.8})
    return tx, trainable, opt_state


@pytest.mark.parametrize("opt,sched,acc", CHAINS)
def test_resume_jax_optimizer_state(jax_steps, tmp_path, opt, sched, acc):
    _resume_case(jax_steps[False], tmp_path, _tc(opt, sched, acc))


@pytest.mark.parametrize("opt,sched,acc", [("adamw", "step", 0), ("sgd", "cosine", 2)])
def test_resume_jax_optimizer_state_retrain_film(jax_steps, tmp_path, opt, sched, acc):
    """retrain_film: the decoder and the last block train too, so the
    trainable leaves interleave film_gen, decoder and blocks_1 in sorted
    order."""
    _resume_case(jax_steps[True], tmp_path, _tc(opt, sched, acc, retrain_film=True),
                 tol=RETRAIN_TOL)


def _resume_case(js, tmp_path, tcfg, tol=TOL):
    path = os.path.join(tmp_path, "jax.npz")
    tx, trainable, opt_state = _save_after_two_steps(js, tcfg, path)
    want_state = _expected_port_state(opt_state, tcfg)
    trainable3, _ = js.step(tx, trainable, opt_state, js.batches[2])
    step3 = jax.tree_util.tree_map(lambda a, b: a - b, trainable3, trainable)

    pt = TTrainer(from_json(to_json(CFG)), from_json(to_json(tcfg)), device="cpu")
    pt.model.load_state_dict(from_flax_train_state(_np(js.state.trainable),
                                                   _np(js.state.frozen)))
    ps = pt.restore(pt.init_state(), path, resume_optimizer=True)
    assert (ps.step, pt.iter) == (2, 2)
    _assert_state_equal(ps.opt_state, want_state)
    before = {k: p.detach().clone() for k, p in ps.trainable.items()}
    ps, _ = pt._train_step(ps, *pt._device_batch(js.batches[2]))
    name = f"optax resume {tcfg.optimizer}/{tcfg.scheduler}/acc={tcfg.accumulation_steps}" \
           f"{'/retrain_film' if tcfg.retrain_film else ''} step 3"
    assert report(name, _tree_rel(ps.trainable, trainable3)) <= tol
    # the update itself: without the optimizer state the same step moves the
    # parameters elsewhere
    moved = {k: p.detach() - before[k] for k, p in ps.trainable.items()}
    err = report(name + " update", _tree_rel(moved, step3))
    pt2 = TTrainer(from_json(to_json(CFG)), from_json(to_json(tcfg)), device="cpu")
    ps2 = pt2.restore(pt2.init_state(), path)
    ps2, _ = pt2._train_step(ps2, *pt2._device_batch(js.batches[2]))
    fresh = _tree_rel({k: p.detach() - before[k] for k, p in ps2.trainable.items()}, step3)
    print(f"parity {name} update without the optimizer state rel_l2={fresh:.3e}")
    assert err <= UPDATE_TOL and fresh > 10 * err, (err, fresh)


def test_leaf_order_needs_the_right_chain(jax_steps, tmp_path):
    """The leaves carry no structure: a train config whose chain differs
    from the one that wrote the file, or an unknown chain, raises instead of
    mapping leaves to the wrong moments; so does a missing train config."""
    path = os.path.join(tmp_path, "jax.npz")
    _save_after_two_steps(jax_steps[False], _tc("adam", "cosine", 0), path)
    for wrong in (_tc("adam", "none", 0), _tc("sgd", "cosine", 0), _tc("adam", "cosine", 2)):
        with pytest.raises(ValueError, match="optax state"):
            tckpt.load_checkpoint(path, with_opt_state=True,
                                  train_cfg=from_json(to_json(wrong)))
    with pytest.raises(ValueError, match="no optax chain"):
        tckpt.load_checkpoint(path, with_opt_state=True,
                              train_cfg=dataclasses.replace(_tc(), optimizer="lamb"))
    with pytest.raises(ValueError, match="train_cfg"):
        tckpt.load_checkpoint(path, with_opt_state=True)
    params, opt, meta = tckpt.load_checkpoint(path)
    assert opt is None and meta["step"] == 2 and params
