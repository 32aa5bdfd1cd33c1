"""The port's optimizers against optax, step for step: the same gradients
(numpy, from a seed) through `msfno_torch.training.optim` and through the
JAX package's `create_optimizer`, for each optimizer, schedule and
gradient accumulation."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from msfno_torch.config import TrainConfig as TTrainConfig
from msfno_torch.training import optim as to
from msfno_tpu.training import optim as jo
from msfno_tpu.utils.config import TrainConfig

torch.set_num_threads(2)

CASES = {
    "adam": dict(),
    "adamw": dict(optimizer="adamw", weight_decay=0.05),
    "sgd": dict(optimizer="sgd"),
    "cosine": dict(scheduler="cosine", scheduler_horizon=4),
    "step": dict(scheduler="step", scheduler_horizon=6),
    "accumulation 2": dict(accumulation_steps=2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_optimizer_matches_optax(case):
    kw = dict(learning_rate=1e-2, **CASES[case])
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    tx = jo.create_optimizer(TrainConfig(**kw))
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    sj = tx.init(pj)
    opt = to.create_optimizer(TTrainConfig(**kw))
    pt = {k: torch.tensor(v) for k, v in params.items()}
    st = opt.init(pt)
    for step in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
        upd, sj = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, sj, pj)
        pj = optax.apply_updates(pj, upd)
        st = opt.step(pt, {k: torch.from_numpy(v) for k, v in grads.items()}, st)
        for k in params:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-6, atol=1e-6,
                                       err_msg=f"{case} step {step} {k}")


def test_fast_forward_moves_only_the_schedule():
    cfg = TTrainConfig(scheduler="cosine", scheduler_horizon=10)
    opt = to.create_optimizer(cfg)
    st = opt.init({"a": torch.zeros(2)})
    st = to.fast_forward_schedule(st, 7)
    assert st["inner"]["sched_count"] == 7 and st["inner"]["count"] == 0
    jst = jo.fast_forward_schedule(jo.create_optimizer(
        TrainConfig(scheduler="cosine", scheduler_horizon=10)).init({"a": jnp.zeros(2)}), 7)
    counts = [int(n.count) for n in jax.tree_util.tree_leaves(
        jst, is_leaf=lambda n: isinstance(n, optax.ScaleByScheduleState))
        if isinstance(n, optax.ScaleByScheduleState)]
    assert counts == [7]


def test_unknown_optimizer_and_scheduler_raise():
    with pytest.raises(ValueError):
        to.create_optimizer(dataclasses.replace(TTrainConfig(), optimizer="lion"))
    with pytest.raises(ValueError):
        to.create_optimizer(dataclasses.replace(TTrainConfig(), scheduler="poly"))
