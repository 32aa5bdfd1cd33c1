"""Optimizers and schedules (port of msfno_tpu/training/optim.py:16-72;
reference Trainer.create_optimizer / create_scheduler, train.py:382-431).

Written by hand to follow optax's formulas step for step: `adam` and
`adamw` (scale_by_adam with b1 0.9, b2 0.999, eps 1e-8, then the decayed
weights for adamw), `sgd` with momentum 0.9 (optax `trace`), the learning
rate as `-lr(count)` from a schedule count that advances once per applied
update, and `MultiSteps` accumulation (the mean of accumulation_steps + 1
micro-step gradients, one update every accumulation_steps + 1 calls).  The
update is applied to the parameters in place, and the state's moments are
updated in place: no second copy of either is held.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8
MOMENTUM = 0.9


def create_schedule(cfg) -> Callable[[int], float]:
    """The learning rate at a schedule count: none, cosine
    (optax.cosine_decay_schedule over scheduler_horizon) or step (staircase
    optax.exponential_decay, x0.1 every scheduler_horizon // 3)."""
    lr = cfg.learning_rate
    if cfg.scheduler == "none":
        return lambda count: lr
    if cfg.scheduler == "cosine":
        steps = max(cfg.scheduler_horizon, 1)
        return lambda count: lr * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
    if cfg.scheduler == "step":
        period = max(cfg.scheduler_horizon // 3, 1)
        return lambda count: lr if count <= 0 else lr * 0.1 ** math.floor(count / period)
    raise ValueError(f"unknown scheduler {cfg.scheduler!r}")


class Optimizer:
    """The optimizer of a TrainConfig over a dict of named parameters.

    `init(params)` returns the state, a dict of ints and tensors;
    `step(params, grads, state)` applies one update in place and returns the
    state.  With accumulation_steps > 0 the gradients of accumulation_steps
    + 1 calls are averaged (Welford, as optax.MultiSteps does) and only
    every accumulation_steps + 1-th call changes the parameters."""

    def __init__(self, cfg):
        if cfg.optimizer not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.kind = cfg.optimizer
        self.weight_decay = cfg.weight_decay
        self.schedule = create_schedule(cfg)
        self.every = cfg.accumulation_steps + 1

    def init(self, params: dict) -> dict:
        zeros = lambda: {n: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                         for n, p in params.items()}
        inner = {"sched_count": 0}
        if self.kind == "sgd":
            inner["trace"] = zeros()
        else:
            inner.update(count=0, mu=zeros(), nu=zeros())
        state = {"inner": inner}
        if self.every > 1:
            state.update(mini_step=0, gradient_step=0, acc=zeros())
        return state

    @torch.no_grad()
    def _apply(self, params: dict, grads: dict, inner: dict) -> None:
        lr = self.schedule(inner["sched_count"])
        inner["sched_count"] += 1
        if self.kind == "sgd":
            for n, p in params.items():
                t = inner["trace"][n]
                t.mul_(MOMENTUM).add_(grads[n])  # g + 0.9 * trace
                p.add_(t, alpha=-lr)
            return
        inner["count"] += 1
        c1 = 1.0 - B1 ** inner["count"]
        c2 = 1.0 - B2 ** inner["count"]
        for n, p in params.items():
            g = grads[n].float()
            mu, nu = inner["mu"][n], inner["nu"][n]
            mu.mul_(B1).add_((1.0 - B1) * g)
            nu.mul_(B2).add_((1.0 - B2) * g * g)
            upd = (mu / c1) / (torch.sqrt(nu / c2) + EPS)
            if self.kind == "adamw":
                upd = upd + self.weight_decay * p.float()
            p.add_((-lr * upd).to(p.dtype))

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict) -> dict:
        if self.every == 1:
            self._apply(params, grads, state["inner"])
            return state
        k = state["mini_step"]
        for n, a in state["acc"].items():
            a.add_((grads[n].float() - a) / (k + 1))
        if k == self.every - 1:
            self._apply(params, state["acc"], state["inner"])
            for a in state["acc"].values():
                a.zero_()
            state["gradient_step"] += 1
        state["mini_step"] = (k + 1) % self.every
        return state


def create_optimizer(cfg) -> Optimizer:
    return Optimizer(cfg)


def fast_forward_schedule(state: dict, step: int) -> dict:
    """Set only the schedule's position to `step` (reference train.py:428-431
    restores just the scheduler); Adam's bias-correction count stays."""
    state["inner"]["sched_count"] = int(step)
    return state
