"""Training orchestration (port of msfno_tpu/training/trainer.py:121-739;
reference Trainer, MSFNO/Models/train.py:35-1337).

One optimization step is the multi-step autoregressive rollout, the loss
with its discount and skip semantics, the gradient of the trainable
parameters (autograd through the kernels' backward Functions) and the
optimizer update, applied in place to the model's parameters.  The host
loop feeds batches and keeps the cadence: validation, checkpoints, the
film-scale ramp and the time-limit stop.  Method names are the JAX
package's, so each has its counterpart there; `TrainState` holds the
model's own Parameter objects, and a step updates it in place and returns
it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch

from msfno_torch.config import SFNOConfig, TrainConfig, to_json
from msfno_torch.data.normalization import Normalizer, SSTNormalizer
from msfno_torch.data.synthetic import Batch, gen_batch, synthetic_loader
from msfno_torch.models import FourierNeuralOperatorNet, FourierNeuralOperatorNetFilmed
from msfno_torch.runtime import resolve_device
from msfno_torch.training import checkpoint as ckpt_io
from msfno_torch.training.losses import get_loss
from msfno_torch.training.optim import create_optimizer, fast_forward_schedule
from msfno_torch.training.partition import count_params, film_trainable_predicate, split_params
from msfno_torch.utils.observability import FinTraining, LocalLog

log = logging.getLogger("msfno_torch")


@dataclasses.dataclass
class TrainState:
    """The trainer's state: name -> Parameter dicts of the model (trainable,
    frozen), the optimizer state, the step count and the FiLM scale."""

    trainable: dict
    frozen: dict
    opt_state: dict
    step: int
    film_scale: float

    @property
    def params(self) -> dict:
        return {**self.frozen, **self.trainable}


class Trainer:
    """Drives training and validation of SFNO and filmed-SFNO models on one
    device (CUDA unless `device="cpu"`)."""

    def __init__(self, model_cfg: SFNOConfig, train_cfg: TrainConfig,
                 normalizer: Normalizer | None = None,
                 sst_normalizer: SSTNormalizer | None = None,
                 writer: LocalLog | None = None, checkpoint_dir: str | None = None,
                 device=None, mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: multi-device training (DDP) comes in a later slice")
        film_drop = model_cfg.film.dropout if model_cfg.film is not None else 0.0
        if model_cfg.drop_rate > 0.0 or model_cfg.drop_path_rate > 0.0 or film_drop > 0.0:
            raise NotImplementedError(
                "dropout and drop-path come in a later slice; set drop_rate, "
                "drop_path_rate and film.dropout to 0")
        self.cfg = model_cfg
        self.tcfg = train_cfg
        self.device = resolve_device(device)
        self.filmed = model_cfg.film is not None
        net = FourierNeuralOperatorNetFilmed if self.filmed else FourierNeuralOperatorNet
        self.model = net(model_cfg, device=self.device, seed=train_cfg.seed)
        self.normalizer = normalizer or Normalizer.identity(model_cfg.in_chans)
        self.sst_normalizer = sst_normalizer or SSTNormalizer.identity()
        self.loss_fn = get_loss(train_cfg.loss_fn, model_cfg)
        self.tx = create_optimizer(train_cfg)
        self.writer = writer or LocalLog()
        self.checkpoint_dir = checkpoint_dir
        self.epoch = 0
        self.start_epoch = 0
        self.iter = 0
        self._start_time = time.time()

    # ------------------------------------------------------------- setup

    def init_state(self) -> TrainState:
        """Freeze the backbone (film-only, or with the decoder and last block
        under retrain_film), store it in bf16 with bf16_frozen_params, and
        start the optimizer on the trainable parameters.  Load weights into
        `self.model` first to start from them."""
        if self.filmed:
            pred = film_trainable_predicate(self.tcfg.retrain_film, self.cfg.num_layers)
            trainable, frozen = split_params(self.model, pred)
        else:
            trainable = dict(self.model.named_parameters())
            frozen = {}
            for p in trainable.values():
                p.requires_grad_(True)
        if self.tcfg.bf16_frozen_params and frozen:
            from msfno_torch.inference.rollout import serving_params

            serving_params(self.model, frozen_only=True)
        log.info("params: %d trainable / %d frozen", count_params(trainable),
                 count_params(frozen))
        return TrainState(trainable=trainable, frozen=frozen,
                          opt_state=self.tx.init(trainable), step=0,
                          film_scale=float(self.tcfg.film_scale_start))

    # -------------------------------------------------------- forward/loss

    def _apply(self, x, sst, scale):
        if self.filmed:
            return self.model(x, sst, scale)
        return self.model(x)

    def _device_batch(self, batch: Batch):
        era5 = torch.as_tensor(np.asarray(batch.era5), device=self.device)
        sst = (torch.as_tensor(np.asarray(batch.sst), device=self.device)
               if batch.sst is not None else None)
        return era5, sst

    def _rollout_loss(self, era5, sst, scale):
        """Multi-step autoregressive loss (reference train.py:146-197).

        era5: (S, B, H, W, C) raw; sst: (S, B, T, Hs, Ws) or None.
        loss = sum over scored steps of disc^step * L(out, gt) / (ms + 1).
        No 1/(acc + 1) factor: the optimizer averages micro-step gradients."""
        t = self.tcfg
        ms, skip = t.multi_step_training, t.training_step_skip
        inp = self.normalizer(era5[0].float())
        total, per_step = 0.0, []
        for step in range(ms + 1):
            sst_step = (self.sst_normalizer(sst[step + 1].float())
                        if sst is not None else None)
            out = self._apply(inp, sst_step, scale)
            if step % (skip + 1) == 0:
                gt = self.normalizer(era5[step + 1].float())
                loss = self.loss_fn(out, gt) / (ms + 1) * t.discount_factor ** step
                total = total + loss
                per_step.append(loss)
            inp = out
        return total, torch.stack(per_step)

    def loss_and_grads(self, state: TrainState, era5, sst):
        """(loss, per-step losses, name -> gradient of the trainable
        parameters) at the current parameters."""
        loss, per_step = self._rollout_loss(era5, sst, state.film_scale)
        names = list(state.trainable)
        grads = torch.autograd.grad(loss, [state.trainable[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(state.trainable[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return loss.detach(), per_step.detach(), grads

    def _train_step(self, state: TrainState, era5, sst):
        """One optimizer step on one batch; updates `state` in place and
        returns it with the step's metrics (device scalars)."""
        loss, per_step, grads = self.loss_and_grads(state, era5, sst)
        gnorm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        self.tx.step(state.trainable, grads, state.opt_state)
        state.step += 1
        return state, {"loss": loss, "per_step": per_step, "grad_norm": gnorm}

    def train_steps(self, state: TrainState, era5, sst=None):
        """K sequential optimizer steps: era5 (K, S, B, H, W, C), sst (K, S,
        B, T, Hs, Ws) or None.  The same as K `_train_step` calls; metrics
        come back stacked along a leading K axis."""
        metrics = []
        for k in range(era5.shape[0]):
            state, m = self._train_step(state, era5[k], sst[k] if sst is not None else None)
            metrics.append(m)
        return state, {key: torch.stack([m[key] for m in metrics]) for key in metrics[0]}

    @torch.no_grad()
    def _val_step(self, state: TrainState, era5, sst):
        """Validation rollout: per-step loss and per-variable MSE (reference
        validation(), train.py:533-654)."""
        t = self.tcfg
        ms, skip = t.multi_step_validation, t.validation_step_skip
        inp = self.normalizer(era5[0].float())
        losses, per_var = [], []
        for step in range(ms + 1):
            sst_step = (self.sst_normalizer(sst[step + 1].float())
                        if sst is not None else None)
            out = self._apply(inp, sst_step, state.film_scale)
            if step % (skip + 1) == 0:
                gt = self.normalizer(era5[step + 1].float())
                losses.append(self.loss_fn(out, gt))
                per_var.append(((out.float() - gt) ** 2).mean(dim=(0, 1, 2)))
            inp = out
        return torch.stack(losses), torch.stack(per_var)

    # ------------------------------------------------------------ loops

    def _device_chunk(self, batches: list[Batch]):
        era5 = np.stack([np.asarray(b.era5) for b in batches])
        sst = (np.stack([np.asarray(b.sst) for b in batches])
               if batches[0].sst is not None else None)
        return (torch.as_tensor(era5, device=self.device),
                torch.as_tensor(sst, device=self.device) if sst is not None else None)

    def _epoch_iterator(self, loader, epoch: int, num_batches: int):
        """The batches of one epoch (reference pre_epoch seeding,
        train.py:300-305): None (synthetic), an object with .epoch(e), a
        callable epoch -> iterator, or (epoch 0 only) an iterable."""
        if loader is None:
            return synthetic_loader(self.cfg, self.tcfg.batch_size,
                                    self.tcfg.multi_step_training, num_batches,
                                    seed=self.tcfg.seed + epoch)
        if hasattr(loader, "epoch"):
            return loader.epoch(epoch)
        if callable(loader):
            return loader(epoch)
        if epoch > 0 and iter(loader) is loader:
            raise ValueError(
                "plain iterator loader cannot be reused across epochs; pass an "
                "object with .epoch(e) or a callable epoch -> iterator")
        return iter(loader)

    def train(self, state: TrainState, loader=None,
              val_loader: Callable[[], Iterator[Batch]] | None = None,
              num_batches: int = 10) -> TrainState:
        """Epoch loop (reference train()/train_epoch, train.py:64-298).

        With scan_steps = K > 1, K batches go through `train_steps` at once;
        chunks never straddle a validation boundary and a loader's tail runs
        as single steps, so the cadence and log order are those of the
        per-batch loop.  Metrics are read one step late, so the host never
        waits on the step it has just queued."""
        t = self.tcfg
        start, self.start_epoch = self.start_epoch, 0
        K = max(1, t.scan_steps)
        pending = None  # ("single" | "chunk", first iter, metrics, film scale)

        def flush(p):
            if p is None:
                return
            kind, it0, m, fs = p
            loss = np.atleast_1d(m["loss"].detach().cpu().numpy())
            gnorm = np.atleast_1d(m["grad_norm"].detach().cpu().numpy())
            for j in range(loss.shape[0]):
                self.writer.log({"loss": float(loss[j]), "grad_norm": float(gnorm[j]),
                                 "film scale": float(fs)}, step=it0 + j)

        def room() -> int:
            if t.validation_interval <= 0:
                return K
            return t.validation_interval - (self.iter % t.validation_interval)

        def run_single(st, batch, pend):
            era5, sst = self._device_batch(batch)
            st, metrics = self._train_step(st, era5, sst)
            self.iter += 1
            flush(pend)
            return st, ("single", self.iter, metrics, st.film_scale)

        def run_chunk(st, batches, pend):
            era5, sst = self._device_chunk(batches)
            st, metrics = self.train_steps(st, era5, sst)
            first = self.iter + 1
            self.iter += len(batches)
            flush(pend)
            return st, ("chunk", first, metrics, st.film_scale)

        self.iter = int(state.step)
        try:
            for self.epoch in range(start, t.training_epochs):
                it = self._epoch_iterator(loader, self.epoch, num_batches)
                buf: list[Batch] = []
                t_epoch = time.perf_counter()
                iter0 = self.iter

                def maybe_validate():
                    nonlocal state, pending
                    if t.validation_interval > 0 and self.iter % t.validation_interval == 0:
                        pending = flush(pending)  # log order: train before val
                        state = self.validation(state, val_loader)
                        if (self.checkpoint_dir and t.save_checkpoint_interval > 0
                                and (self.iter // t.validation_interval)
                                % t.save_checkpoint_interval == 0):
                            self.save_checkpoint(state)

                for batch in it:
                    self._check_time_limit()
                    if buf and np.asarray(batch.era5).shape != np.asarray(buf[0].era5).shape:
                        # a ragged batch: drain the buffered ones as singles
                        for b in buf:
                            state, pending = run_single(state, b, pending)
                            maybe_validate()
                        buf = []
                    if K > 1 and room() >= K:
                        buf.append(batch)
                        if len(buf) < K:
                            continue
                        state, pending = run_chunk(state, buf, pending)
                        buf = []
                    else:
                        state, pending = run_single(state, batch, pending)
                    maybe_validate()
                for batch in buf:  # the loader ended mid-chunk
                    self._check_time_limit()
                    state, pending = run_single(state, batch, pending)
                    maybe_validate()
                pending = flush(pending)
                n_steps = self.iter - iter0
                if n_steps:
                    dt_epoch = time.perf_counter() - t_epoch
                    log.info("epoch %d: %d steps in %.1fs (%.2f steps/s, data pipeline "
                             "in the loop)", self.epoch, n_steps, dt_epoch, n_steps / dt_epoch)
                state = self.validation(state, val_loader)
                if self.checkpoint_dir:
                    self.save_checkpoint(state)
        except FinTraining as e:
            flush(pending)
            log.info("training finished early: %s", e)
            if self.checkpoint_dir:
                self.save_checkpoint(state)
        return state

    def validation(self, state: TrainState,
                   val_loader: Callable[[], Iterator[Batch]] | None = None) -> TrainState:
        """Validation losses and per-variable MSE, gamma/beta means of a
        filmed model, then the film-scale ramp (train.py:638-641)."""
        t = self.tcfg
        batches = (list(val_loader()) if val_loader is not None else
                   [gen_batch(self.cfg, t.batch_size, t.multi_step_validation,
                              seed=10_000 + i) for i in range(2)])
        all_losses, all_var = [], []
        for batch in batches:
            era5, sst = self._device_batch(batch)
            losses, per_var = self._val_step(state, era5, sst)
            all_losses.append(losses.cpu().numpy())
            all_var.append(per_var.cpu().numpy())
        mean_losses = np.mean(all_losses, axis=0)
        metrics = {f"validation loss step={k}": float(v) for k, v in enumerate(mean_losses)}
        mean_var = np.mean(all_var, axis=0)
        for k in range(mean_var.shape[0]):
            for c in range(mean_var.shape[1]):
                metrics[f"MSE var{c} step={k}"] = float(mean_var[k, c])
        if self.filmed and batches and batches[0].sst is not None:
            with torch.no_grad():
                sst0 = torch.as_tensor(np.asarray(batches[0].sst[0]), device=self.device)
                film_mod = self.model.film_gen(self.sst_normalizer(sst0.float()))
            metrics["gamma mean"] = float(film_mod[:, 0].mean())
            metrics["beta mean"] = float(film_mod[:, 1].mean())
        if t.advanced_logging and self.device.type == "cuda":
            metrics["device0 hbm gb"] = round(torch.cuda.memory_allocated(self.device) / 2**30, 3)
        self.writer.log(metrics, step=self.iter)
        if self.filmed and state.film_scale < 1.0:
            state.film_scale = min(state.film_scale + t.film_scale_step, 1.0)
        return state

    # ------------------------------------------------------ housekeeping

    def _check_time_limit(self):
        """Graceful stop 15 min (at most half the limit) before the wall
        (reference time_limit_stop, train.py:821-828)."""
        t = self.tcfg
        if t.time_limit_s is None:
            return
        grace = min(15 * 60, t.time_limit_s / 2)
        if time.time() - self._start_time > t.time_limit_s - grace:
            raise FinTraining("time limit reached")

    def save_checkpoint(self, state: TrainState, tag: str = "") -> str | None:
        if self.checkpoint_dir is None:
            return None
        name = f"checkpoint_iter={self.iter}_epoch={self.epoch}{tag}.pt"
        path = os.path.join(self.checkpoint_dir, name)
        ckpt_io.save_checkpoint(path, state.params, opt_state=state.opt_state,
                                step=self.iter, epoch=self.epoch,
                                config_json=to_json(self.cfg),
                                extra={"film_scale": float(state.film_scale)})
        self.writer.save(f"_epoch{self.epoch}")
        return path

    def restore(self, state: TrainState, path: str, resume_optimizer: bool = False,
                resume_scheduler: bool = False) -> TrainState:
        """Resume (the JAX cli's restore_train_state): parameters always come
        from the checkpoint; the optimizer state only with resume_optimizer
        (this package's files), else the schedule position only with
        resume_scheduler.  The next `train` starts after the checkpoint's
        epoch."""
        params, opt_state, meta = ckpt_io.load_checkpoint(path, with_opt_state=resume_optimizer)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if name in params:
                    p.copy_(params[name].to(p.dtype))
        state.step = int(meta.get("step", 0))
        state.film_scale = float(meta.get("film_scale", self.tcfg.film_scale_start))
        if resume_optimizer and opt_state is not None:
            state.opt_state = _to_device(opt_state, self.device)
        elif resume_scheduler:
            state.opt_state = fast_forward_schedule(state.opt_state, state.step)
        self.iter = state.step
        self.epoch = int(meta.get("epoch", 0))
        self.start_epoch = self.epoch + 1 if "epoch" in meta else 0
        return state


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree
