"""Training orchestration (port of msfno_tpu/training/trainer.py; reference
Trainer, MSFNO/Models/train.py:35-1337).

One optimization step is the multi-step autoregressive rollout, the loss
with its discount and skip semantics, the gradient of the trainable
parameters (autograd through the kernels' backward Functions) and the
optimizer update, applied in place to the model's parameters.  The host
loop feeds batches and keeps the cadence: validation, checkpoints, the
film-scale ramp and the time-limit stop.  Method names are the JAX
package's, so each has its counterpart there; `TrainState` holds the
model's own Parameter objects, and a step updates it in place and returns
it.  Batches come from a `data.era5.PrefetchLoader`, any iterable or
callable of `Batch`es, or synthetic data; their fields may be numpy arrays
or torch tensors (a bf16 transfer).  With dropout or drop-path set, each
step draws its masks from one `torch.Generator` seeded from the config's
seed and the step.

With `mesh=` (a data-only `parallel.mesh.make_mesh`), each process trains a
whole replica on its local batch: the state starts as rank 0's, the
trainable gradients and the loss are all-reduced over the data group before
the optimizer step (`parallel.sharded_train`): summed for a loss that sums
over samples, averaged for one that averages, so that they are the global
batch's.  Validation metrics are averaged over the group, and rank 0 writes
the checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Callable, Iterator

import numpy as np
import torch
import torch.distributed as dist

from msfno_torch.config import SFNOConfig, TrainConfig, to_json
from msfno_torch.data.normalization import Normalizer, SSTNormalizer
from msfno_torch.data.synthetic import Batch, gen_batch, synthetic_loader
from msfno_torch.models import FourierNeuralOperatorNet, FourierNeuralOperatorNetFilmed
from msfno_torch.parallel.sharded_train import all_reduce, data_group, shard_state
from msfno_torch.runtime import resolve_device
from msfno_torch.training import checkpoint as ckpt_io
from msfno_torch.training.losses import get_loss, sums_over_samples
from msfno_torch.training.optim import create_optimizer, fast_forward_schedule
from msfno_torch.training.partition import count_params, film_trainable_predicate, split_params
from msfno_torch.utils.observability import (
    FinTraining,
    LocalLog,
    Timer,
    device_memory_stats,
    system_monitor,
)

log = logging.getLogger("msfno_torch")

# the FiLM generators whose film.dropout acts: the ViT's and the MAE's (in
# ContextCast and its film head); the GCN ones have none, so it is a no-op
# for them, as in the JAX package
_FILM_DROPOUT_ACTS = ("transformer", "mae")


def _is_oom_error(e: BaseException) -> bool:
    """True for an out-of-memory failure of the device: `test_batch_size`
    stops its sweep on these only."""
    return isinstance(e, torch.cuda.OutOfMemoryError) or (
        isinstance(e, RuntimeError) and "out of memory" in str(e).lower())


def chunk_input_bytes_per_step(model_cfg: SFNOConfig, train_cfg: TrainConfig) -> int:
    """Bytes of one batch inside a scan chunk: `_device_chunk` stacks K of
    these into one (K, S, B, ...) fp32 buffer (S = rollout states + target)."""
    h, w = model_cfg.img_size
    s = train_cfg.multi_step_training + 2
    n = s * train_cfg.batch_size * h * w * model_cfg.in_chans
    if model_cfg.film is not None:
        f = model_cfg.film
        n += s * train_cfg.batch_size * f.temporal_step * f.sst_shape[0] * f.sst_shape[1]
    return n * 4


def auto_scan_steps(model_cfg: SFNOConfig, train_cfg: TrainConfig,
                    hbm_budget_bytes: int | None = None, max_k: int = 16) -> int:
    """K for `scan_steps` "auto": the largest K that divides
    validation_interval (chunks then tile the cadence), keeps the stacked
    input chunk within the budget and is at most max_k.  The default budget
    is a quarter of the current CUDA device's memory; without a card give
    one."""
    if hbm_budget_bytes is None:
        if not torch.cuda.is_available():
            raise ValueError("auto_scan_steps needs hbm_budget_bytes without a CUDA device")
        hbm_budget_bytes = torch.cuda.get_device_properties(
            torch.cuda.current_device()).total_memory // 4
    per = chunk_input_bytes_per_step(model_cfg, train_cfg)
    cap = int(max(1, min(max_k, hbm_budget_bytes // max(per, 1))))
    vi = train_cfg.validation_interval
    k = max(d for d in range(1, cap + 1) if vi % d == 0) if vi and vi > 0 else cap
    log.info("scan-steps auto: K=%d (chunk %.0f MB of %.0f MB budget, validation_interval=%s)",
             k, k * per / 2**20, hbm_budget_bytes / 2**20, vi)
    return k


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
    device (CUDA unless `device="cpu"`), data-parallel over the ranks of a
    `mesh`."""

    def __init__(self, model_cfg: SFNOConfig, train_cfg: TrainConfig,
                 normalizer: Normalizer | None = None,
                 sst_normalizer: SSTNormalizer | None = None,
                 writer: LocalLog | None = None, checkpoint_dir: str | None = None,
                 device=None, mesh=None):
        self.mesh = mesh
        self._group, self.world, self.rank = None, 1, 0
        if mesh is not None:
            self._group = data_group(mesh)  # raises for lat or channel > 1
            self.world, self.rank = dist.get_world_size(self._group), dist.get_rank(self._group)
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
        state = TrainState(trainable=trainable, frozen=frozen,
                           opt_state=self.tx.init(trainable), step=0,
                           film_scale=float(self.tcfg.film_scale_start))
        if self.mesh is not None:
            state = shard_state(state, self.mesh)
        return state

    # -------------------------------------------------------- forward/loss

    @property
    def _has_dropout(self) -> bool:
        film = self.cfg.film
        return (self.cfg.drop_rate > 0.0 or self.cfg.drop_path_rate > 0.0
                or (film is not None and film.dropout > 0.0
                    and film.film_gen_type in _FILM_DROPOUT_ACTS))

    def _train_rng(self, step: int) -> torch.Generator:
        """The dropout and drop-path masks' generator of one step, seeded
        from the config's seed and the step (JAX folds the same two into its
        PRNG keys, `_train_rngs`; the streams differ), and with more than one
        rank the rank too, so that each rank's samples draw their own masks."""
        entropy = [self.tcfg.seed, int(step)] + ([self.rank] if self.world > 1 else [])
        seed = np.random.SeedSequence(entropy).generate_state(1)[0]
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def _apply(self, x, sst, scale, rng=None):
        """The model's forward; with `rng` in training mode (dropout and
        drop-path act)."""
        if self.filmed:
            return self.model(x, sst, scale, rng=rng)
        return self.model(x, rng=rng)

    def _to_device(self, x) -> torch.Tensor:
        """A batch field (numpy array or torch tensor) on the device, its
        dtype kept."""
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def _device_batch(self, batch: Batch):
        sst = self._to_device(batch.sst) if batch.sst is not None else None
        return self._to_device(batch.era5), sst

    def _rollout_loss(self, era5, sst, scale, rng=None):
        """Multi-step autoregressive loss (reference train.py:146-197).

        era5: (S, B, H, W, C) raw; sst: (S, B, T, Hs, Ws) or None.
        loss = sum over scored steps of disc^step * L(out, gt) / (ms + 1).
        No 1/(acc + 1) factor: the optimizer averages micro-step gradients.
        `rng`: training mode, the rollout's steps drawing from it in turn."""
        t = self.tcfg
        ms, skip = t.multi_step_training, t.training_step_skip
        inp = self.normalizer(era5[0].float())
        total, per_step = 0.0, []
        for step in range(ms + 1):
            sst_step = (self.sst_normalizer(sst[step + 1].float())
                        if sst is not None else None)
            out = self._apply(inp, sst_step, scale, rng)
            if step % (skip + 1) == 0:
                gt = self.normalizer(era5[step + 1].float())
                loss = self.loss_fn(out, gt) / (ms + 1) * t.discount_factor ** step
                total = total + loss
                per_step.append(loss)
            inp = out
        return total, torch.stack(per_step)

    def loss_and_grads(self, state: TrainState, era5, sst):
        """(loss, per-step losses, name -> gradient of the trainable
        parameters) at the current parameters, in training mode when the
        model has dropout or drop-path."""
        rng = self._train_rng(state.step) if self._has_dropout else None
        loss, per_step = self._rollout_loss(era5, sst, state.film_scale, rng)
        names = list(state.trainable)
        grads = torch.autograd.grad(loss, [state.trainable[n] for n in names],
                                    allow_unused=True)
        grads = {n: torch.zeros_like(state.trainable[n]) if g is None else g
                 for n, g in zip(names, grads)}
        return loss.detach(), per_step.detach(), grads

    def _train_step(self, state: TrainState, era5, sst):
        """One optimizer step on one batch; updates `state` in place and
        returns it with the step's metrics (device scalars).  Under a mesh
        the gradients and losses are those of the global batch: the ranks'
        sum for a loss that sums over samples, their mean for one that
        averages."""
        loss, per_step, grads = self.loss_and_grads(state, era5, sst)
        if self.mesh is not None:
            all_reduce(list(grads.values()) + [loss, per_step], self._group,
                       mean=not sums_over_samples(self.tcfg.loss_fn))
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
        """K batches stacked to (K, S, B, ...) on the device."""
        era5 = torch.stack([self._to_device(b.era5) for b in batches])
        sst = (torch.stack([self._to_device(b.sst) for b in batches])
               if batches[0].sst is not None else None)
        return era5, sst

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
                    if buf and tuple(batch.era5.shape) != tuple(buf[0].era5.shape):
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
                sst0 = self._to_device(batches[0].sst[0])
                film_mod = self.model.film_gen(self.sst_normalizer(sst0.float()))
            metrics["gamma mean"] = float(film_mod[:, 0].mean())
            metrics["beta mean"] = float(film_mod[:, 1].mean())
        if self.mesh is not None:  # the reference's all_reduce(SUM) / world
            vals = torch.tensor(list(metrics.values()), dtype=torch.float64, device=self.device)
            dist.all_reduce(vals, group=self._group)
            metrics = dict(zip(metrics, (vals / self.world).tolist()))
        if t.advanced_logging:
            # reference mem_log / system_monitor telemetry (train.py:747-756)
            sysm = system_monitor(printout=False)
            metrics["host ram percent"] = sysm["ram_percent"]
            metrics["process rss gb"] = sysm["process_rss_gb"]
            for i, d in enumerate(device_memory_stats()):
                metrics[f"device{i} hbm gb"] = round(d["bytes_in_use"] / 2**30, 3)
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
        stop = time.time() - self._start_time > t.time_limit_s - grace
        if self.mesh is not None:  # every rank stops at the same step
            flag = torch.tensor([float(stop)], device=self.device)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self._group)
            stop = bool(flag.item())
        if stop:
            raise FinTraining("time limit reached")

    def save_checkpoint(self, state: TrainState, tag: str = "") -> str | None:
        """Write the state as this package's `.pt` checkpoint; under a mesh
        rank 0 writes it (every rank holds the whole replica) and the ranks
        meet at a barrier after."""
        if self.checkpoint_dir is None:
            return None
        name = f"checkpoint_iter={self.iter}_epoch={self.epoch}{tag}.pt"
        path = os.path.join(self.checkpoint_dir, name)
        if self.rank == 0:
            ckpt_io.save_checkpoint(path, state.params, opt_state=state.opt_state,
                                    step=self.iter, epoch=self.epoch,
                                    config_json=to_json(self.cfg),
                                    extra={"film_scale": float(state.film_scale)})
            self.writer.save(f"_epoch{self.epoch}")
        if self.mesh is not None:
            dist.barrier(group=self._group)
        return path

    def save_data(self, loader, out_dir: str, num_batches: int = 4) -> str:
        """Write the first `num_batches` batches of `loader` as
        `batch_{i:04d}.npz` (era5, times, sst) under `out_dir` (reference
        --save-data, main.py:293); bf16 fields are written as fp32."""
        os.makedirs(out_dir, exist_ok=True)
        as_numpy = lambda x: (x.float().cpu().numpy() if isinstance(x, torch.Tensor)  # noqa: E731
                              else x)
        for i, batch in enumerate(loader):
            if i >= num_batches:
                break
            arrays = {"era5": as_numpy(batch.era5), "times": batch.times}
            if batch.sst is not None:
                arrays["sst"] = as_numpy(batch.sst)
            np.savez(os.path.join(out_dir, f"batch_{i:04d}.npz"), **arrays)
        return out_dir

    # ------------------------------------------------ perf harness trio
    # (reference --test-performance: train.py:1196-1337)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def test_model_speed(self, state: TrainState, iters: int = 10) -> float:
        """Seconds per forward on a synthetic batch (train.py:1196-1208),
        after one warm-up call."""
        batch = gen_batch(self.cfg, self.tcfg.batch_size, 0, seed=0)
        era5, sst = self._device_batch(batch)
        x, s = era5[0], sst[0] if sst is not None else None
        self._apply(x, s, state.film_scale)
        self._sync()
        with Timer("model fwd", divisor=iters) as tm:
            for _ in range(iters):
                self._apply(x, s, state.film_scale)
            self._sync()
        return tm.seconds

    def test_dataloader_speed(self, loader: Iterator[Batch], iters: int = 5) -> float:
        """Seconds per batch of drawing `iters` batches from `loader`
        (train.py:1282-1289)."""
        with Timer("dataloader", divisor=iters) as tm:
            for i, _ in enumerate(loader):
                if i + 1 >= iters:
                    break
        return tm.seconds

    def _probe_batch_size(self, b: int) -> None:
        """One train step at batch size b on a fresh trainer (raises on
        failure)."""
        probe = Trainer(self.cfg, dataclasses.replace(self.tcfg, batch_size=b),
                        device=self.device)
        try:
            st = probe.init_state()
            batch = gen_batch(self.cfg, b, self.tcfg.multi_step_training, seed=0)
            st, m = probe._train_step(st, *probe._device_batch(batch))
            float(m["loss"])
        finally:
            del probe
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    def test_batch_size(self, candidates: tuple[int, ...] = (1, 2, 4, 8, 16)) -> int:
        """The largest candidate batch size whose train step runs, growing
        until one runs out of memory (train.py:1296-1337).  Only an
        out-of-memory failure ends the sweep; any other error propagates."""
        best = 0
        for b in candidates:
            try:
                self._probe_batch_size(b)
            except Exception as e:
                if not _is_oom_error(e):
                    raise
                log.info("batch size %d OOM (%s)", b, type(e).__name__)
                break
            best = b
            log.info("batch size %d OK", b)
        return best

    def restore(self, state: TrainState, path: str, resume_optimizer: bool = False,
                resume_scheduler: bool = False) -> TrainState:
        """Resume (the JAX cli's restore_train_state): parameters always come
        from the checkpoint; the optimizer state only with resume_optimizer
        (this package's files, or a JAX `.npz`'s optax state ordered by this
        trainer's config), else the schedule position only with
        resume_scheduler.  The next `train` starts after the checkpoint's
        epoch."""
        params, opt_state, meta = ckpt_io.load_checkpoint(
            path, with_opt_state=resume_optimizer, train_cfg=self.tcfg)
        with torch.no_grad():
            for name, p in self.model.named_parameters():
                if name in params:
                    p.copy_(params[name].to(p.dtype))
        state.step = int(meta.get("step", 0))
        state.film_scale = float(meta.get("film_scale", self.tcfg.film_scale_start))
        if resume_optimizer and opt_state is not None:
            moments = opt_state["inner"].get("mu", opt_state["inner"].get("trace"))
            if set(moments) != set(state.trainable):
                raise ValueError(f"{path}: the optimizer state's parameters are not this "
                                 "trainer's trainable ones")
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


def save_forecast(trainer: Trainer, state: TrainState, batches, steps: int, out_path: str | None,
                  channels: list[str] | None = None) -> str:
    """Weatherbench2-format forecast dump (the JAX package's save_forecast;
    reference Trainer.save_forecast, train.py:942-1022, and
    save_to_zarr_forecast, 1024-1110): for each batch, roll out `steps`
    prediction timedeltas from its first state on the trainer's device at
    the state's film scale, denormalise each step there, copy it to the
    host and append one (steps, H, W, C) chunk per init time
    (`batch.times[0, b]`) to a ForecastWriter archive at `out_path`.  With
    out_path None the rollouts run and nothing is written (the ranks other
    than 0 of a data mesh)."""
    from msfno_torch.inference.forecast_writer import ForecastWriter
    from msfno_torch.inference.rollout import _states

    h, w = trainer.cfg.img_size
    writer = None if out_path is None else ForecastWriter(
        out_path, channels or [f"var{i}" for i in range(trainer.cfg.out_chans)],
        lat=np.linspace(90, -90, h), lon=np.linspace(0, 360, w, endpoint=False))
    for batch in batches:
        sst_seq = batch.sst[1:steps + 1] if batch.sst is not None else None
        states = _states(trainer.model, batch.era5[0], steps, sst_seq, trainer.normalizer,
                         trainer.sst_normalizer, float(state.film_scale))
        fc = np.stack([trainer.normalizer(s.float(), reverse=True).cpu().numpy()
                       for s in states])  # (steps, B, H, W, C)
        for b in range(fc.shape[1] if writer is not None else 0):
            writer.append(int(batch.times[0, b]), fc[:, b])
    return out_path
