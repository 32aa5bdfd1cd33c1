"""MAE (ContextCast) wrappers (port of msfno_tpu/models/registry_mae.py;
reference MSFNO/Models/mae/model.py).

MAEWrapper: SST masked-autoencoder pretraining with NormalCRPS, and the
class tokens of a dataset for the film generator (model.py:125-164).
LinProbeWrapper: Linear(embed_dim, 1) regressing the ONI index from
precomputed class tokens (model.py:177-276), fitted in closed form.

Random draws come from explicit `torch.Generator`s: the mask ratio and the
masking noise of a pretraining step, then its dropout masks, from one
generator seeded by `pretrain`'s seed (the JAX package splits its PRNG
keys instead; the streams differ).  Tests pass the JAX draws as `noise`
and a tensor ratio.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from msfno_torch.config import TrainConfig
from msfno_torch.convert import from_flax_mae_params
from msfno_torch.models.film.attention import Dense
from msfno_torch.models.film.mae import ContextCast
from msfno_torch.models.registry import ModelWrapper
from msfno_torch.runtime import resolve_device
from msfno_torch.training.losses import normal_crps
from msfno_torch.training.optim import Optimizer

log = logging.getLogger("msfno_torch")

MASK_RANGE = (0.4, 0.8)  # the per-batch mask ratio of pretraining (train.py:334)


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


class MAEWrapper(ModelWrapper):
    """ContextCast at the film config's sizes (patch, embed_dim, dropout,
    NaN threshold; encoder depth 4, decoder depth 2, 8 heads)."""

    def build_module(self):
        f = self.cfg.film
        dev = resolve_device(self.device)
        return ContextCast(
            (f.temporal_step, *f.sst_shape), patch_size=f.patch_size,
            encoder_dim=f.embed_dim, decoder_dim=f.embed_dim,
            nan_mask_threshold=f.nan_mask_threshold, dropout_rate=f.dropout,
            device=dev, gen=_generator(dev, self.seed),
        )

    @property
    def _device(self) -> torch.device:
        return self.module.class_token.device

    def from_flax(self, tree):
        return from_flax_mae_params(tree)

    def loss(self, sst, mask_ratio, noise=None, gen=None, train: bool = True) -> torch.Tensor:
        """CRPS reconstruction loss over the masked, valid, non-NaN elements
        (reference train.py:318-339, mae branch, + NormalCRPS).  The
        masking noise is `noise` or drawn from `gen`; in training, the
        film config's dropout draws from `gen` as well."""
        sst = torch.as_tensor(sst, device=self._device).float()
        rng = gen if train and self.cfg.film.dropout > 0.0 else None
        (mean, std), (loss_mask, _), _, _ = self.module(
            sst, mask_ratio=mask_ratio, noise=noise, gen=gen, rng=rng)
        return normal_crps(mean, std, torch.nan_to_num(sst), mask=loss_mask)

    def draw_mask_ratio(self, gen: torch.Generator) -> torch.Tensor:
        """A 0-d fp32 ratio, uniform over MASK_RANGE, drawn from `gen`."""
        lo, hi = MASK_RANGE
        return lo + (hi - lo) * torch.rand((), generator=gen, device=gen.device)

    def train_step(self, opt: Optimizer, opt_state: dict, sst, gen: torch.Generator):
        """One pretraining step (the JAX package's `make_train_step`): a
        mask ratio drawn U(MASK_RANGE) from `gen`, the loss and its
        gradient, one optimizer update in place.  Returns (opt_state, the
        loss as a device tensor)."""
        ratio = self.draw_mask_ratio(gen)
        params = dict(self.module.named_parameters())
        for p in params.values():
            p.grad = None
        loss = self.loss(sst, ratio, gen=gen)
        loss.backward()
        opt_state = opt.step(params, {n: p.grad for n, p in params.items()}, opt_state)
        return opt_state, loss.detach()

    def pretrain(self, sst_batches, steps: int | None = None, learning_rate: float = 1e-3,
                 seed: int = 0, log_every: int = 10, writer=None):
        """SST pretraining loop (reference mae --train path,
        train.py:318-339 + mae/model.py): Adam at `learning_rate` over SST
        batches ((B, T, Hs, Ws), NaN over land) with a stochastic mask ratio
        per batch.  A step's loss is read one step behind, so the next batch
        is dispatched before the host waits.  Returns (the module's
        state_dict, the losses)."""
        opt = Optimizer(TrainConfig(optimizer="adam", learning_rate=learning_rate))
        opt_state = opt.init(dict(self.module.named_parameters()))
        gen = _generator(self._device, seed)
        losses, pending = [], None

        def flush(p):
            if p is None:
                return
            i, dev_loss = p
            losses.append(float(dev_loss))
            if writer is not None:
                writer.log({"mae loss": losses[-1]}, step=i)
            if i % log_every == 0:
                log.info("mae pretrain step %d: crps %.5f", i, losses[-1])

        for i, sst in enumerate(sst_batches):
            if steps is not None and i >= steps:
                break
            opt_state, loss = self.train_step(opt, opt_state, sst, gen)
            flush(pending)
            pending = (i, loss)
        flush(pending)
        return self.module.state_dict(), losses

    @torch.no_grad()
    def compute_cls_tokens(self, sst_batches) -> tuple[np.ndarray, np.ndarray]:
        """Encoder and decoder class tokens over a dataset at mask ratio 0,
        so that the film generator can skip the MAE at fine-tuning time
        (reference running(), mae/model.py:125-164)."""
        enc, dec = [], []
        for sst in sst_batches:
            _, _, cls_enc, cls_dec = self.module(
                torch.as_tensor(sst, device=self._device).float())
            enc.append(cls_enc.cpu().numpy())
            dec.append(cls_dec.cpu().numpy())
        return np.concatenate(enc), np.concatenate(dec)


class _LinProbe(torch.nn.Module):
    def __init__(self, dim: int, device, gen):
        super().__init__()
        self.head = Dense(dim, 1, device=device, gen=gen)

    def forward(self, cls_token):
        return self.head(cls_token)


class LinProbeWrapper(ModelWrapper):
    """Linear probe: class token -> ONI (reference Linear_probing,
    mae/model.py:177-276; numeric baselines in
    evaluation/LinearProbingMAE.ipynb)."""

    def build_module(self):
        dev = resolve_device(self.device)
        return _LinProbe(self.cfg.film.embed_dim, dev, _generator(dev, self.seed))

    def from_flax(self, tree):
        return from_flax_mae_params(tree)

    def fit(self, cls_tokens: np.ndarray, oni: np.ndarray, l2: float = 1e-4) -> dict:
        """Closed-form ridge regression in fp64 numpy (the probe is linear;
        no SGD needed); the fp32 weights are the probe's.  Returns its
        state_dict."""
        x = np.concatenate([cls_tokens, np.ones((len(cls_tokens), 1))], axis=1)
        a = x.T @ x + l2 * np.eye(x.shape[1])
        b = x.T @ oni.reshape(-1, 1)
        w = np.linalg.solve(a, b)
        head = self.module.head
        with torch.no_grad():
            head.weight.copy_(torch.from_numpy(w[:-1].T.astype(np.float32)))
            head.bias.copy_(torch.from_numpy(w[-1].astype(np.float32)))
        return self.module.state_dict()

    @torch.no_grad()
    def mae_metric(self, cls_tokens: np.ndarray, oni: np.ndarray) -> float:
        """Mean absolute error of the probe's ONI."""
        dev = self.module.head.weight.device
        pred = self.module(torch.as_tensor(np.asarray(cls_tokens, np.float32), device=dev))
        pred = pred.cpu().numpy().reshape(-1)
        return float(np.mean(np.abs(pred - oni)))
