"""Model registry and serving wrappers, SFNO family (port of
msfno_tpu/models/registry.py; reference MSFNO/Models/models.py `load_model`
and sfno/model.py:1590-1598 `get_model`).

A wrapper owns the net, its statistics and normalizers, and the checkpoint
it was loaded from, and runs the autoregressive forecast (`running`).  It
reads two checkpoint formats: the JAX package's native `.npz` (flattened
`params/*` leaves and a `meta/json` record, read here with numpy), and a
reference PyTorch checkpoint (`weights.tar` / `.pkl` / `.pt` / `.ckpt`).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Sequence

import numpy as np
import torch

from msfno_torch.config import FilmConfig, SFNOConfig, TrainConfig
from msfno_torch.convert import from_flax_params
from msfno_torch.data.normalization import Normalizer, SSTNormalizer
from msfno_torch.inference.rollout import RolloutConfig, rollout
from msfno_torch.models.sfno.sfnonet import (
    FourierNeuralOperatorNet,
    FourierNeuralOperatorNetFilmed,
)

log = logging.getLogger("msfno_torch")

TORCH_CHECKPOINT_SUFFIXES = (".tar", ".pkl", ".pt", ".ckpt")
# reference state_dict keys that are not parameters of the net: the dead
# top-level norm (model.py:218) and the DDP bookkeeping entry
_DEAD_KEYS = {"norm.weight", "norm.bias", "ged"}


def _unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def read_npz_checkpoint(path: str) -> tuple[dict, dict]:
    """(params tree of numpy arrays, meta) of a checkpoint written by the JAX
    package's `training.checkpoint.save_checkpoint`: leaves under
    "params/<a>/<b>/...", the metadata as JSON bytes under "meta/json"."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["meta/json"]).decode())
        flat = {k[len("params/"):]: z[k] for k in z.files if k.startswith("params/")}
    return _unflatten(flat), meta


def reference_state_dict(checkpoint) -> dict[str, torch.Tensor]:
    """The net's entries of a reference checkpoint object: the state dict
    under "model_state" when wrapped, else the object itself
    (msfno_tpu/models/convert.py:562-580), without DDP "module." prefixes
    and dead keys."""
    weights = checkpoint
    if isinstance(checkpoint, dict) and "model_state" in checkpoint:
        weights = checkpoint["model_state"]
    out = {}
    for k, v in weights.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if k not in _DEAD_KEYS and isinstance(v, torch.Tensor):
            out[k] = v
    return out


@dataclasses.dataclass
class ModelWrapper:
    """Base wrapper: config + net + normalizers + checkpoint I/O (reference
    Model/ATMModel, models.py:49-401).  The net is built on `device` (CUDA
    unless "cpu" is asked for) with random weights drawn from `seed` until
    `load_model` replaces them."""

    cfg: SFNOConfig
    assets: str | None = None
    device: str | torch.device | None = None
    seed: int = 0

    def __post_init__(self):
        self.module = self.build_module()
        self.normalizer = self.load_statistics()
        self.sst_normalizer = SSTNormalizer.identity()
        # FiLM modulation strength at inference; load_model takes the
        # checkpoint's trained value when it records one
        self.film_scale = 1.0

    def build_module(self) -> torch.nn.Module:
        raise NotImplementedError

    def load_statistics(self) -> Normalizer:
        """global_means.npy / global_stds.npy under `assets` (reference
        model.py:194-205), else the identity."""
        if self.assets:
            m = os.path.join(self.assets, "global_means.npy")
            s = os.path.join(self.assets, "global_stds.npy")
            if os.path.exists(m) and os.path.exists(s):
                return Normalizer.from_npy(m, s)
        return Normalizer.identity(self.cfg.in_chans)

    def normalise(self, x, reverse: bool = False):
        return self.normalizer(x, reverse=reverse)

    def load_model(self, checkpoint_file: str | None) -> torch.nn.Module:
        """Load weights from the JAX package's `.npz` checkpoint (all of them,
        strictly, and its `film_scale`) or a reference PyTorch checkpoint
        (the entries the net has; the rest is logged).  None keeps the
        seeded random weights."""
        if checkpoint_file is None:
            return self.module
        if os.path.isdir(checkpoint_file):
            raise NotImplementedError(
                f"{checkpoint_file} is a directory: Orbax checkpoints come in a "
                "later slice"
            )
        if checkpoint_file.endswith(TORCH_CHECKPOINT_SUFFIXES):
            checkpoint = torch.load(checkpoint_file, map_location="cpu", weights_only=True)
            result = self.module.load_state_dict(reference_state_dict(checkpoint),
                                                 strict=False)
            if result.missing_keys or result.unexpected_keys:
                log.warning("checkpoint keys not loaded (strict=False): missing %s, "
                            "unexpected %s", result.missing_keys[:10],
                            result.unexpected_keys[:10])
            return self.module
        params, meta = read_npz_checkpoint(checkpoint_file)
        self.module.load_state_dict(from_flax_params(params), strict=True)
        # inference modulates at the TRAINED film strength: the training
        # ramp leaves it well below 1.0 in most checkpoints
        if "film_scale" in meta:
            self.film_scale = float(meta["film_scale"])
        return self.module

    def running(self, x0: np.ndarray, lead_time_h: int = 24,
                sst_seq: np.ndarray | None = None,
                collect_channels: Sequence[int] | None = None, output=None):
        """Autoregressive forecast (reference running(), model.py:289-372):
        yields the denormalized fp32 field of each 6-hour step, at the
        wrapper's film_scale; `output.write(field, step=hours)` per step when
        given."""
        steps = lead_time_h // 6
        filmed = isinstance(self.module, FourierNeuralOperatorNetFilmed)
        it = rollout(
            self.module, x0, RolloutConfig(steps=steps, collect_channels=collect_channels),
            sst_seq=sst_seq if filmed else None, normalizer=self.normalizer,
            sst_normalizer=self.sst_normalizer, scale=self.film_scale,
        )
        for i, field in enumerate(it):
            if output is not None:
                output.write(field, step=(i + 1) * 6)
            yield field

    def trainer(self, tcfg: TrainConfig, **kw):
        """A fine-tune `Trainer` of this wrapper's configuration with its
        normalizers, on its device unless `device=` is given (the JAX
        wrapper's `trainer`).  The trainer builds its own net from the train
        config's seed."""
        from msfno_torch.training.trainer import Trainer

        kw.setdefault("device", self.device)
        return Trainer(self.cfg, tcfg, normalizer=self.normalizer,
                       sst_normalizer=self.sst_normalizer, **kw)


class SFNOWrapper(ModelWrapper):
    """FourCastNetv2 (reference sfno/model.py:36-903)."""

    def build_module(self):
        return FourierNeuralOperatorNet(self.cfg, device=self.device, seed=self.seed)


class SFNOFilmedWrapper(ModelWrapper):
    """FourCastNetv2_filmed (reference sfno/model.py:905-1588)."""

    def build_module(self):
        if self.cfg.film is None:
            raise ValueError("film config required")
        return FourierNeuralOperatorNetFilmed(self.cfg, device=self.device, seed=self.seed)


def get_model(model_type: str = "sfno", model_version: str = "latest",
              cfg: SFNOConfig | None = None, **kw) -> ModelWrapper:
    """Registry mux (reference load_model, models.py:418-428, and the
    per-family get_model, sfno/model.py:1590-1598)."""
    if model_type == "sfno":
        if model_version == "film":
            return SFNOFilmedWrapper(cfg or SFNOConfig(film=FilmConfig()), **kw)
        return SFNOWrapper(cfg or SFNOConfig(), **kw)
    if model_type == "fcn":
        raise NotImplementedError("the FourCastNet (AFNO) family comes in a later slice")
    if model_type == "mae":
        raise NotImplementedError(
            "the MAE pretraining family comes in a later slice, after the ViT and "
            "MAE FiLM generators"
        )
    raise ValueError(f"unknown model {model_type}/{model_version}")
