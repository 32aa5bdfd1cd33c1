"""Model registry and serving wrappers (port of msfno_tpu/models/registry.py;
reference MSFNO/Models/models.py `load_model` and sfno/model.py:1590-1598
`get_model`): the SFNO family here, FourCastNet (AFNO) in `registry_fcn`,
the MAE and its linear probe in `registry_mae`.

A wrapper owns the net, its statistics and normalizers, and the checkpoint
it was loaded from, and runs the autoregressive forecast (`running`).  It
reads three checkpoint formats (`read_checkpoint`): the JAX package's
native `.npz` (flattened `params/*` leaves and a `meta/json` record, read
here with numpy), this package's own `torch.save` file
(`training.checkpoint`, which `save_checkpoint` writes), and a reference
PyTorch checkpoint (`weights.tar` / `.pkl` / `.pt` / `.ckpt`).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import zipfile
from typing import Sequence

import numpy as np
import torch

from msfno_torch.config import FilmConfig, SFNOConfig, TrainConfig, to_json
from msfno_torch.data.normalization import Normalizer, SSTNormalizer
from msfno_torch.inference.rollout import RolloutConfig, rollout
from msfno_torch.models.sfno.sfnonet import (
    FourierNeuralOperatorNet,
    FourierNeuralOperatorNetFilmed,
)
from msfno_torch.models.variables import ORDERING
from msfno_torch.training import checkpoint as ckpt_io

log = logging.getLogger("msfno_torch")

TORCH_CHECKPOINT_SUFFIXES = (".tar", ".pkl", ".pt", ".ckpt")
# reference state_dict keys that are not parameters of the net: the dead
# top-level norm (model.py:218) and the DDP bookkeeping entry
_DEAD_KEYS = {"norm.weight", "norm.bias", "ged"}


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


def load_statistics(assets: str | None, channels: int) -> Normalizer:
    """global_means.npy / global_stds.npy under `assets` (reference
    model.py:194-205), else the identity over `channels`."""
    if assets:
        m = os.path.join(assets, "global_means.npy")
        s = os.path.join(assets, "global_stds.npy")
        if os.path.exists(m) and os.path.exists(s):
            return Normalizer.from_npy(m, s)
    return Normalizer.identity(channels)


def _is_own_checkpoint(obj) -> bool:
    """A `training.checkpoint.save_checkpoint` payload."""
    return (isinstance(obj, dict) and {"meta", "params"} <= set(obj)
            and isinstance(obj["meta"], dict) and "format_version" in obj["meta"])


def read_checkpoint(path: str, convert=None) -> tuple[dict[str, torch.Tensor], dict, bool]:
    """(state_dict, meta, is_reference) of a checkpoint file: a JAX `.npz`
    (every parameter, through `convert`, by default `from_flax_params`),
    this package's own file
    (its parameters and meta) or a reference PyTorch checkpoint
    (`reference_state_dict`, no meta: `is_reference` True, loaded with
    strict=False).  An Orbax directory, the JAX package's or this
    package's, reads as the `.npz` and `.pt` files do; a directory that is
    not one raises FileNotFoundError."""
    if os.path.isdir(path) or not path.endswith(TORCH_CHECKPOINT_SUFFIXES):
        params, _, meta = ckpt_io.load_checkpoint(path, convert=convert)
        return params, meta, False
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if _is_own_checkpoint(obj):
        return obj["params"], obj["meta"], False
    return reference_state_dict(obj), {}, True


def is_reference_checkpoint(path: str) -> bool:
    """True for a reference PyTorch checkpoint file: a torch file
    (`TORCH_CHECKPOINT_SUFFIXES`, not a directory) that is not this
    package's own format.  Such a file carries no config."""
    if os.path.isdir(path) or not path.endswith(TORCH_CHECKPOINT_SUFFIXES):
        return False
    if not zipfile.is_zipfile(path):
        return True  # the legacy torch.save format: never this package's
    obj = torch.load(path, map_location="cpu", weights_only=True, mmap=True)
    return not _is_own_checkpoint(obj)


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
        return load_statistics(self.assets, self.cfg.in_chans)

    def normalise(self, x, reverse: bool = False):
        return self.normalizer(x, reverse=reverse)

    def load_model(self, checkpoint_file: str | None) -> torch.nn.Module:
        """Load weights from a JAX `.npz` checkpoint or this package's own
        file (all of them, strictly, and its `film_scale`) or from a
        reference PyTorch checkpoint (the entries the net has; the rest is
        logged).  None keeps the seeded random weights."""
        if checkpoint_file is None:
            return self.module
        params, meta, reference = read_checkpoint(checkpoint_file, convert=self.from_flax)
        result = self.module.load_state_dict(params, strict=not reference)
        if reference and (result.missing_keys or result.unexpected_keys):
            log.warning("checkpoint keys not loaded (strict=False): missing %s, "
                        "unexpected %s", result.missing_keys[:10],
                        result.unexpected_keys[:10])
        # inference modulates at the TRAINED film strength: the training
        # ramp leaves it well below 1.0 in most checkpoints
        if "film_scale" in meta:
            self.film_scale = float(meta["film_scale"])
        return self.module

    def from_flax(self, tree) -> dict[str, torch.Tensor]:
        """The state_dict of a JAX `.npz` checkpoint's parameter tree."""
        from msfno_torch.convert import from_flax_params

        return from_flax_params(tree)

    def save_checkpoint(self, path: str, **extra) -> str:
        """Write the net's weights with the config's JSON as this package's
        checkpoint file (`training.checkpoint.save_checkpoint`; `extra`
        are its keywords: opt_state, step, epoch, extra)."""
        return ckpt_io.save_checkpoint(path, self.module.state_dict(),
                                       config_json=to_json(self.cfg), **extra)

    def get_parameters(self) -> dict[str, torch.nn.Parameter]:
        """The trainable parameters by name (reference get_parameters,
        model.py:1532-1536): all of them here."""
        return dict(self.module.named_parameters())

    def running(self, x0: np.ndarray, lead_time_h: int = 24,
                sst_seq: np.ndarray | None = None,
                collect_channels: Sequence[int] | None = None, output=None, mesh=None):
        """Autoregressive forecast (reference running(), model.py:289-372):
        yields the denormalized fp32 field of each 6-hour step, at the
        wrapper's film_scale; `output.write(field, step=hours)` per step when
        given; each step's rate and ETA are logged (`Stepper`).  With
        `mesh`, each step runs under it (`rollout`)."""
        from msfno_torch.utils.observability import Stepper

        steps = lead_time_h // 6
        filmed = isinstance(self.module, FourierNeuralOperatorNetFilmed)
        it = rollout(
            self.module, x0, RolloutConfig(steps=steps, collect_channels=collect_channels),
            sst_seq=sst_seq if filmed else None, normalizer=self.normalizer,
            sst_normalizer=self.sst_normalizer, scale=self.film_scale, stepper=Stepper(steps),
            mesh=mesh,
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

    @property
    def ordering(self) -> list[str]:
        return ORDERING


class SFNOFilmedWrapper(ModelWrapper):
    """FourCastNetv2_filmed (reference sfno/model.py:905-1588)."""

    def build_module(self):
        if self.cfg.film is None:
            raise ValueError("film config required")
        return FourierNeuralOperatorNetFilmed(self.cfg, device=self.device, seed=self.seed)

    @property
    def ordering(self) -> list[str]:
        return ORDERING

    def get_parameters(self) -> dict[str, torch.nn.Parameter]:
        """The film-trainable subset (reference model.py:1532-1536):
        `film_trainable_predicate` on each name's JAX-style path."""
        from msfno_torch.training.partition import film_trainable_predicate, jax_path

        pred = film_trainable_predicate(num_layers=self.cfg.num_layers)
        return {n: p for n, p in self.module.named_parameters() if pred(jax_path(n))}


def get_model(model_type: str = "sfno", model_version: str = "latest",
              cfg: SFNOConfig | None = None, **kw) -> ModelWrapper:
    """Registry mux (reference load_model, models.py:418-428, and the
    per-family get_model, sfno/model.py:1590-1598): "sfno" (version "film"
    for the filmed net), "fcn" (versions "0" / "release", "1" / "latest"),
    "mae" (version "lin-probe" for the linear probe)."""
    if model_type == "sfno":
        if model_version == "film":
            return SFNOFilmedWrapper(cfg or SFNOConfig(film=FilmConfig()), **kw)
        return SFNOWrapper(cfg or SFNOConfig(), **kw)
    if model_type == "fcn":
        from msfno_torch.models.registry_fcn import FCNWrapper

        return FCNWrapper.for_version(model_version, cfg, **kw)
    if model_type == "mae":
        from msfno_torch.models.registry_mae import LinProbeWrapper, MAEWrapper

        if model_version == "lin-probe":
            return LinProbeWrapper(cfg or SFNOConfig(film=FilmConfig()), **kw)
        return MAEWrapper(cfg or SFNOConfig(film=FilmConfig()), **kw)
    raise ValueError(f"unknown model {model_type}/{model_version}")
