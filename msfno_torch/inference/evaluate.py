"""Skill evaluation against climatology (port of
msfno_tpu/inference/evaluate.py; reference evaluate_model,
MSFNO/Models/sfno/model.py:1292-1486; protocol: skill = 1 - MSE_model /
MSE_climatology per variable per lead, model.py:1419-1422).

The functions take torch tensors and run on their device, so forecasts
scored on the card stay there.  Sums are taken in fp64; a `SkillReport`
holds numpy (S, C) arrays.  `SkillSums` accumulates the per-step sums one
step and one batch at a time: its means over every batch added are the
JAX package's means over the batches concatenated, without stacking them.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
from calendar import isleap

import numpy as np
import torch

from msfno_torch.data.climatology import climatology_at

log = logging.getLogger("msfno_torch")

_GRID_DIMS = (0, 1, 2)  # batch, lat, lon of (B, H, W, C)


@dataclasses.dataclass
class SkillReport:
    """Per-(lead step, variable) arrays."""

    mse_model: np.ndarray  # (S, C) in real space
    mse_model_norm: np.ndarray  # (S, C) in normalized space
    mse_climatology: np.ndarray  # (S, C)
    skill: np.ndarray  # (S, C) = 1 - mse_model / mse_climatology
    # anomaly correlation coefficient against the same climatology (S, C)
    acc: np.ndarray | None = None

    def save(self, path_prefix: str):
        np.save(path_prefix + "_mse_model.npy", self.mse_model)
        np.save(path_prefix + "_mse_model_norm.npy", self.mse_model_norm)
        np.save(path_prefix + "_mse_climatology.npy", self.mse_climatology)
        np.save(path_prefix + "_skill.npy", self.skill)
        if self.acc is not None:
            np.save(path_prefix + "_acc.npy", self.acc)


def lat_weights(h: int, device=None) -> torch.Tensor:
    """(h, 1, 1) fp32 cos-lat area weights for spatial means (poles
    included), computed as the JAX package does: cos of an fp64 linspace,
    clipped, + 1e-6, normalised to mean 1, then cast to fp32."""
    w = np.cos(np.linspace(-np.pi / 2, np.pi / 2, h))
    w = np.clip(w, 0.0, None) + 1e-6
    return torch.as_tensor((w / w.mean()).astype(np.float32)[:, None, None], device=device)


def _sums(pred: torch.Tensor, target: torch.Tensor, clim: torch.Tensor | None = None):
    """fp64 per-variable weighted sums over (B, H, W) of (pred - target)^2,
    or with `clim` the three ACC sums <f't'>, <f'f'>, <t't'>.  The
    differences are taken in fp32, as the JAX package takes them."""
    w = lat_weights(pred.shape[-3], pred.device).double()
    if clim is None:
        d = (pred.float() - target.float()).double()
        return (d * d * w).sum(_GRID_DIMS)
    fp = (pred.float() - clim.float()).double()
    tp = (target.float() - clim.float()).double()
    return (fp * tp * w).sum(_GRID_DIMS), (fp * fp * w).sum(_GRID_DIMS), \
        (tp * tp * w).sum(_GRID_DIMS)


def _points(x: torch.Tensor) -> int:
    return x.shape[0] * x.shape[1] * x.shape[2]


def weighted_mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> per-variable (C,) cos-lat-weighted MSE (fp64)."""
    return _sums(pred, target) / _points(pred)


def weighted_acc(pred: torch.Tensor, target: torch.Tensor,
                 clim: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> per-variable (C,) cos-lat-weighted anomaly
    correlation coefficient (fp64):
      ACC = <f' t'> / sqrt(<f'^2> <t'^2>),  f' = f - clim, t' = t - clim,
    with <.> the area-weighted mean over batch and grid (ECMWF
    deterministic-verification definition)."""
    num, ff, tt = _sums(pred, target, clim)
    return num / torch.clamp(torch.sqrt(ff * tt), min=1e-12)


def is_binned(climatology, target_shape) -> bool:
    """True for a (doy, hour)-binned climatology ((365|366, 4, H, W, C)) of
    targets of shape (S, B, H, W, C): the JAX package's test."""
    shape = tuple(climatology.shape)
    return (len(shape) == len(target_shape) and shape[0] in (365, 366)
            and shape[:2] != tuple(target_shape[:2]) and shape[2:] == tuple(target_shape[2:]))


def _slot(clim, t: int, mean_field):
    """The climatology field of one YYYYMMDDHH valid time; <= 0 (synthetic
    data) is the all-slot mean field."""
    if t <= 0:
        return mean_field
    y, mo, d, h = t // 10**6, t // 10**4 % 100, t // 100 % 100, t % 100
    doy = datetime.date(y, mo, d).timetuple().tm_yday
    if clim.shape[0] == 365:  # leap day dropped
        return climatology_at(clim, doy, h, leap_year=isleap(y))
    return clim[doy - 1, (h // 6) % clim.shape[1]]  # 366 slots: day of year


def indexed_climatology(clim, times, target_shape: tuple):
    """Expand a (doy, hour)-binned climatology (365 or 366 days, 4 hours;
    numpy array or torch tensor) to the per-target (S, B, H, W, C) array of
    the same kind by each target's valid time (times: (S, B) int
    YYYYMMDDHH; entries <= 0 take the all-slot mean field)."""
    times = np.asarray(times)
    is_torch = isinstance(clim, torch.Tensor)
    # the all-slot mean, summed in fp64
    mean_field = (clim.double().mean(dim=(0, 1)).to(clim.dtype) if is_torch
                  else clim.mean(axis=(0, 1), dtype=np.float64).astype(clim.dtype))
    rows = [[_slot(clim, int(t), mean_field) for t in row] for row in times]
    if is_torch:
        out = torch.stack([torch.stack(r) for r in rows])
    else:
        out = np.stack([np.stack(r) for r in rows]).astype(clim.dtype)
    return out.reshape(target_shape)


class SkillSums:
    """Per-step fp64 sums of the skill metrics, on the forecasts' device.

    `add(k, forecast, target, clim, ...)` adds one batch's step k, each a
    (B, H, W, C) field; `report()` turns the sums into a `SkillReport`
    whose means are over every batch added."""

    def __init__(self, steps: int, channels: int, device=None):
        z = lambda: torch.zeros((steps, channels), dtype=torch.float64, device=device)  # noqa: E731
        self.model, self.norm, self.clim = z(), z(), z()
        self.num, self.ff, self.tt = z(), z(), z()
        self.points = [0] * steps
        self.has_norm = True

    def add(self, k: int, forecast, target, clim, forecast_norm=None, target_norm=None):
        self.model[k] += _sums(forecast, target)
        self.clim[k] += _sums(clim, target)
        num, ff, tt = _sums(forecast, target, clim)
        self.num[k] += num
        self.ff[k] += ff
        self.tt[k] += tt
        if forecast_norm is None or target_norm is None:
            self.has_norm = False
        else:
            self.norm[k] += _sums(forecast_norm, target_norm)
        self.points[k] += _points(forecast)

    def report(self) -> SkillReport:
        n = torch.as_tensor(self.points, dtype=torch.float64, device=self.model.device)[:, None]
        mse, mse_clim = self.model / n, self.clim / n
        mse_norm = self.norm / n if self.has_norm else torch.full_like(mse, float("nan"))
        skill = 1.0 - mse / torch.clamp(mse_clim, min=1e-12)
        acc = self.num / torch.clamp(torch.sqrt(self.ff * self.tt), min=1e-12)
        as_np = lambda t: t.cpu().numpy().astype(np.float32)  # noqa: E731
        return SkillReport(as_np(mse), as_np(mse_norm), as_np(mse_clim), as_np(skill),
                           acc=as_np(acc))


def climatology_step(climatology, k: int, target_shape: tuple, times=None,
                     device=None, binned: bool | None = None) -> torch.Tensor:
    """The climatology of step k of targets of shape (S, B, H, W, C), on
    `device`: a binned one (`binned`, by default `is_binned`) indexed by
    the step's valid times ((S, B) YYYYMMDDHH), else `climatology`
    broadcast to the targets (static, or per step)."""
    shape = tuple(target_shape)
    if is_binned(climatology, shape) if binned is None else binned:
        if times is None:
            raise ValueError(
                "a (doy, hour)-binned climatology needs `times` to index; "
                "pass Batch.times or pre-select the slots"
            )
        field = indexed_climatology(climatology, np.asarray(times)[k:k + 1],
                                    (1,) + shape[1:])[0]
    else:  # numpy broadcasting of the climatology to the targets, step k
        field = climatology
        if len(field.shape) == len(shape):
            field = field[k if field.shape[0] > 1 else 0]
    return torch.as_tensor(field, device=device).float().expand(shape[1:])


def evaluate_rollout(forecasts, targets, climatology, forecasts_norm=None,
                     targets_norm=None, times=None) -> SkillReport:
    """forecasts / targets: (S, B, H, W, C) tensors (or arrays) in real space;
    climatology broadcastable to the targets (static or per step) or
    (doy, hour)-binned ((365|366, 4, H, W, C)), in which case `times`
    ((S, B) YYYYMMDDHH valid times) selects the slot per target (reference
    eval indexing, sfno/model.py:1331-1416)."""
    forecasts, targets = torch.as_tensor(forecasts), torch.as_tensor(targets)
    forecasts_norm = None if forecasts_norm is None else torch.as_tensor(forecasts_norm)
    targets_norm = None if targets_norm is None else torch.as_tensor(targets_norm)
    s, c = forecasts.shape[0], forecasts.shape[-1]
    sums = SkillSums(s, c, forecasts.device)
    for k in range(s):
        clim = climatology_step(climatology, k, targets.shape, times, forecasts.device)
        sums.add(k, forecasts[k], targets[k], clim,
                 None if forecasts_norm is None else forecasts_norm[k],
                 None if targets_norm is None else targets_norm[k])
    return sums.report()


def hourly_climatology(fields, day_of_year, hour, n_doy: int = 366,
                       n_hour: int = 4) -> torch.Tensor:
    """A (day-of-year, hour)-indexed climatology of a field archive
    (reference weatherbench 1990-2019 climatology by (dayofyear, hour),
    model.py:1331-1416): fields (N, H, W, C), a tensor or an array, summed
    in fp64 on its device; returns (n_doy, n_hour, H, W, C) fp32.  Bins
    with no sample take the archive mean (an all-zero climatology would
    make mse_clim the raw magnitude and inflate the skill)."""
    fields = torch.as_tensor(fields)
    dev = fields.device
    slot = (torch.as_tensor(np.asarray(day_of_year), device=dev).long() - 1) * n_hour \
        + torch.as_tensor(np.asarray(hour) // 6, device=dev).long()
    out = torch.zeros((n_doy * n_hour,) + tuple(fields.shape[1:]), dtype=torch.float64,
                      device=dev)
    out.index_add_(0, slot, fields.double())
    cnt = torch.bincount(slot, minlength=n_doy * n_hour)
    empty = cnt == 0
    if bool(empty.any()):
        log.warning("climatology: %d of %d (doy, hour) bins have no samples; "
                    "filling with the archive mean", int(empty.sum()), empty.numel())
        out[empty] = fields.double().mean(dim=0)
        cnt = torch.where(empty, torch.ones_like(cnt), cnt)
    out = out / cnt.double().reshape((-1,) + (1,) * (fields.dim() - 1))
    return out.float().reshape((n_doy, n_hour) + tuple(fields.shape[1:]))
