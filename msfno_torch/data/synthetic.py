"""Synthetic inputs (port of msfno_tpu/data/synthetic.py:20-105): batches with
the nested structure of the real dataset, from the same numpy RNG calls, so
one seed gives both packages the same arrays."""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class Batch:
    """One training sample group: `era5[s]` is the state at step s,
    `sst[s]` the SST window ending at step s (None if the model has no film).

    era5: (S, B, H, W, C) float32, S = multi_step + 2
    sst:  (S, B, T, Hs, Ws) float32 with NaN over land, or None
    times: (S, B) int64 YYYYMMDDHH (0 for synthetic)
    """

    era5: np.ndarray
    sst: np.ndarray | None
    times: np.ndarray


def synthetic_land_mask(h: int, w: int, seed: int = 0, frac: float = 0.3) -> np.ndarray:
    """Deterministic pseudo-continent mask (True = land) from thresholded
    low-frequency noise."""
    rng = np.random.default_rng(seed)
    ky, kx = 4, 8
    coeff = rng.standard_normal((ky, kx, 2))
    yy = np.linspace(0, 2 * np.pi, h, endpoint=False)
    xx = np.linspace(0, 2 * np.pi, w, endpoint=False)
    field = np.zeros((h, w))
    for i in range(ky):
        for j in range(kx):
            field += coeff[i, j, 0] * np.outer(np.cos(i * yy), np.cos(j * xx))
            field += coeff[i, j, 1] * np.outer(np.sin(i * yy + 0.3), np.sin(j * xx))
    thresh = np.quantile(field, 1.0 - frac)
    return field > thresh


def gen_batch(cfg, batch_size: int = 1, multi_step: int = 0, seed: int = 0,
              land_mask: np.ndarray | None = None) -> Batch:
    """A synthetic batch for an `SFNOConfig` (reference gen_test_data,
    train.py:1210-1243): standard-normal states and SST windows, NaN over
    the land mask."""
    rng = np.random.default_rng(seed)
    s = multi_step + 2
    h, w = cfg.img_size
    era5 = rng.standard_normal((s, batch_size, h, w, cfg.in_chans)).astype(np.float32)
    sst = None
    if cfg.film is not None:
        hs, ws = cfg.film.sst_shape
        t = cfg.film.temporal_step
        sst = rng.standard_normal((s, batch_size, t, hs, ws)).astype(np.float32)
        if land_mask is None:
            land_mask = synthetic_land_mask(hs, ws)
        sst[..., land_mask] = np.nan
    times = np.zeros((s, batch_size), dtype=np.int64)
    return Batch(era5=era5, sst=sst, times=times)


def synthetic_loader(cfg, batch_size: int = 1, multi_step: int = 0, num_batches: int = 10,
                     seed: int = 0) -> Iterator[Batch]:
    hs_ws = cfg.film.sst_shape if cfg.film is not None else (0, 0)
    mask = synthetic_land_mask(*hs_ws) if cfg.film is not None else None
    for i in range(num_batches):
        yield gen_batch(cfg, batch_size, multi_step, seed=seed + i, land_mask=mask)
