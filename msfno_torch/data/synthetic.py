"""Synthetic inputs (port of msfno_tpu/data/synthetic.py): batches with the
nested structure of the real dataset, SST histories and the SST-coupled
dynamics of the film fine-tune demo, from the same numpy RNG calls, so one
seed gives both packages the same arrays."""

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


def synthetic_sst(rng: np.random.Generator, batch_size: int, temporal_step: int,
                  hs: int, ws: int, land_mask: np.ndarray | None = None) -> np.ndarray:
    """One (B, T, Hs, Ws) SST history batch with NaN over land, the MAE
    pretraining input shape (reference gen_test_data's sst component,
    train.py:1210-1243)."""
    sst = rng.standard_normal((batch_size, temporal_step, hs, ws)).astype(np.float32)
    if land_mask is None:
        land_mask = synthetic_land_mask(hs, ws)
    sst[..., land_mask] = np.nan
    return sst


def synthetic_loader(cfg, batch_size: int = 1, multi_step: int = 0, num_batches: int = 10,
                     seed: int = 0) -> Iterator[Batch]:
    hs_ws = cfg.film.sst_shape if cfg.film is not None else (0, 0)
    mask = synthetic_land_mask(*hs_ws) if cfg.film is not None else None
    for i in range(num_batches):
        yield gen_batch(cfg, batch_size, multi_step, seed=seed + i, land_mask=mask)


def gen_coupled_batches(cfg, num_batches: int, batch_size: int = 1, multi_step: int = 0,
                        seed: int = 0, coupling: float = 1.0, decay: float = 0.9,
                        burn_in: int = 4) -> list[Batch]:
    """SST-coupled synthetic dynamics, where film conditioning carries real
    predictive signal (the JAX package's film fine-tune demo):

        x_s   = decay * smooth(x_{s-1}) + coupling * nu_s * c
        sst_s = S_base + nu_s * S_anom          (NaN over land)

    nu_s ~ iid U(-1, 1), so the state carries no information about nu_s and
    an unfilmed model's one-step MSE has a floor of coupling^2 E[nu^2]; a
    filmed model reads nu_s from the SST window of the target step.  c is a
    per-channel constant vector (a channelwise shift, what FiLM expresses),
    smooth() a periodic 4-neighbour average."""
    rng = np.random.default_rng(seed)
    h, w = cfg.img_size
    c_ch = cfg.in_chans
    s_len = multi_step + 2
    hs, ws = cfg.film.sst_shape
    t_win = cfg.film.temporal_step
    mask = synthetic_land_mask(hs, ws)

    # structures shared by every batch, from their own seed so that
    # num_batches does not change them
    srng = np.random.default_rng(seed + 987)
    c_vec = srng.standard_normal(c_ch).astype(np.float32)
    c_vec /= np.sqrt(np.mean(c_vec ** 2))
    s_base = srng.standard_normal((hs, ws)).astype(np.float32)
    s_anom = 1.0 + 0.5 * srng.standard_normal((hs, ws)).astype(np.float32)

    def smooth(x):  # periodic 4-neighbour average over (B, H, W, C)
        return 0.25 * (np.roll(x, 1, axis=1) + np.roll(x, -1, axis=1)
                       + np.roll(x, 1, axis=2) + np.roll(x, -1, axis=2))

    batches = []
    for _ in range(num_batches):
        x = rng.standard_normal((batch_size, h, w, c_ch)).astype(np.float32)
        for _ in range(burn_in):
            x = decay * smooth(x) + coupling * rng.uniform(-1, 1) * c_vec
        era5 = np.empty((s_len, batch_size, h, w, c_ch), np.float32)
        sst = np.empty((s_len, batch_size, t_win, hs, ws), np.float32)
        era5[0] = x
        sst[0] = s_base + rng.uniform(-1, 1) * s_anom
        for s in range(1, s_len):
            nu = rng.uniform(-1, 1)
            era5[s] = decay * smooth(era5[s - 1]) + coupling * nu * c_vec
            sst[s] = s_base + nu * s_anom
        sst[..., mask] = np.nan
        batches.append(Batch(era5=era5, sst=sst, times=np.zeros((s_len, batch_size), np.int64)))
    return batches
