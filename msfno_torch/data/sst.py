"""SST helpers (port of msfno_tpu/data/sst.py; reference SST_galvani,
MSFNO/Models/data.py:233-397): coarsening, the Nino-3.4 box, an SST-only npy
store of history windows and the ONI (Oceanic Nino Index).  numpy only, so
both packages give the same arrays bit for bit."""

from __future__ import annotations

import os
import re
import warnings

import numpy as np

# Nino-3.4 box: 5S-5N, 170W-120W
NINO34_LAT = (-5.0, 5.0)
NINO34_LON = (190.0, 240.0)


def coarsen(field: np.ndarray, factor: int) -> np.ndarray:
    """Mean-pool (..., H, W) by `factor` (the reference's 4x coarsening of
    the 0.25-degree SST to 1 degree, data.py:198-213).  NaN-aware: a cell is
    NaN only where all of its pixels are (land)."""
    h, w = field.shape[-2:]
    h2, w2 = h // factor, w // factor
    x = field[..., : h2 * factor, : w2 * factor]
    x = x.reshape(*x.shape[:-2], h2, factor, w2, factor)
    # all-NaN cells are the expected output NaNs: silence numpy's "Mean of
    # empty slice" warning for them
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Mean of empty slice",
                                category=RuntimeWarning)
        return np.nanmean(x, axis=(-3, -1))


def nino34_mask(lat: np.ndarray, lon: np.ndarray) -> np.ndarray:
    """(H, W) bool mask of the Nino-3.4 box."""
    la = (lat >= NINO34_LAT[0]) & (lat <= NINO34_LAT[1])
    lo = (lon >= NINO34_LON[0]) & (lon <= NINO34_LON[1])
    return la[:, None] & lo[None, :]


def frame_indices(root: str, kind: str) -> list[int]:
    """The sorted indices of the exact `{kind}_NNNNNN.npy` frame files under
    `root` (a stray `{kind}_mean.npy` or `*.tmp` does not count)."""
    pattern = re.compile(rf"{kind}_(\d{{6}})\.npy")
    return sorted(int(m.group(1)) for f in os.listdir(root) if (m := pattern.fullmatch(f)))


class SSTNpyStore:
    """SST-only npy store -> (T, H, W) history windows for MAE pretraining.

    Layout: {root}/sst_{idx:06d}.npy, one (H, W) frame (NaN over land) per
    6-hour step, the SST half of the combined era5 + sst store standing
    alone; no era5_*.npy is read.  The indices must run 0, 1, ... without a
    gap (checked here, not mid-training)."""

    def __init__(self, root: str, temporal_step: int = 28):
        self.root = root
        self.temporal_step = temporal_step
        idcs = frame_indices(root, "sst")
        self.n = len(idcs)
        if idcs and idcs != list(range(idcs[0], idcs[0] + len(idcs))):
            missing = sorted(set(range(idcs[0], idcs[-1] + 1)) - set(idcs))
            raise FileNotFoundError(
                f"sst_*.npy indices not contiguous under {root}: "
                f"missing {missing[:5]}{'...' if len(missing) > 5 else ''}")
        if idcs and idcs[0] != 0:
            raise FileNotFoundError(
                f"sst_*.npy indices must start at 0, found {idcs[0]} under {root}")
        if self.n < temporal_step:
            raise FileNotFoundError(
                f"need >= {temporal_step} sst_*.npy frames under {root}, found {self.n}")

    def __len__(self) -> int:
        return self.n - self.temporal_step + 1

    def window(self, idx: int) -> np.ndarray:
        """(T, H, W) frames idx .. idx+T-1."""
        return np.stack([np.load(os.path.join(self.root, f"sst_{idx + k:06d}.npy"))
                         for k in range(self.temporal_step)])

    def batches(self, batch_size: int, epochs: int = 1, seed: int = 0, shuffle: bool = True):
        """(B, T, H, W) float32 batches; a deterministic reshuffle per epoch
        (`default_rng(seed + epoch)`), the trailing partial batch dropped."""
        for epoch in range(epochs):
            order = np.arange(len(self))
            if shuffle:
                np.random.default_rng(seed + epoch).shuffle(order)
            for b in range(len(order) // batch_size):
                idcs = order[b * batch_size: (b + 1) * batch_size]
                yield np.stack([self.window(int(i)) for i in idcs]).astype(np.float32)


def compute_oni(sst: np.ndarray, day_of_year: np.ndarray, lat: np.ndarray, lon: np.ndarray,
                smooth_days: int = 90, samples_per_day: int = 1) -> np.ndarray:
    """ONI: the Nino-3.4 SST anomaly against a day-of-year climatology,
    smoothed by a running mean of about 3 months (reference
    data.py:331-369).

    sst: (N, H, W) with NaN over land; day_of_year: (N,) in 1..366.
    `samples_per_day` scales the window to the series' cadence (4 for a
    6-hourly series, so that smooth_days counts days)."""
    box = nino34_mask(lat, lon)
    with np.errstate(invalid="ignore"):
        series = np.asarray([np.nanmean(s[box]) for s in sst], dtype=np.float64)
    clim = np.zeros(367)
    cnt = np.zeros(367)
    for v, d in zip(series, day_of_year):
        if np.isfinite(v):
            clim[d] += v
            cnt[d] += 1
    clim = clim / np.maximum(cnt, 1)
    anom = series - clim[day_of_year]
    k = max(smooth_days * samples_per_day, 1)
    kernel = np.ones(k) / k
    pad = np.pad(anom, (k // 2, k - 1 - k // 2), mode="edge")
    return np.convolve(pad, kernel, mode="valid").astype(np.float32)
