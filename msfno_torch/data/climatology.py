"""Offline climatology (port of msfno_tpu/data/climatology.py; reference
data_process/climatology.py:55-106): the mean state per (day of year, 6-hour
slot) over years, leap days dropped, over any backend with
era5(idx) -> (H, W, C) on a 6-hourly index.  numpy only."""

from __future__ import annotations

from calendar import isleap

import numpy as np

from msfno_torch.data.era5 import STEPS_PER_DAY


def build_climatology(backend, dataset_start_year: int, years: list[int],
                      out_path: str | None = None) -> np.ndarray:
    """(365, 4, H, W, C) float32 mean over `years`; Feb 29 is dropped
    (reference climatology.py:74-79).  Reads go through the backend's bulk
    `era5_batch` when it has one, 8 days at a time."""
    sample = backend.era5(0)
    clim = np.zeros((365, STEPS_PER_DAY) + sample.shape, dtype=np.float64)
    count = 0
    batch_read = getattr(backend, "era5_batch", None)
    chunk_days = 8

    for year in years:
        idx = STEPS_PER_DAY * sum(366 if isleap(y) else 365
                                  for y in range(dataset_start_year, year))
        # (store index, day-of-year slot, hour slot) of every kept step
        pairs = []
        for doy in range(366 if isleap(year) else 365):
            target_doy = doy
            if isleap(year):
                if doy == 59:  # Feb 29
                    idx += STEPS_PER_DAY
                    continue
                if doy > 59:
                    target_doy = doy - 1
            for h in range(STEPS_PER_DAY):
                pairs.append((idx, target_doy, h))
                idx += 1
        step = chunk_days * STEPS_PER_DAY
        for c in range(0, len(pairs), step):
            part = pairs[c:c + step]
            if batch_read is not None:
                fields = batch_read([p[0] for p in part])
            else:
                fields = [backend.era5(p[0]) for p in part]
            for (_, target_doy, h), field in zip(part, fields):
                clim[target_doy, h] += field
        count += 1

    clim = (clim / max(count, 1)).astype(np.float32)
    if out_path:
        np.save(out_path, clim)
    return clim


def climatology_at(clim: np.ndarray, day_of_year: int, hour: int,
                   leap_year: bool = False) -> np.ndarray:
    """The climatology of a (day of year 1..366, hour) (reference eval
    indexing, sfno/model.py:1331-1416).  The 365 slots drop the leap day:
    in a leap year Feb 29 reads the Feb 28 slot and every later day the slot
    one before its day of year."""
    doy = day_of_year - 1
    if leap_year:
        if doy == 59:
            doy = 58
        elif doy > 59:
            doy -= 1
    return clim[min(doy, 364), (hour // 6) % STEPS_PER_DAY]
