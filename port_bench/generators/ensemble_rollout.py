"""Mix kind `ensemble_rollout`: `initial_states` forecasts of `members`
members (a seeded state plus a seeded perturbation each), a SST series per
forecast whose `temporal_step`-day window advances a day every
`steps_per_day` steps, handed to the program as host arrays; a forecast
runs `lead_time_h` hours in steps of `step_hours`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from port_bench.harness.common import derive_seed
from port_bench.harness.traffic import land_mask, smooth_field, sst_series


class SSTWindows:
    """The per-step SST inputs of a forecast: step i sees the
    `temporal_step` days of `series` (B, days, hs, ws) that start at day
    i // steps_per_day (a view, no copy)."""

    def __init__(self, series: np.ndarray, temporal_step: int, steps_per_day: int, steps: int):
        self.series, self.t, self.k, self.steps = series, temporal_step, steps_per_day, steps

    def __len__(self):
        return self.steps

    def __getitem__(self, i: int) -> np.ndarray:
        if not 0 <= i < self.steps:
            raise IndexError(i)
        d = i // self.k
        return self.series[:, d:d + self.t]


def rollout_steps(mix: dict) -> int:
    return mix["lead_time_h"] // mix["step_hours"]


def forecast(mix: dict, cfg: dict, seed: int, index: int, device):
    """Forecast `index` of the mix's pool: (x0 (B, H, W, C) fp32 host array,
    SST series (B, days, hs, ws) host array or None)."""
    b = mix["members"]
    h, w = cfg["img_size"]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, f"forecast{index}"))
    base = smooth_field(gen, (1, h, w, cfg["in_chans"]), device)
    pert = torch.randn((b, h, w, cfg["in_chans"]), generator=gen, device=device)
    x0 = (base + mix["perturbation"] * pert).cpu().numpy()
    series = None
    film = cfg.get("film")
    if film is not None:
        t, (hs, ws) = film["temporal_step"], film["sst_shape"]
        days = t + math.ceil(rollout_steps(mix) / mix["steps_per_day"])
        land = land_mask(hs, ws, cfg["assumed"]["land_share"])
        series = sst_series(gen, b, days, hs, ws, land, device).cpu().numpy()
    return x0, series


def sst_windows(mix: dict, cfg: dict, series):
    if series is None:
        return None
    return SSTWindows(series, cfg["film"]["temporal_step"], mix["steps_per_day"],
                      rollout_steps(mix))
