"""The traffic generator's shared pieces, and the generator of a mix found
by name: a mix (`traffic/<mix>.json`) is data, and its `kind` names the
module of `generators/` that turns its parameters and the run's seed into
the inputs a cell feeds the program.  A new kind of mix is a new file
there.

Fields are normalised-space states, channels-last (B, H, W, C): a smooth
large-scale part (a coarse normal field upsampled bilinearly) plus
small-scale noise.  SST is a daily series on the coarse SST grid with NaN
over a fixed land mask (the same ocean graph for every seed).  Every seed
draws the same sizes; only the values change.
"""

from __future__ import annotations

import importlib

import torch
import torch.nn.functional as F

COARSE = 24  # grid points per coarse cell of the smooth part


def smooth_field(gen, shape, device, noise: float = 0.3) -> torch.Tensor:
    """(B, H, W, C) fp32: a unit-scale smooth field plus `noise` white."""
    b, h, w, c = shape
    coarse = torch.randn((b, c, h // COARSE + 2, w // COARSE + 2), generator=gen, device=device)
    big = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)
    out = big.permute(0, 2, 3, 1).contiguous()
    out.add_(torch.randn(out.shape, generator=gen, device=device), alpha=noise)
    return out


def land_mask(hs: int, ws: int, share: float) -> torch.Tensor:
    """(hs, ws) bool, True over land on `share` of the grid: a smooth field
    from a fixed generator, thresholded at its quantile."""
    gen = torch.Generator().manual_seed(20240601)
    field = smooth_field(gen, (1, hs, ws, 1), "cpu", noise=0.0)[0, :, :, 0]
    return field > torch.quantile(field.flatten(), 1.0 - share)


def sst_series(gen, b: int, days: int, hs: int, ws: int, land: torch.Tensor, device):
    """(B, days, hs, ws) fp32 daily SST anomalies, NaN over land: a smooth
    field that drifts by a tenth of its scale a day."""
    base = smooth_field(gen, (b, hs, ws, 1), device)[..., 0]
    drift = torch.randn((b, days, hs, ws), generator=gen, device=device).mul_(0.1)
    series = base[:, None] + torch.cumsum(drift, dim=1)
    return series.masked_fill_(land.to(device), float("nan"))


def generator(mix: dict):
    """`generators/<kind>.py` of the mix."""
    return importlib.import_module(f"port_bench.generators.{mix['kind']}")
