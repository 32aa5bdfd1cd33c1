"""Synthetic inputs (port of `synthetic_land_mask`,
msfno_tpu/data/synthetic.py:35)."""

from __future__ import annotations

import numpy as np


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
