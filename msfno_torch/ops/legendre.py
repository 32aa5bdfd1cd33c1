"""Normalized associated Legendre functions, precomputed in float64 numpy.

Replaces the torch_harmonics ``_precompute_legpoly`` machinery the reference
depends on (used via harmonics.RealSHT in MSFNO/Models/sfno/sfnonet.py:532-555).
Computed host-side once per (grid, lmax, mmax) and cached; only fp32 tensors
are moved to the device.  A copy of msfno_tpu/ops/legendre.py, kept here so
the port imports no module of the JAX package.

Normalization ("ortho"): Pbar_l^m(x) = sqrt((2l+1)/(4 pi) * (l-m)!/(l+m)!) P_l^m(x)
so that the spherical harmonics Y_l^m = Pbar_l^m(cos theta) e^{i m phi} are
orthonormal over the sphere:

    integral_{-1}^{1} Pbar_l^m Pbar_l'^m dx = delta_{l l'} / (2 pi)

Condon-Shortley phase (-1)^m is included when ``csphase=True`` (scipy's
``sph_harm_y`` convention, and torch_harmonics' default).
"""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=32)
def _legendre_cached(lmax: int, mmax: int, x_key: bytes, nlat: int, csphase: bool):
    x = np.frombuffer(x_key, dtype=np.float64).copy()
    return _legendre_impl(lmax, mmax, x, csphase)


def legendre_matrix(
    lmax: int, mmax: int, x: np.ndarray, csphase: bool = True
) -> np.ndarray:
    """Pbar tensor of shape (mmax, lmax, nlat); zero where l < m.

    Parameters
    ----------
    lmax : number of retained degrees l = 0..lmax-1.
    mmax : number of retained orders m = 0..mmax-1.
    x : (nlat,) cos(theta) nodes.
    """
    x = np.asarray(x, dtype=np.float64)
    return _legendre_cached(lmax, mmax, x.tobytes(), len(x), csphase)


def _legendre_impl(lmax: int, mmax: int, x: np.ndarray, csphase: bool) -> np.ndarray:
    nlat = x.shape[0]
    lmax_eff = max(lmax, mmax)  # recurrences need l up to max(l, m)-1
    pct = np.zeros((mmax, lmax_eff, nlat), dtype=np.float64)
    sinx = np.sqrt(np.clip(1.0 - x * x, 0.0, None))  # sin(theta) >= 0

    # P^bar_0^0
    pmm = np.full(nlat, np.sqrt(1.0 / (4.0 * np.pi)))
    cs = -1.0 if csphase else 1.0
    for m in range(mmax):
        if m > 0:
            # Pbar_m^m = cs * sqrt((2m+1)/(2m)) sin(theta) Pbar_{m-1}^{m-1}
            pmm = cs * np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * sinx * pmm
        if m < lmax_eff:
            pct[m, m] = pmm
        if m + 1 < lmax_eff:
            # Pbar_{m+1}^m = sqrt(2m+3) x Pbar_m^m
            pct[m, m + 1] = np.sqrt(2.0 * m + 3.0) * x * pmm
        for l in range(m + 2, lmax_eff):
            a = np.sqrt((4.0 * l * l - 1.0) / (l * l - m * m))
            b = np.sqrt(((l - 1.0) ** 2 - m * m) / (4.0 * (l - 1.0) ** 2 - 1.0))
            pct[m, l] = a * (x * pct[m, l - 1] - b * pct[m, l - 2])

    return np.ascontiguousarray(pct[:, :lmax, :])
