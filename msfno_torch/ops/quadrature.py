"""Quadrature rules on the sphere's latitude axis.

The reference relies on torch_harmonics' ``legendre_gauss_weights`` and
``clenshaw_curtiss_weights`` (invoked indirectly via
MSFNO/Models/sfno/sfnonet.py:532-548 with grid="legendre-gauss" /
"equiangular").  Here both rules are computed from scratch in float64 numpy at
trace time; only the resulting fp32 weight tensors reach the device.

Conventions
-----------
All rules integrate over x = cos(theta) in [-1, 1]:

    integral_{-1}^{1} f(x) dx  ~=  sum_k w_k f(x_k)

Nodes are returned **north-to-south** (x descending from +1 to -1, i.e.
latitude descending 90 -> -90), matching the ERA5 / reference grid ordering.

A copy of msfno_tpu/ops/quadrature.py, kept here so the port imports no
module of the JAX package.
"""

from __future__ import annotations

import numpy as np


def legendre_gauss(nlat: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre nodes/weights, north-to-south.

    Returns
    -------
    x : (nlat,) float64, cos(theta), descending.
    w : (nlat,) float64, quadrature weights (sum to 2).
    """
    x, w = np.polynomial.legendre.leggauss(nlat)
    # leggauss returns ascending x; flip to north-first ordering.
    return x[::-1].copy(), w[::-1].copy()


def clenshaw_curtis(nlat: int) -> tuple[np.ndarray, np.ndarray]:
    """Clenshaw-Curtis nodes/weights on the equiangular grid, north-to-south.

    Nodes are theta_j = j*pi/(nlat-1), j = 0..nlat-1 (both poles included),
    i.e. the Chebyshev-Lobatto points x_j = cos(theta_j), which is exactly the
    0.25-degree 721-point ERA5 latitude grid.  Weights are the classical
    Clenshaw-Curtis weights for integration of f(x) dx over [-1, 1].
    """
    if nlat < 2:
        raise ValueError("clenshaw_curtis needs nlat >= 2")
    n = nlat - 1
    theta = np.arange(nlat) * np.pi / n
    x = np.cos(theta)

    # Classical CC weights via the cosine-sum formula (float64).
    #   w_j = (c_j / n) * (1 - sum_{k=1}^{n/2} b_k/(4k^2-1) * cos(2k theta_j))
    # with b_k = 1 for k = n/2 else 2, c_j = 1 at endpoints else 2.
    w = np.zeros(nlat, dtype=np.float64)
    kmax = n // 2
    k = np.arange(1, kmax + 1)
    b = np.full(kmax, 2.0)
    if n % 2 == 0 and kmax >= 1:
        b[-1] = 1.0
    for j in range(nlat):
        s = np.sum(b / (4.0 * k**2 - 1.0) * np.cos(2.0 * k * theta[j])) if kmax else 0.0
        w[j] = (2.0 / n) * (1.0 - s)
    w[0] *= 0.5
    w[-1] *= 0.5
    return x, w


def equiangular_nodes(nlat: int) -> np.ndarray:
    """Equiangular colatitude nodes theta_j = j*pi/(nlat-1) (poles included)."""
    return np.arange(nlat) * np.pi / (nlat - 1)


_GRIDS = {
    "legendre-gauss": legendre_gauss,
    "equiangular": clenshaw_curtis,
}


def grid_quadrature(grid: str, nlat: int) -> tuple[np.ndarray, np.ndarray]:
    """Nodes (cos theta, descending) and weights for a named grid."""
    try:
        fn = _GRIDS[grid]
    except KeyError:
        raise ValueError(f"unknown grid {grid!r}; choose from {sorted(_GRIDS)}")
    return fn(nlat)
