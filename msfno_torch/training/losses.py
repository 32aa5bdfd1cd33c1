"""Loss functions (port of msfno_tpu/training/losses.py:22-96,290-329;
reference MSFNO/Models/losses.py), channels-last (B, H, W, C).

The default is `L2Sphere_noSine` as the registry builds it: relative and
squared (reference create_loss, train.py:436-440), not the function's own
`squared=False` default.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from msfno_torch.ops.quadrature import legendre_gauss


@functools.lru_cache(maxsize=8)
def _gauss_w(h: int) -> np.ndarray:
    # Gauss-Legendre weights on the output grid's H, whatever the grid type
    # (the reference's quadrature helper, losses.py:90,129)
    _, w = legendre_gauss(h)
    return np.asarray(w, dtype=np.float32)


@functools.lru_cache(maxsize=8)
def _cos_jacobian(h: int) -> np.ndarray:
    return np.abs(np.cos(np.linspace(-np.pi / 2, np.pi / 2, h))).astype(np.float32)


def _column(w: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(w, device=like.device)[:, None, None]


def cosine_mse(prd, tar, reduction: str = "mean", eps: float = 1e-4):
    """Cos-lat weighted MSE (reference CosineMSELoss, losses.py:6-28)."""
    h, w = prd.shape[-3], prd.shape[-2]
    wts = np.clip(np.cos(np.linspace(-np.pi / 2, np.pi / 2, h)), 0.0, None) + eps
    wts = (wts / wts.sum()).astype(np.float32)
    loss = (prd - tar) ** 2 * _column(wts, prd)
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum() / w
    return loss


def _l2_sphere_impl(prd, tar, sphere_weights, relative: bool, squared: bool, reduction: str):
    if reduction == "none":
        loss = sphere_weights * (prd - tar) ** 2
        if relative:
            loss = loss / (sphere_weights * tar ** 2).sum((-3, -2), keepdim=True)
        return loss
    loss = (sphere_weights * (prd - tar) ** 2).sum((-3, -2))
    if relative:
        loss = loss / (sphere_weights * tar ** 2).sum((-3, -2))
    if not squared:
        loss = torch.sqrt(loss)
    return loss.sum()  # "sum" and "mean" both sum (losses.py:113-117)


def l2_sphere(prd, tar, relative: bool = True, squared: bool = False, reduction: str = "sum"):
    """Quadrature x cos-jacobian weighted relative L2 (reference L2Sphere,
    losses.py:80-117)."""
    h = prd.shape[-3]
    w = _column(np.abs(_gauss_w(h) * _cos_jacobian(h)), prd)
    return _l2_sphere_impl(prd, tar, w, relative, squared, reduction)


def l2_sphere_nosine(prd, tar, relative: bool = True, squared: bool = False,
                     reduction: str = "sum"):
    """Quadrature-only weighted relative L2, the training default (reference
    L2Sphere_noSine, losses.py:119-155)."""
    return _l2_sphere_impl(prd, tar, _column(_gauss_w(prd.shape[-3]), prd), relative,
                           squared, reduction)


LOSSES = {
    "CosineMSE": cosine_mse,
    "L2Sphere": functools.partial(l2_sphere, relative=True, squared=True),
    "L2Sphere_noSine": functools.partial(l2_sphere_nosine, relative=True, squared=True),
    "MSE": lambda p, t: ((p - t) ** 2).mean(),
    "L1": lambda p, t: (p - t).abs().mean(),
}

# the JAX registry's spectral family, which needs the loss SHT
_SPECTRAL = ("SpectralL2Sphere", "SpectralSphere", "H1Sphere")


def get_loss(name: str, model_cfg=None):
    """Resolve a --loss-fn name (the JAX `get_loss`)."""
    del model_cfg  # the JAX package truncates the spectral losses' SHT with it
    if name in _SPECTRAL:
        raise NotImplementedError(
            f"loss {name!r}: the spectral losses come in a later slice; ported: "
            f"{sorted(LOSSES)}"
        )
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; choose from {sorted(LOSSES)}") from None
