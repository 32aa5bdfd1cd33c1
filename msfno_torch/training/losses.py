"""Loss functions (port of msfno_tpu/training/losses.py; reference
MSFNO/Models/losses.py), channels-last (B, H, W, C).

The default is `L2Sphere_noSine` as the registry builds it: relative and
squared (reference create_loss, train.py:436-440), not the function's own
`squared=False` default.  The spectral family (SpectralL2Sphere,
SpectralSphere, H1Sphere) measures the error in SHT space, through an
equiangular `RealSHT` on the matmul path, differentiable, cached per shape
and truncated to the model's modes when `get_loss` is given its config.
`fluct_l2loss_sphere` and the distributional losses (`normal_crps`,
`beta_nll`, `statistical_loss`) are library functions only, as in the JAX
package: `get_loss` does not reach them.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from msfno_torch.ops.quadrature import legendre_gauss
from msfno_torch.ops.sht import RealSHT
from msfno_torch.utils.observability import upload


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
    return upload(w, like.device)[:, None, None]


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


def _spectral_norm2(coeffs, spectral_weights=None):
    """|a|^2 summed over modes with the m > 0 doubling, then over l and the
    channels (reference losses.py:160-163): coeffs (2, B, L, M, C) -> (B,)."""
    p = coeffs[0] ** 2 + coeffs[1] ** 2
    if spectral_weights is not None:
        p = p * spectral_weights
    norm2 = p[..., 0, :] + 2.0 * p[..., 1:, :].sum(-2)
    return norm2.sum((-2, -1))


def spectral_l2loss_sphere(sht, prd, tar, relative: bool = False, squared: bool = True):
    """(reference spectral_l2loss_sphere, losses.py:158-176): per-sample norm
    summed over channels and modes, relative per sample, batch mean."""
    loss = _spectral_norm2(sht(prd - tar))
    if relative:
        loss = loss / _spectral_norm2(sht(tar))
    if not squared:
        loss = torch.sqrt(loss)
    return loss.mean()


@functools.lru_cache(maxsize=8)
def _l_weights(lmax: int) -> np.ndarray:
    ls = np.arange(lmax, dtype=np.float32)
    return (ls * (ls + 1.0))[:, None, None]


def spectral_loss_sphere(sht, prd, tar, relative: bool = False, squared: bool = True):
    """l(l+1)-weighted spectral loss (reference losses.py:178-203)."""
    sw = upload(_l_weights(sht.lmax), prd.device)
    loss = _spectral_norm2(sht(prd - tar), sw)
    if relative:
        loss = loss / _spectral_norm2(sht(tar), sw)
    if not squared:
        loss = torch.sqrt(loss)
    return loss.mean()


def h1loss_sphere(sht, prd, tar, squared: bool = True):
    """H1-style loss (reference losses.py:205-232)."""
    coeffs = sht(prd - tar)
    h1 = _spectral_norm2(coeffs, upload(_l_weights(sht.lmax), prd.device))
    l2 = _spectral_norm2(coeffs)
    loss = (h1 + l2) if squared else (torch.sqrt(h1) + torch.sqrt(l2))
    return loss.mean()


def fluct_l2loss_sphere(sht_weights, prd, tar, inp, relative: bool = False):
    """Fluctuation-weighted L2 (reference losses.py:234-244): each channel's
    error weighted by its share of the fluctuation |tar - inp|^2; sht_weights
    (H,) are the grid's quadrature weights.  With relative=True the weight
    cancels (as upstream), leaving a plain relative L2."""
    w = upload(sht_weights, prd.device, prd.dtype)[:, None, None]
    integ = lambda f: (w * f).sum((-3, -2))  # noqa: E731
    fluct = integ((tar - inp) ** 2)
    weight = fluct / fluct.sum(-1, keepdim=True)
    loss = weight * integ((prd - tar) ** 2)
    if relative:
        loss = loss / (weight * integ(tar ** 2))
    return loss.mean()


def _sigma_transform(sigma, kind: str):
    if kind == "softplus":
        return torch.nn.functional.softplus(sigma)
    if kind == "exp":
        return torch.exp(sigma)
    if kind == "none":
        return sigma
    raise NotImplementedError(f"sigma transform {kind!r}")


def normal_crps(mu, sigma, observation, mask=None, reduction: str = "mean",
                sigma_transform: str = "softplus"):
    """CRPS of a normal predictive distribution, Gneiting et al. 2005
    (reference NormalCRPS, losses.py:248-311); `mask` is 1 where scored."""
    std = _sigma_transform(sigma, sigma_transform)
    z = (observation - mu) / std
    phi = torch.exp(-(z ** 2) / 2.0) / math.sqrt(2.0 * math.pi)
    score = std * (z * torch.erf(z / math.sqrt(2.0)) + 2.0 * phi - 1.0 / math.sqrt(math.pi))
    if reduction == "none":
        return score
    if mask is not None:
        m = mask.to(score.dtype)
        total = (score * m).sum()
        return total / torch.clamp(m.sum(), min=1.0) if reduction == "mean" else total
    return score.mean() if reduction == "mean" else score.sum()


def beta_nll(mu, sigma, observation, beta: float = 0.5, reduction: str = "mean",
             sigma_transform: str = "softplus"):
    """Beta negative log likelihood (reference Beta_NLL, losses.py:313-355):
    the Gaussian NLL weighted by var^beta, the weight outside the gradient."""
    var = _sigma_transform(sigma, sigma_transform)
    loss = 0.5 * ((observation - mu) ** 2 / var + torch.log(var))
    if beta > 0:
        loss = loss * var.detach() ** beta
    return loss.mean() if reduction == "mean" else loss.sum()


def statistical_loss(prediction, observation, ensemble_axis: int = -1,
                     reduction: str = "mean", corrected: bool = False):
    """AtmoRep's first-order statistical loss (reference StatisticalLoss,
    losses.py:357-400).  By default the reference's exp(+z^2 / 2), with no
    eps on the sigma divide, as upstream; corrected=True takes the intended
    exp(-z^2 / 2) with an eps-guarded sigma."""
    mu = prediction.mean(ensemble_axis)
    sigma = prediction.std(ensemble_axis, correction=0)
    if corrected:
        phi = torch.exp(-(((mu - observation) / (sigma + 1e-8)) ** 2) / 2.0)
    else:
        phi = torch.exp(((mu - observation) / sigma) ** 2 / 2.0)
    stat_dist = (1.0 - phi) ** 2
    member_dist = ((prediction - observation.unsqueeze(ensemble_axis)) ** 2).sum(ensemble_axis)
    score = stat_dist + member_dist + torch.sqrt(sigma)
    return score.mean() if reduction == "mean" else score.sum()


@functools.lru_cache(maxsize=4)
def _loss_sht(h: int, w: int, lmax, mmax) -> RealSHT:
    """The spectral losses' equiangular SHT (fp32, matmul DFT, no rescale),
    cached per output shape; its constants are cached per device."""
    return RealSHT(h, w, lmax=lmax, mmax=mmax, grid="equiangular", spectral_rescale=1.0)


def _spectral_loss_entry(fn, lmax=None, mmax=None):
    """`fn(sht, prd, tar)` as a (prd, tar) loss over an SHT matched to the
    output grid; lmax / mmax should be the model's truncation (the
    reference's solver is the net's truncated trans_down, sfnonet.py:532-545:
    untruncated at 721x1440 the Legendre weights alone take ~1.5 GB)."""

    def loss(prd, tar):
        return fn(_loss_sht(prd.shape[-3], prd.shape[-2], lmax, mmax), prd, tar)

    return loss


_SPECTRAL_LOSSES = {
    "SpectralL2Sphere": spectral_l2loss_sphere,
    "SpectralSphere": spectral_loss_sphere,
    "H1Sphere": h1loss_sphere,
}

LOSSES = {
    "CosineMSE": cosine_mse,
    "L2Sphere": functools.partial(l2_sphere, relative=True, squared=True),
    "L2Sphere_noSine": functools.partial(l2_sphere_nosine, relative=True, squared=True),
    "MSE": lambda p, t: ((p - t) ** 2).mean(),
    "L1": lambda p, t: (p - t).abs().mean(),
    **{name: _spectral_loss_entry(fn) for name, fn in _SPECTRAL_LOSSES.items()},
}


# the losses that sum over the batch's samples (the L2 losses); every other
# --loss-fn choice averages over them
_SAMPLE_SUMS = frozenset({"L2Sphere", "L2Sphere_noSine"})


def sums_over_samples(name: str) -> bool:
    """Whether the --loss-fn `name` sums over the batch's samples (else it
    averages over them): under a data mesh the ranks' losses and gradients
    add up to the global batch's for the first kind and average to it for
    the second."""
    get_loss(name)  # raises for an unknown name
    return name in _SAMPLE_SUMS


def get_loss(name: str, model_cfg=None):
    """Resolve a --loss-fn name (the JAX `get_loss`): `model_cfg`, when given,
    truncates the spectral losses' SHT to its modes_lat / modes_lon."""
    if model_cfg is not None and name in _SPECTRAL_LOSSES:
        return _spectral_loss_entry(_SPECTRAL_LOSSES[name], lmax=model_cfg.modes_lat,
                                    mmax=model_cfg.modes_lon)
    try:
        return LOSSES[name]
    except KeyError:
        raise ValueError(f"unknown loss {name!r}; choose from {sorted(LOSSES)}") from None
