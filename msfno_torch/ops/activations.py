"""Complex activations on real pairs (port of msfno_tpu/ops/activations.py;
reference MSFNO/Models/sfno/activations.py:9-84).

z is the port's (2, ..., C) [re, im] layout; a bias is (C,) and broadcasts
over the last axis.  The SFNO default is mode="real": LeakyReLU on the real
part, the imaginary part passed through.
"""

from __future__ import annotations

import math

import torch


def _leaky(v: torch.Tensor, negative_slope: float) -> torch.Tensor:
    return torch.where(v >= 0, v, negative_slope * v)


def _modulus(z: torch.Tensor, act, bias) -> torch.Tensor:
    # |z| rescaled through act: z * act(|z| + b) / max(|z|, 1e-30)
    zabs = torch.hypot(z[0], z[1])
    b = 0.0 if bias is None else bias
    return z * (act(zabs + b) / torch.clamp(zabs, min=1e-30))


def complex_relu(z: torch.Tensor, mode: str = "real", negative_slope: float = 0.0,
                 bias: torch.Tensor | None = None) -> torch.Tensor:
    """ComplexReLU in the modes real, cartesian, modulus and halfplane (both
    with `bias`); any other mode is the identity."""
    act = lambda v: _leaky(v, negative_slope)  # noqa: E731
    if mode == "cartesian":
        return act(z)
    if mode == "modulus":
        return _modulus(z, act, bias)
    if mode == "halfplane":
        angle = torch.atan2(z[1], z[0]) - (0.0 if bias is None else bias)
        keep = (angle >= 0.0) & (angle < math.pi / 2.0)
        return torch.where(keep, z, negative_slope * z)
    if mode == "real":
        return torch.stack([act(z[0]), z[1]])
    return z


def complex_activation(z: torch.Tensor, act, mode: str = "cartesian",
                       bias: torch.Tensor | None = None) -> torch.Tensor:
    """A real activation `act` applied to a complex z (reference
    ComplexActivation, activations.py:55-84): "cartesian" to re and im apart,
    "modulus" to |z| (+ bias); any other mode is the identity."""
    if mode == "cartesian":
        return act(z)
    if mode == "modulus":
        return _modulus(z, act, bias)
    return z
