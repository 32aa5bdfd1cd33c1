"""Planar FFT transforms with the SHT interface (port of
msfno_tpu/ops/fft.py; reference RealFFT2 / InverseRealFFT2,
MSFNO/Models/sfno/layers.py:181-250), selected by spectral_transform="fft".

Channels-last grids (B, H, W, C); FFT axes (-3, -2), norm="ortho".  The
spectral side is the port's (2, B, L, M, C) [re, im] fp32 pair.  Two-sided
latitude modes: the first ceil(lmax/2) and the last floor(lmax/2)
frequency rows are kept.  torch.fft runs the transforms (cuFFT on a card),
as XLA's FFT runs them in the JAX package.
"""

from __future__ import annotations

import math

import torch


class RealFFT2:
    """(B, H, W, C) real -> (2, B, lmax, mmax, C) fp32 [re, im]."""

    def __init__(self, nlat: int, nlon: int, lmax=None, mmax=None):
        self.nlat, self.nlon = int(nlat), int(nlon)
        self.lmax = int(lmax or nlat)
        self.mmax = int(mmax or nlon // 2 + 1)
        if self.lmax % 2 != 0:
            raise ValueError("lmax must be even (two-sided latitude modes)")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.fft.rfft2(x.float(), dim=(-3, -2), norm="ortho")
        hi = y[..., : math.ceil(self.lmax / 2), : self.mmax, :]
        lo = y[..., -math.floor(self.lmax / 2):, : self.mmax, :]
        z = torch.cat((hi, lo), dim=-3)
        return torch.stack([z.real, z.imag])


class InverseRealFFT2:
    """(2, B, L, M, C) [re, im] -> (B, nlat, nlon, C) in `out_dtype`.

    The reference's inverse exactly (layers.py:236-249): the truncated modes
    are zero-padded at the END of each frequency axis, so the rows the
    forward transform gathered from the tail (negative latitude frequencies)
    land at positive positions ceil(lmax/2) .. lmax-1.  Forward and inverse
    are therefore not mutual inverses; that is the reference's semantics and
    its trained weights' contract, reproduced as it is."""

    def __init__(self, nlat: int, nlon: int, lmax=None, mmax=None):
        self.nlat, self.nlon = int(nlat), int(nlon)
        self.lmax = int(lmax or nlat)
        self.mmax = int(mmax or nlon // 2 + 1)

    def __call__(self, y: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
        z = torch.complex(y[0].float(), y[1].float())
        lead, (rows, cols, c) = z.shape[:-3], z.shape[-3:]
        full = z.new_zeros(lead + (self.nlat, self.nlon // 2 + 1, c))
        full[..., :rows, :cols, :] = z
        x = torch.fft.irfft2(full, s=(self.nlat, self.nlon), dim=(-3, -2), norm="ortho")
        return x.to(out_dtype)
