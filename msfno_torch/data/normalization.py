"""Channel-wise normalization (port of msfno_tpu/data/normalization.py;
reference FourCastNetv2.normalise / normalise_film,
MSFNO/Models/sfno/model.py:273-287, 1036-1041)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from msfno_torch.utils.observability import upload


@dataclasses.dataclass(frozen=True)
class Normalizer:
    """y = (x - means) / stds per channel (channels-last)."""

    means: np.ndarray  # (C,)
    stds: np.ndarray  # (C,)

    @classmethod
    def identity(cls, channels: int) -> "Normalizer":
        return cls(np.zeros(channels, np.float32), np.ones(channels, np.float32))

    @classmethod
    def from_npy(cls, means_path: str, stds_path: str) -> "Normalizer":
        # ECMWF stats files are (1, C, 1, 1); squeeze to (C,)
        m = np.load(means_path).reshape(-1).astype(np.float32)
        s = np.load(stds_path).reshape(-1).astype(np.float32)
        return cls(m, s)

    def __call__(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        m = upload(self.means, x.device)
        s = upload(self.stds, x.device)
        if reverse:
            return x * s + m
        return (x - m) / s


@dataclasses.dataclass(frozen=True)
class SSTNormalizer:
    """Scalar normalization for SST: NaNs pass through, so the land mask
    stays intact."""

    mean: float
    std: float

    @classmethod
    def identity(cls) -> "SSTNormalizer":
        return cls(0.0, 1.0)

    def __call__(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        if reverse:
            return x * self.std + self.mean
        return (x - self.mean) / self.std
