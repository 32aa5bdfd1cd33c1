"""Real spherical harmonic transforms.

Port of msfno_tpu/ops/sht.py (torch_harmonics RealSHT / InverseRealSHT
semantics as used by the reference, MSFNO/Models/sfno/sfnonet.py:532-555):

    forward:  truncated longitude DFT  ->  associated-Legendre matmul per
              order m
    inverse:  Legendre synthesis per order m (merged [re | im] layout)  ->
              truncated inverse longitude DFT

The longitude stage follows `lon_dft`, with the JAX package's conditions:
"matmul" is one matmul against the merged [C | -S] / [Ci; -Si] matrix,
"pallas" the hand-written dft_analysis / dft_synthesis kernels (forward
only: they have no gradient, as in JAX); both apply while mmax <= nlon/2 +
1, and otherwise, or with "fft", the transform runs torch.fft.rfft / irfft
(norm="forward"), truncated and zero-padded.

Layout is channels-last: grids are (B, H, W, C).  A spectral array is one
fp32 tensor of shape (2, B, L, M, C) holding [re, im], the layout the
spectral_mlp kernel reads, so complex tensors never appear.  The Legendre
einsums `mlh,...hmc->...lmc` and `mlh,...lmc->...hmc` are batched matmuls
over m.  The weights are built once in float64 numpy and cached per device
as fp32 tensors.

`spectral_rescale` reproduces the reference's 1e5 rescaling: analysis
weights are multiplied by it and synthesis weights divided, so round trips
are unchanged.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from msfno_torch.ops.kernels import dft_analysis as dft_a
from msfno_torch.ops.kernels import dft_synthesis as dft_s
from msfno_torch.ops.legendre import legendre_matrix
from msfno_torch.ops.quadrature import grid_quadrature
from msfno_torch.runtime import mxu_matmul

LON_DFTS = ("matmul", "pallas", "fft")


def _resolve_modes(nlat: int, nlon: int, lmax, mmax) -> tuple[int, int]:
    lmax = lmax or nlat
    mmax = mmax or nlon // 2 + 1
    return int(lmax), int(mmax)


@functools.lru_cache(maxsize=16)
def _dft_analysis_matrices(nlon: int, mmax: int) -> tuple[np.ndarray, np.ndarray]:
    """(C, S) with C[w, m] = cos(2 pi m w / W)/W, S[w, m] = sin(.)/W so that
    fhat_m = x @ C - i * x @ S equals rfft(x, norm="forward")[..., :mmax]."""
    w = np.arange(nlon)[:, None].astype(np.float64)
    m = np.arange(mmax)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * w * m / nlon
    return (
        (np.cos(ang) / nlon).astype(np.float32),
        (np.sin(ang) / nlon).astype(np.float32),
    )


@functools.lru_cache(maxsize=16)
def _dft_synthesis_matrices(nlon: int, mmax: int) -> tuple[np.ndarray, np.ndarray]:
    """(Ci, Si) with Ci[m, w] = k_m cos(2 pi m w / W), Si[m, w] = k_m sin(.),
    k = 1 for m = 0 and the Nyquist bin (whose Si row is zeroed), 2
    otherwise: x_w = sum_m re_m Ci[m, w] - im_m Si[m, w]."""
    if mmax > nlon // 2 + 1:
        raise ValueError("matmul synthesis requires mmax <= nlon/2 + 1")
    w = np.arange(nlon)[None, :].astype(np.float64)
    m = np.arange(mmax)[:, None].astype(np.float64)
    ang = 2.0 * np.pi * w * m / nlon
    nyquist = m == nlon // 2
    k = np.where((m == 0) | (nyquist & (nlon % 2 == 0)), 1.0, 2.0)
    si = k * np.sin(ang)
    si[np.broadcast_to(nyquist & (nlon % 2 == 0), si.shape)] = 0.0
    return (k * np.cos(ang)).astype(np.float32), si.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _dft_analysis_merged(nlon: int, mmax: int) -> np.ndarray:
    """(W, 2M) = [C | -S]: one matmul yields [re | im] along the mode axis."""
    cmat, smat = _dft_analysis_matrices(nlon, mmax)
    return np.concatenate([cmat, -smat], axis=1)


@functools.lru_cache(maxsize=16)
def _dft_synthesis_merged(nlon: int, mmax: int) -> np.ndarray:
    """(2M, W) = [Ci; -Si]: x = [re | im] @ [Ci; -Si] in one matmul."""
    ci, si = _dft_synthesis_matrices(nlon, mmax)
    return np.concatenate([ci, -si], axis=0)


@functools.lru_cache(maxsize=16)
def _sht_weights(
    nlat: int, nlon: int, lmax: int, mmax: int, grid: str, csphase: bool
) -> tuple[np.ndarray, np.ndarray]:
    """(analysis_weights, synthesis_pct), both (mmax, lmax, nlat) fp64:
    analysis[m, l, k] = 2 pi w_k Pbar_l^m(x_k), pct[m, l, k] = Pbar_l^m(x_k)."""
    x, w = grid_quadrature(grid, nlat)
    pct = legendre_matrix(lmax, mmax, x, csphase=csphase)
    analysis = 2.0 * np.pi * pct * w[None, None, :]
    return analysis, pct


class _Transform:
    """Shared fields and the per-device constant cache of both transforms."""

    def __init__(self, nlat: int, nlon: int, lmax=None, mmax=None,
                 grid: str = "legendre-gauss", csphase: bool = True,
                 spectral_rescale: float = 1.0, lon_dft: str = "matmul",
                 mxu_dtype: str = "float32"):
        self.nlat, self.nlon = int(nlat), int(nlon)
        self.lmax, self.mmax = _resolve_modes(self.nlat, self.nlon, lmax, mmax)
        self.grid = grid
        self.csphase = csphase
        self.spectral_rescale = spectral_rescale
        self.lon_dft = lon_dft
        # "float32": true fp32 matmuls; "bfloat16": bf16 operands, fp32
        # accumulation (runtime.mxu_matmul says where torch rounds more)
        self.mxu_dtype = mxu_dtype
        if lon_dft not in LON_DFTS:
            raise ValueError(f"lon_dft={lon_dft!r}: expected one of {LON_DFTS}")
        self._consts: dict = {}

    @property
    def dft_path(self) -> str:
        """The longitude stage that runs: `lon_dft` where the truncated DFT
        applies (mmax <= nlon/2 + 1), else the rfft path "fft"."""
        if self.lon_dft != "fft" and self.mmax <= self.nlon // 2 + 1:
            return self.lon_dft
        return "fft"

    def _const(self, name: str, device, build=None) -> torch.Tensor:
        """Constant `name` on `device`, made once: `build()` when given (a
        kernel operand derived from other constants), else `_numpy(name)`."""
        key = (name, torch.device(device))
        t = self._consts.get(key)
        if t is None:
            # a normal tensor even when first asked for under inference_mode:
            # kernels cache operands derived from it (runtime.DerivedCache)
            with torch.inference_mode(False):
                t = (build() if build is not None else
                     torch.from_numpy(np.ascontiguousarray(self._numpy(name))).to(device))
            self._consts[key] = t
        return t

    def _dft_kernel_operands(self, kernel, names, device):
        """The DFT matrices `names` on `device` and, on a card, the kernel's
        prepared operand for this transform's mxu dtype."""
        p, q = (self._const(n, device) for n in names)
        prepared = None
        if torch.device(device).type == "cuda":
            prepared = self._const(f"{kernel.__name__}/{self.mxu_dtype}", device,
                                   lambda: kernel.prepare(p, q, self.mxu_dtype))
        return p, q, prepared

    def _numpy(self, name: str) -> np.ndarray:
        raise KeyError(name)


class RealSHT(_Transform):
    """Forward real SHT: (B, H, W, C) real -> (2, B, L, M, C) [re, im] fp32.

    Triangular truncation stored as a dense (L, M) rectangle with zeros where
    l < m (torch_harmonics semantics)."""

    @functools.cached_property
    def weights(self) -> np.ndarray:
        """(mmax, lmax, nlat) fp32 analysis weights (incl. spectral_rescale)."""
        analysis, _ = _sht_weights(
            self.nlat, self.nlon, self.lmax, self.mmax, self.grid, self.csphase
        )
        return np.asarray(analysis * self.spectral_rescale, dtype=np.float32)

    @functools.cached_property
    def merged_analysis(self) -> np.ndarray:
        """(nlon, 2*mmax) merged [C | -S] analysis matrix."""
        return _dft_analysis_merged(self.nlon, self.mmax)

    def _numpy(self, name: str) -> np.ndarray:
        if name == "weights2":
            return np.concatenate([self.weights, self.weights], axis=0)
        if name == "merged_t":
            return self.merged_analysis.T  # (2M, W)
        if name == "merged":
            return self.merged_analysis  # (W, 2M)
        if name in ("cmat", "smat"):
            return _dft_analysis_matrices(self.nlon, self.mmax)[name == "smat"]  # (W, M)
        if name == "s0":
            # analysis of a constant field: only m = 0 is excited, with this
            # (lmax,) profile (SpectralAttentionS2's norm_affine fold)
            return self.weights[0].sum(-1)
        return super()._numpy(name)

    def legendre_stacked(self, f: torch.Tensor) -> torch.Tensor:
        """Legendre analysis only: (B, H, 2M, C) stacked [re | im] longitude
        modes -> (2, B, L, M, C)."""
        if f.dim() != 4 or f.shape[-2] != 2 * self.mmax or f.shape[-3] != self.nlat:
            raise ValueError(
                f"expected (B, {self.nlat}, {2 * self.mmax}, C), got {tuple(f.shape)}"
            )
        b, h, _, c = f.shape
        m = self.mmax
        # (B, H, 2, M, C) -> (2, M, H, B*C): batch over (part, m), contract h
        fp = f.reshape(b, h, 2, m, c).permute(2, 3, 1, 0, 4)
        fp = fp.reshape(2 * m, h, b * c)
        w2 = self._const("weights2", f.device)  # (2M, L, H)
        out = mxu_matmul(w2, fp, self.mxu_dtype)  # (2M, L, B*C)
        out = out.reshape(2, m, self.lmax, b, c).permute(0, 3, 2, 1, 4)
        return out.contiguous()

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-3] != self.nlat or x.shape[-2] != self.nlon:
            raise ValueError(
                f"expected (B, {self.nlat}, {self.nlon}, C), got {tuple(x.shape)}"
            )
        b, h, w, c = x.shape
        path = self.dft_path
        if path == "matmul":
            cs_t = self._const("merged_t", x.device)  # (2M, W)
            # longitude analysis, one matmul per latitude row: (2M, W) @ (W,
            # C); the Legendre matmul takes the GEMM's output dtype as it is
            f = mxu_matmul(cs_t, x.reshape(b * h, w, c), self.mxu_dtype, out_dtype=None)
        elif path == "pallas":
            cmat, smat, at = self._dft_kernel_operands(dft_a, ("cmat", "smat"), x.device)
            f = dft_a.dft_analysis(x, cmat, smat, self.mxu_dtype, prepared=at)
        else:
            if self.mmax > w // 2 + 1:
                # the JAX package fails here too, in its Legendre einsum
                raise ValueError(f"mmax={self.mmax} exceeds the {w // 2 + 1} rfft "
                                 f"frequencies of nlon={w}")
            fh = torch.fft.rfft(x.float(), dim=-2, norm="forward")[..., : self.mmax, :]
            f = torch.cat([fh.real, fh.imag], dim=-2)
        return self.legendre_stacked(f.reshape(b, h, 2 * self.mmax, c))


class InverseRealSHT(_Transform):
    """Inverse real SHT: (2, B, L, M, C) [re, im] -> (B, H, W, C) fp32."""

    @functools.cached_property
    def pct(self) -> np.ndarray:
        """(mmax, lmax, nlat) fp32 synthesis weights (incl. 1/spectral_rescale)."""
        _, pct = _sht_weights(
            self.nlat, self.nlon, self.lmax, self.mmax, self.grid, self.csphase
        )
        return np.asarray(pct / self.spectral_rescale, dtype=np.float32)

    @functools.cached_property
    def pct2(self) -> np.ndarray:
        """(2*mmax, lmax, nlat): pct tiled over the stacked [re | im] mode
        axis, so one batched Legendre synthesis emits the (B, H, 2M, C)
        layout the merged DFT consumes."""
        return np.concatenate([self.pct, self.pct], axis=0)

    @functools.cached_property
    def merged_matrix_t(self) -> np.ndarray:
        """(nlon, 2*mmax) fp32 transposed merged synthesis matrix."""
        return np.ascontiguousarray(_dft_synthesis_merged(self.nlon, self.mmax).T)

    @functools.cached_property
    def mode_power_weights(self) -> np.ndarray:
        """(2*mmax,) fp32 omega with sum_w x_w^2 = nlon * sum_m omega_m hm_m^2
        for x = hm @ merged matrix (diag(M M^T)/nlon in float64)."""
        mat = _dft_synthesis_merged(self.nlon, self.mmax).astype(np.float64)
        return (np.einsum("mw,mw->m", mat, mat) / self.nlon).astype(np.float32)

    def _numpy(self, name: str) -> np.ndarray:
        if name == "pct2_t":
            return self.pct2.transpose(0, 2, 1)  # (2M, H, L)
        if name == "merged_t":
            return self.merged_matrix_t  # (W, 2M)
        if name == "omega":
            return self.mode_power_weights  # (2M,)
        if name in ("ci", "si"):
            return _dft_synthesis_matrices(self.nlon, self.mmax)[name == "si"]  # (M, W)
        return super()._numpy(name)

    def synthesis_hm(self, coeffs: torch.Tensor) -> torch.Tensor:
        """Legendre synthesis only: (2, B, L, M, C) -> the (B, H, 2M, C) fp32
        stacked [re | im] intermediate that the merged inverse DFT consumes.
        Only on the matmul path, as in the JAX package."""
        if self.dft_path != "matmul":
            raise ValueError("synthesis_hm requires the matmul DFT path")
        return self._synthesis_hm(coeffs, torch.float32)

    def _synthesis_hm(self, coeffs: torch.Tensor, out_dtype) -> torch.Tensor:
        if (coeffs.dim() != 5 or coeffs.shape[0] != 2
                or coeffs.shape[-3] != self.lmax or coeffs.shape[-2] != self.mmax):
            raise ValueError(
                f"expected (2, B, {self.lmax}, {self.mmax}, C), got "
                f"{tuple(coeffs.shape)}"
            )
        _, b, l, m, c = coeffs.shape
        # (2, B, L, M, C) -> (2M, L, B*C): batch over (part, m), contract l
        z = coeffs.float().permute(0, 3, 2, 1, 4).reshape(2 * m, l, b * c)
        p = self._const("pct2_t", coeffs.device)  # (2M, H, L)
        hm = mxu_matmul(p, z, self.mxu_dtype, out_dtype)  # (2M, H, B*C)
        hm = hm.reshape(2 * m, self.nlat, b, c).permute(2, 1, 0, 3)
        return hm.contiguous()

    def __call__(self, coeffs: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
        """(2, B, L, M, C) -> (B, H, W, C) in `out_dtype` (fp32 by default)."""
        path = self.dft_path
        if path == "fft":
            return self._irfft(coeffs).to(out_dtype)
        hm = self._synthesis_hm(coeffs, None)
        b, h, two_m, c = hm.shape
        if path == "pallas":
            ci, si, at = self._dft_kernel_operands(dft_s, ("ci", "si"), hm.device)
            x = dft_s.dft_synthesis(hm, ci, si, self.mxu_dtype, out_dtype, prepared=at)
        else:
            mat_t = self._const("merged_t", hm.device)  # (W, 2M)
            x = mxu_matmul(mat_t, hm.reshape(b * h, two_m, c), self.mxu_dtype, out_dtype)
        return x.reshape(b, h, self.nlon, c)

    def _irfft(self, coeffs: torch.Tensor) -> torch.Tensor:
        """The rfft path's inverse: the Legendre synthesis zero-padded to the
        nlon/2 + 1 frequencies (irfft cuts a longer one, as jnp's does), then
        irfft with norm="forward" (the 1/nlon was applied in the analysis)."""
        hm = self._synthesis_hm(coeffs, torch.float32)
        m = self.mmax
        xm = torch.complex(hm[:, :, :m], hm[:, :, m:])
        nfreq = self.nlon // 2 + 1
        if m < nfreq:
            pad = xm.new_zeros(xm.shape[:2] + (nfreq - m, xm.shape[-1]))
            xm = torch.cat([xm, pad], dim=-2)
        return torch.fft.irfft(xm, n=self.nlon, dim=-2, norm="forward")
