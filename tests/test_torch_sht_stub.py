"""The port's SHT (msfno_torch/ops/sht.py) against tests/ref_compat/th_stub.py,
the scipy-based stand-in for torch_harmonics' RealSHT / InverseRealSHT
(orthonormal Legendre functions from scipy.special.lpmv, Gauss-Legendre and
Clenshaw-Curtis weights written out independently): analysis and synthesis
on the equiangular and Legendre-Gauss grids, full and truncated, on each
longitude stage (matmul, the DFT kernels' plain versions, rfft), fp32,
rel-L2 <= 1e-5.  Needs no reference checkout."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.sht import InverseRealSHT, RealSHT
from tests.ref_compat import th_stub

torch.set_num_threads(2)

TOL = 1e-5
GRIDS = [
    dict(nlat=17, nlon=32, grid="equiangular"),
    dict(nlat=17, nlon=32, lmax=8, mmax=9, grid="equiangular"),
    dict(nlat=12, nlon=24, grid="legendre-gauss"),
    dict(nlat=16, nlon=32, lmax=10, mmax=7, grid="legendre-gauss"),
]


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _id(g):
    return f"{g['grid']}-{g['nlat']}x{g['nlon']}-l{g.get('lmax')}-m{g.get('mmax')}"


@pytest.mark.parametrize("lon_dft", ["matmul", "pallas", "fft"])
@pytest.mark.parametrize("g", GRIDS, ids=_id)
def test_analysis_matches_stub(g, lon_dft):
    x = np.random.default_rng(0).standard_normal((2, 3, g["nlat"], g["nlon"])).astype(np.float32)
    ref = th_stub.RealSHT(**g)(torch.from_numpy(x).double()).numpy()  # (2, 3, L, M)
    sht = RealSHT(**g, lon_dft=lon_dft)
    # channels-last: (B, H, W, C) -> (2, B, L, M, C) [re, im]
    out = sht(torch.from_numpy(np.moveaxis(x, 1, -1))).numpy()
    got = np.moveaxis(out[0] + 1j * out[1], -1, 1)
    err = rel_l2(np.stack([got.real, got.imag]), np.stack([ref.real, ref.imag]))
    print(f"parity sht stub analysis {_id(g)} {lon_dft} rel_l2={err:.3e}")
    assert err <= TOL


@pytest.mark.parametrize("lon_dft", ["matmul", "pallas", "fft"])
@pytest.mark.parametrize("g", GRIDS, ids=_id)
def test_synthesis_matches_stub(g, lon_dft):
    stub = th_stub.InverseRealSHT(**g)
    rng = np.random.default_rng(1)
    shape = (2, 3, stub.lmax, stub.mmax)
    c = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    c[..., 0] = c[..., 0].real  # m = 0 modes of a real field are real
    ref = stub(torch.from_numpy(c)).numpy()  # (2, 3, H, W)
    isht = InverseRealSHT(**g, lon_dft=lon_dft)
    spec = np.stack([c.real, c.imag]).astype(np.float32)  # (2, B, C, L, M)
    got = isht(torch.from_numpy(np.ascontiguousarray(np.moveaxis(spec, 2, -1)))).numpy()
    err = rel_l2(np.moveaxis(got, -1, 1), ref)
    print(f"parity sht stub synthesis {_id(g)} {lon_dft} rel_l2={err:.3e}")
    assert err <= TOL
