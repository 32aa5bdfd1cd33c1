"""Latitude-sharded SHT with an explicit all_to_all transpose (port of
msfno_tpu/parallel/sharded_sht.py).

Grid fields are sharded over latitude bands, spectral fields over
longitudinal orders m, and the switch between the two layouts is ONE
all_to_all over the lat group between the longitude-DFT stage and the
Legendre stage:

  grid   (B, H_pad/P, W, C)        --DFT over W (local)-->
         (B, H_pad/P, 2, M_pad, C) --all_to_all (m <-> h shards)-->
         (B, H_pad, 2, M_pad/P, C) --Legendre over all H (local)-->
  spec   (2, B, L, M_pad/P, C)

The inverse mirrors it.  Both sharded axes are padded to a multiple of P:
the extra orders carry zero analysis and synthesis weights, and the extra
latitudes (nlat % P != 0, the 721-row grid) zero quadrature weights in the
analysis and zero rows out of the synthesis.  The all_to_all is an
autograd Function whose backward is the reverse all_to_all
(parallel/annotate.py), so the transform trains.

Interleaved mode layout (default): order m sits at position
i = (m % P) * (M_pad / P) + m // P, so shard k holds {m : m = k (mod P)}
ascending.  Every shard then has the same live-mode census under the
triangular truncation, and every shard's orders below a degree cut form a
local prefix of the same length, which lets the Legendre stage skip the
structurally zero block {l < cut, m >= cut} (`l_blocks` blocks).  Per-mode
consumers index through `mode_inv`; mode-pointwise ops need nothing.

Each rank holds the Legendre weights of its own m-shard only: replicated,
they would take ~1.5 GB at full width.  The re/im payloads travel as one
stacked real tensor in `comm_dtype` (bf16 on the bf16 tier, as in the JAX
package), so the rounding matches.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from msfno_torch.ops.sht import InverseRealSHT, RealSHT, _dft_analysis_matrices, \
    _dft_synthesis_matrices
from msfno_torch.parallel.annotate import all_gather, all_to_all
from msfno_torch.runtime import mxu_matmul


def _pad_axis(arr: np.ndarray, size: int, axis: int) -> np.ndarray:
    """Zero-pad `axis` of a weight tensor up to `size`."""
    if arr.shape[axis] == size:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, size - arr.shape[axis])
    return np.pad(arr, widths)


def _round_up(n: int, p: int) -> int:
    return -(-n // p) * p


def _resolve_comm_dtype(comm_dtype, mxu_dtype: str) -> torch.dtype:
    """The all_to_all payload's dtype: by default bf16 on the bf16 tier
    (its next matmul rounds to bf16 anyway), fp32 otherwise."""
    if comm_dtype is None:
        comm_dtype = "bfloat16" if mxu_dtype == "bfloat16" else "float32"
    if isinstance(comm_dtype, torch.dtype):
        return comm_dtype
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(comm_dtype)]


def interleave_perm(m_pad: int, p: int) -> np.ndarray:
    """Round-robin order-to-position permutation: perm[i] = original order at
    position i, with shard k = positions [k*q, (k+1)*q) holding orders
    {k, k+P, k+2P, ...} ascending (q = m_pad / P)."""
    q = m_pad // p
    i = np.arange(m_pad)
    return (i % q) * p + i // q


def _l_cuts(lmax: int, l_blocks: int) -> list[int]:
    """Monotone cut list [0, ..., lmax] splitting the degree axis into
    l_blocks near-equal blocks."""
    cuts = [round(b * lmax / l_blocks) for b in range(l_blocks + 1)]
    return sorted(set(cuts))


def _mode_layout(p: int, m_pad: int, lmax: int, interleaved: bool, l_blocks: int):
    """The m-shard layout shared by the forward and the inverse transform:
    (interleaved, l_blocks, mode_perm, mode_inv, cuts, nb).  mode_perm maps
    position -> order, mode_inv order -> position; cuts are the l-block
    boundaries and nb[b] the local order prefix that can be live in block b
    (round-robin only: contiguous shards' live prefixes differ)."""
    interleaved = interleaved and p > 1
    l_blocks = max(1, l_blocks) if interleaved else 1
    if interleaved:
        mode_perm = interleave_perm(m_pad, p)
        mode_inv = np.argsort(mode_perm)
    else:
        mode_perm = np.arange(m_pad)
        mode_inv = mode_perm
    q = m_pad // p
    cuts = _l_cuts(lmax, l_blocks)
    nb = ([min(q, -(-cut // p)) for cut in cuts[1:]] if interleaved
          else [q] * (len(cuts) - 1))
    return interleaved, l_blocks, mode_perm, mode_inv, cuts, nb


class _Sharded:
    """Shared layout of both transforms over the mesh's `axis` group."""

    def __init__(self, t, mesh, axis, interleaved, l_blocks, comm_dtype):
        self.mesh, self.axis = mesh, axis
        self.group = mesh.get_group(axis)
        self.p = dist.get_world_size(self.group)
        self.rank = mesh.get_local_rank(axis)
        self.nlat, self.nlon, self.lmax, self.mmax = t.nlat, t.nlon, t.lmax, t.mmax
        self.mxu_dtype = t.mxu_dtype
        self.comm_dtype = _resolve_comm_dtype(comm_dtype, t.mxu_dtype)
        self.h_pad = _round_up(t.nlat, self.p)
        self.hb = self.h_pad // self.p
        self.m_pad = _round_up(t.mmax, self.p)
        self.q = self.m_pad // self.p
        (self.interleaved, self.l_blocks, self.mode_perm, self.mode_inv,
         self._cuts, self._nb) = _mode_layout(self.p, self.m_pad, t.lmax, interleaved,
                                              l_blocks)
        self._consts: dict = {}

    @property
    def local_orders(self) -> np.ndarray:
        """The orders m at this rank's q mode positions (>= mmax: padding)."""
        return self.mode_perm[self.rank * self.q:(self.rank + 1) * self.q]

    def _const(self, name: str, device) -> torch.Tensor:
        key = (name, torch.device(device))
        if key not in self._consts:
            arr = np.ascontiguousarray(getattr(self, "_np_" + name))
            self._consts[key] = torch.from_numpy(arr).to(device)
        return self._consts[key]

    def _blocks(self):
        return [(self._cuts[b], self._cuts[b + 1], nb) for b, nb in enumerate(self._nb)]


class ShardedRealSHT(_Sharded):
    """Forward SHT over the mesh's `axis`: this rank's (B, H_pad/P, W, C)
    latitude band -> its (2, B, L, M_pad/P, C) m-shard, in `mode_perm`
    order when interleaved.  Any nlat (padded internally)."""

    def __init__(self, sht: RealSHT, mesh, axis: str = "lat", interleaved: bool = True,
                 l_blocks: int = 2, comm_dtype=None):
        super().__init__(sht, mesh, axis, interleaved, l_blocks, comm_dtype)
        self.sht = sht
        # (M_pad, L, H_pad) with zero rows / columns for padded orders /
        # latitudes, in mode_perm order; this rank keeps its q orders
        weights = _pad_axis(_pad_axis(sht.weights, self.m_pad, 0), self.h_pad, 2)
        self._np_weights = weights[self.local_orders]
        cmat, smat = _dft_analysis_matrices(sht.nlon, sht.mmax)
        cmat, smat = _pad_axis(cmat, self.m_pad, 1), _pad_axis(smat, self.m_pad, 1)
        # merged (2*M_pad, W) = [C | -S]^T in mode_perm order: the local
        # longitude stage is one matmul
        self._np_dft_t = np.concatenate(
            [cmat[:, self.mode_perm], -smat[:, self.mode_perm]], axis=1).T

    def to_canonical(self, coeffs: torch.Tensor) -> torch.Tensor:
        """The dense (2, B, L, mmax, C) torch_harmonics layout, gathered
        over the group from every rank's m-shard."""
        full = all_gather(coeffs, -2, self.group)
        idx = torch.as_tensor(self.mode_inv[: self.mmax], device=coeffs.device)
        return full.index_select(-2, idx)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[-3] != self.hb or x.shape[-2] != self.nlon:
            raise ValueError(f"expected a (B, {self.hb}, {self.nlon}, C) band, got "
                             f"{tuple(x.shape)}")
        b, hb, w, c = x.shape
        m_pad, q, p = self.m_pad, self.q, self.p
        dft_t = self._const("dft_t", x.device)  # (2*M_pad, W)
        f = mxu_matmul(dft_t, x.reshape(b * hb, w, c), self.mxu_dtype)  # (B*hb, 2M_pad, C)
        # stacked [re, im] real payload in comm_dtype, the m-split aligned
        # with the mode layout: (B, hb, 2, M_pad, C)
        fri = f.reshape(b, hb, 2, m_pad, c).to(self.comm_dtype)
        fri = all_to_all(fri, 3, 1, self.group)  # (B, H_pad, 2, q, C)
        # (q, H_pad, 2*B*C): batch over the local orders, contract h
        fp = fri.float().permute(3, 1, 2, 0, 4).reshape(q, self.h_pad, 2 * b * c)
        w_loc = self._const("weights", x.device)  # (q, L, H_pad)
        outs = []
        for lo, hi, nb in self._blocks():
            # block b: degrees [lo, hi) reach only the local prefix [0, nb);
            # the rest of the block is structurally zero (l < m)
            ob = mxu_matmul(w_loc[:nb, lo:hi], fp[:nb], self.mxu_dtype)  # (nb, hi-lo, 2BC)
            if nb < q:
                ob = torch.cat([ob, ob.new_zeros((q - nb,) + ob.shape[1:])])
            outs.append(ob)
        out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)  # (q, L, 2BC)
        return out.reshape(q, self.lmax, 2, b, c).permute(2, 3, 1, 0, 4).contiguous()


class ShardedInverseRealSHT(_Sharded):
    """Inverse SHT over the mesh's `axis`: this rank's (2, B, L, M_pad/P, C)
    m-shard (mode_perm order) -> its (B, H_pad/P, W, C) latitude band (the
    padded rows zero)."""

    def __init__(self, isht: InverseRealSHT, mesh, axis: str = "lat",
                 interleaved: bool = True, l_blocks: int = 2, comm_dtype=None):
        super().__init__(isht, mesh, axis, interleaved, l_blocks, comm_dtype)
        self.isht = isht
        pct = _pad_axis(_pad_axis(isht.pct, self.m_pad, 0), self.h_pad, 2)
        # (q, H_pad, L): this rank's orders, transposed for the synthesis
        self._np_pct_t = pct[self.local_orders].transpose(0, 2, 1)
        ci, si = _dft_synthesis_matrices(isht.nlon, isht.mmax)
        ci, si = _pad_axis(ci, self.m_pad, 0), _pad_axis(si, self.m_pad, 0)
        # merged (W, 2*M_pad) = [Ci; -Si]^T, rows in mode_perm order
        self._np_dft_t = np.concatenate([ci[self.mode_perm], -si[self.mode_perm]], axis=0).T

    def __call__(self, coeffs: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
        if (coeffs.dim() != 5 or coeffs.shape[0] != 2 or coeffs.shape[-3] != self.lmax
                or coeffs.shape[-2] != self.q):
            raise ValueError(f"expected (2, B, {self.lmax}, {self.q}, C), got "
                             f"{tuple(coeffs.shape)}")
        _, b, l, q, c = coeffs.shape
        # (q, L, 2*B*C): batch over the local orders, contract l
        z = coeffs.float().permute(3, 2, 0, 1, 4).reshape(q, l, 2 * b * c)
        p_t = self._const("pct_t", coeffs.device)  # (q, H_pad, L)
        acc = None
        for lo, hi, nb in self._blocks():
            ob = mxu_matmul(p_t[:nb, :, lo:hi], z[:nb, lo:hi], self.mxu_dtype)
            if nb < q:
                ob = torch.cat([ob, ob.new_zeros((q - nb,) + ob.shape[1:])])
            acc = ob if acc is None else acc + ob  # (q, H_pad, 2BC)
        # (B, H_pad, 2, q, C) in comm_dtype -> rows split, m gathered
        xri = acc.reshape(q, self.h_pad, 2, b, c).permute(3, 1, 2, 0, 4).to(self.comm_dtype)
        xri = all_to_all(xri, 1, 3, self.group)  # (B, hb, 2, M_pad, C)
        cat = xri.float().reshape(b * self.hb, 2 * self.m_pad, c)
        dft_t = self._const("dft_t", coeffs.device)  # (W, 2*M_pad)
        x = mxu_matmul(dft_t, cat, self.mxu_dtype, out_dtype)
        return x.reshape(b, self.hb, self.nlon, c)


def make_sharded_transforms(sht: RealSHT, isht: InverseRealSHT, mesh, axis: str = "lat",
                            interleaved: bool = True, l_blocks: int = 2, comm_dtype=None):
    return (ShardedRealSHT(sht, mesh, axis, interleaved, l_blocks, comm_dtype),
            ShardedInverseRealSHT(isht, mesh, axis, interleaved, l_blocks, comm_dtype))
