"""Graph-convolution FiLM generators over the ocean-only SST grid (port of
msfno_tpu/models/film/gcn.py; reference MSFNO/Models/gcn/{gcn.py,layers.py}).

The ocean graph is the coarse SST grid itself: nodes stay dense on (H, W),
one GCN step

    h = D^{-1/2} (A + I) D^{-1/2} (x W) + b

is a 3x3 neighbour sum (8-neighbour + self loop; periodic in longitude, zero
past the poles) over mask-zeroed features, with the degree normalization
computed from the mask.  The generator is batched.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from msfno_torch.ops.kernels.gcn_layer import box3, gcn_layer
from msfno_torch.runtime import DerivedCache, torch_dtype


def neighbor_sum(v: torch.Tensor) -> torch.Tensor:
    """Sum of the 8 grid neighbours (box3 minus the centre)."""
    return box3(v) - v


def gcn_normalize(mask: torch.Tensor) -> torch.Tensor:
    """d^{-1/2} per node for A + I over ocean nodes; 0 on land.
    mask: (B, H, W, 1) fp32."""
    deg = neighbor_sum(mask) + 1.0
    return torch.where(mask > 0, torch.rsqrt(deg), torch.zeros_like(deg))


class GraphConvolution(nn.Module):
    """One dense masked-grid GCN step (reference gcn/layers.py:8-48):
    weight (in, out) with the reference's leaky-relu-gain Xavier-uniform
    init, bias (out,).  `fuse=True` runs the gcn_layer kernel, which also
    applies the trailing leaky ReLU and the optional residual."""

    def __init__(self, in_features: int, features: int, dtype="float32",
                 fuse: bool = False, device=None, gen=None):
        super().__init__()
        gain2 = 2.0 / (1.0 + 0.01 ** 2)
        limit = math.sqrt(3.0 * gain2 / ((in_features + features) / 2.0))
        w = torch.empty((in_features, features), device=device)
        with torch.no_grad():
            w.uniform_(-limit, limit, generator=gen)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.mxu_dtype = dtype  # the kernel's operand dtype is the compute dtype
        self.dtype = torch_dtype(dtype)
        self.fuse = fuse
        self._cache = DerivedCache()

    def forward(self, x, mask, dinv_sqrt, residual=None):
        if self.fuse:
            prepared = None
            if x.is_cuda and x.shape[-1] > 1 and self.mxu_dtype == "bfloat16":
                prepared = self._cache.get(
                    "w", (self.weight,),
                    lambda: self.weight.to(torch.bfloat16).contiguous(),
                )
            return gcn_layer(
                x, self.weight, self.bias, dinv_sqrt, mask, residual=residual,
                mxu_dtype=self.mxu_dtype,
                out_dtype=self.dtype, prepared=prepared,
            )
        if residual is not None:
            raise ValueError("residual fusion requires fuse=True")
        support = x.to(self.dtype) @ self.weight.to(self.dtype)
        t = support * dinv_sqrt
        agg = box3(t) * dinv_sqrt + self.bias
        return agg * mask


class GCNFilmGenerator(nn.Module):
    """Residual GCN stack -> ocean-mean pool -> film head.

    `custom=True` mirrors GCN_custom (gcn/gcn.py:96-168: the latest SST step
    as the single node feature, film head weight init ones); `custom=False`
    mirrors GCN (gcn/gcn.py:12-91: the temporal window as node features,
    film head zero-init)."""

    def __init__(self, out_features: int, embed_dim: int = 512, depth: int = 6,
                 custom: bool = True, in_features: int = 1, dtype="float32",
                 use_pallas: bool = False, device=None, gen=None):
        super().__init__()
        self.custom = custom
        self.depth = depth
        self.dtype = torch_dtype(dtype)
        kw = dict(dtype=dtype, fuse=use_pallas, device=device, gen=gen)
        self.conv1 = GraphConvolution(1 if custom else in_features, embed_dim, **kw)
        for i in range(depth):
            self.add_module(f"conv_{i}", GraphConvolution(embed_dim, embed_dim, **kw))
        head = torch.ones if custom else torch.zeros
        self.head_film = nn.Linear(embed_dim, out_features, device=device)
        with torch.no_grad():
            self.head_film.weight.copy_(head((out_features, embed_dim)))
            self.head_film.bias.zero_()

    def forward(self, sst):
        # sst: (B, T, H, W) with NaN over land
        if sst.dim() == 3:
            sst = sst[:, None]
        mask = (~torch.isnan(sst[:, -1]))[..., None].float()
        if self.custom:
            x = torch.nan_to_num(sst[:, -1])[..., None]
        else:
            x = torch.nan_to_num(sst).movedim(1, -1)
        x = x.float() * mask
        dinv = gcn_normalize(mask)
        x = x.to(self.dtype)
        mask_c, dinv_c = mask.to(self.dtype), dinv.to(self.dtype)

        def layer(gc, v, res):
            if gc.fuse:
                return gc(v, mask_c, dinv_c, residual=res)
            y = torch.nn.functional.leaky_relu(gc(v, mask_c, dinv_c), 0.01)
            return y if res is None else res + y

        x = layer(self.conv1, x, None)
        for i in range(self.depth):
            x = layer(getattr(self, f"conv_{i}"), x, x)
        x = x.float()
        n = torch.clamp(mask.sum(dim=(1, 2)), min=1.0)
        pooled = (x * mask).sum(dim=(1, 2)) / n
        return pooled @ self.head_film.weight.float().t() + self.head_film.bias.float()
