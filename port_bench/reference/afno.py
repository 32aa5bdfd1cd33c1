"""Plain fp32 reference of FourCastNet's AFNO net (Pathak et al. 2022,
arXiv:2202.11214; ECMWF ai-models-fourcastnet 0.1), channels-last.

Patch embedding (a stride-p convolution) + positional embedding -> `depth`
blocks of [LayerNorm -> AFNO2D (rfft2 over the token grid, a
block-diagonal two-layer complex MLP over the kept modes with ReLU and
soft shrinkage, irfft2) -> + residual -> LayerNorm -> GELU MLP -> +
residual] -> a linear head unpatched to the grid.  Plain torch operations,
no import of the program under test; matrix products run with TF32 off
unless the caller turns it on (the check's control).  Parameter names and
shapes are the reference model's state_dict's.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Linear(nn.Module):
    def __init__(self, d_in, d_out, bias=True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))
        self.bias = nn.Parameter(torch.empty(d_out)) if bias else None

    def forward(self, x):
        return F.linear(x, self.weight, self.bias)


class AFNO2D(nn.Module):
    def __init__(self, dim, num_blocks=8, sparsity=0.01):
        super().__init__()
        bs = dim // num_blocks
        self.nb, self.sparsity = num_blocks, sparsity
        self.w1 = nn.Parameter(torch.empty(2, num_blocks, bs, bs))
        self.b1 = nn.Parameter(torch.empty(2, num_blocks, bs))
        self.w2 = nn.Parameter(torch.empty(2, num_blocks, bs, bs))
        self.b2 = nn.Parameter(torch.empty(2, num_blocks, bs))

    def forward(self, x):
        b, h, w, c = x.shape
        xf = torch.fft.rfft2(x, dim=(1, 2), norm="ortho")
        xf = xf.reshape(b, h, w // 2 + 1, self.nb, c // self.nb)
        # the kept modes: h // 2 + 1 of them along both axes of the spectrum
        kept = h // 2 + 1
        mul = lambda a, m: torch.einsum("...bi,bio->...bo", a, m)  # noqa: E731
        xr, xi = xf.real[:, :, :kept], xf.imag[:, :, :kept]
        o1r = F.relu(mul(xr, self.w1[0]) - mul(xi, self.w1[1]) + self.b1[0])
        o1i = F.relu(mul(xi, self.w1[0]) + mul(xr, self.w1[1]) + self.b1[1])
        o2r = mul(o1r, self.w2[0]) - mul(o1i, self.w2[1]) + self.b2[0]
        o2i = mul(o1i, self.w2[0]) + mul(o1r, self.w2[1]) + self.b2[1]
        z = torch.complex(F.softshrink(o2r, self.sparsity), F.softshrink(o2i, self.sparsity))
        z = F.pad(z, (0, 0, 0, 0, 0, w // 2 + 1 - kept))
        y = torch.fft.irfft2(z.reshape(b, h, w // 2 + 1, c), s=(h, w), dim=(1, 2), norm="ortho")
        return y + x


class Block(nn.Module):
    def __init__(self, dim, mlp_ratio=4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.filter = AFNO2D(dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = nn.Module()
        self.mlp.fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp.fc2 = Linear(int(dim * mlp_ratio), dim)

    def forward(self, x):
        x = self.filter(self.norm1(x)) + x
        return self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm2(x)))) + x


class AFNONet(nn.Module):
    def __init__(self, cfg: dict, device=None):
        super().__init__()
        h, w = cfg["img_size"]
        p, c, d = cfg["patch_size"], cfg["in_chans"], cfg["embed_dim"]
        self.p, self.out = p, cfg["out_chans"]
        self.grid = (h // p, w // p)
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Module()
        self.patch_embed.proj.weight = nn.Parameter(torch.empty(d, c, p, p))
        self.patch_embed.proj.bias = nn.Parameter(torch.empty(d))
        self.pos_embed = nn.Parameter(torch.empty(1, self.grid[0] * self.grid[1], d))
        self.blocks = nn.ModuleList([Block(d) for _ in range(cfg["depth"])])
        self.head = Linear(d, self.out * p * p, bias=False)
        self.to(device)

    def forward(self, x):
        b, h, w, c = x.shape
        (gh, gw), p = self.grid, self.p
        proj = self.patch_embed.proj
        x = F.conv2d(x.permute(0, 3, 1, 2), proj.weight, proj.bias, stride=p)
        x = x.permute(0, 2, 3, 1) + self.pos_embed.reshape(1, gh, gw, -1)
        for blk in self.blocks:
            x = blk(x)
        x = self.head(x).reshape(b, gh, gw, p, p, self.out)
        return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * p, gw * p, self.out)


def parameter_specs(cfg: dict) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every parameter; see sfno_gcn.parameter_specs."""
    net = AFNONet(cfg, device="meta")
    specs = []
    for name, prm in net.named_parameters():
        shape, leaf = tuple(prm.shape), name.rsplit(".", 1)[-1]
        if name == "pos_embed":
            kind = "pos"
        elif ".norm" in name:
            kind = "norm_w" if leaf == "weight" else "norm_b"
        elif ".filter." in name:
            kind = "afno_w" if leaf.startswith("w") else "afno_b"
        elif leaf == "bias":
            kind = "bias"
        elif name == "patch_embed.proj.weight":
            kind = f"w{shape[1] * shape[2] * shape[3]}"
        elif name == "head.weight":
            kind = "head_w"
        else:
            kind = f"w{shape[1]}"
        specs.append((name, shape, kind))
    return specs
