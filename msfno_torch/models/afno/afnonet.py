"""AFNONet, FourCastNet v1 (port of msfno_tpu/models/afno/afnonet.py;
reference MSFNO/Models/fourcastnet/afnonet.py:59-484), the repo's
comparison model family (`--model fcn`).

Channels-last throughout, (B, H, W, C).  AFNO2D takes the real FFT over
longitude and the full one over latitude (`torch.fft.rfft2` over dims 1, 2,
"ortho"), mixes the kept modes with a block-diagonal complex MLP and pads
the rest with zeros; it computes in fp32 (fp64 for an fp64 input) and
returns the input's dtype.  The patch embedding is the stride-p
convolution as a reshape and a product.  Plain torch ops: the FFT runs on
cuFFT, the products on cuBLAS, with TF32 off (`runtime.resolve_device`).

Parameters have the reference's names and shapes, which the JAX
package's `convert_afno_state_dict` reads: `patch_embed.proj.weight`
(D, C, ph, pw), `pos_embed` (1, N, D), `blocks.{i}.{norm1, norm2,
filter.w1, filter.b1, filter.w2, filter.b2, mlp.fc1, mlp.fc2}` and
`head.weight` (no bias).  The reference's final `norm` is built but never
applied (afnonet.py:431-441); it is not built here.  Dropout acts when a
forward is given a `torch.Generator` (`rng`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from msfno_torch.models.film.attention import Dense, _lecun_normal
from msfno_torch.models.sfno.layers import dropout, new_param, trunc_normal_
from msfno_torch.runtime import resolve_device
from msfno_torch.utils.observability import span

LN_EPS = 1e-6


def softshrink(x: torch.Tensor, lambd: float) -> torch.Tensor:
    return torch.sign(x) * torch.clamp(torch.abs(x) - lambd, min=0.0)


def _linear(d_in: int, d_out: int, device, gen, bias: bool = True) -> Dense:
    """A Dense with the reference's trunc_normal(0.02) weight, zero bias."""
    layer = Dense(d_in, d_out, bias=bias, zero_init=True, device=device)
    trunc_normal_(layer.weight, gen)
    return layer


class LayerNorm(nn.Module):
    """LayerNorm over the channels, epsilon 1e-6 (flax's), in the wider of
    the input's and the weights' dtypes."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        x = x.to(torch.promote_types(x.dtype, self.weight.dtype))
        return F.layer_norm(x, x.shape[-1:], self.weight.to(x.dtype), self.bias.to(x.dtype),
                            LN_EPS)


class Mlp(nn.Module):
    """fc1 -> GELU (exact) -> dropout -> fc2 -> dropout (timm Mlp,
    afnonet.py:98-105)."""

    def __init__(self, dim: int, hidden: int, drop_rate: float, device=None, gen=None):
        super().__init__()
        self.fc1 = _linear(dim, hidden, device, gen)
        self.fc2 = _linear(hidden, dim, device, gen)
        self.drop_rate = drop_rate

    def forward(self, x, rng=None):
        y = F.gelu(self.fc1(x))
        drop = self.drop_rate > 0.0 and rng is not None
        if drop:
            y = dropout(y, self.drop_rate, rng)
        y = self.fc2(y)
        return dropout(y, self.drop_rate, rng) if drop else y


class AFNO2D(nn.Module):
    """Block-diagonal spectral mixing through rfft2 (reference
    afnonet.py:109-280)."""

    def __init__(self, hidden_size: int, num_blocks: int = 8, sparsity_threshold: float = 0.01,
                 hard_thresholding_fraction: float = 1.0, hidden_size_factor: int = 1,
                 device=None, gen=None):
        super().__init__()
        if hidden_size % num_blocks:
            raise ValueError("hidden_size must divide into num_blocks")
        nb, bs, hf = num_blocks, hidden_size // num_blocks, hidden_size_factor
        self.num_blocks = nb
        self.sparsity_threshold = sparsity_threshold
        self.hard_thresholding_fraction = hard_thresholding_fraction
        self.w1 = new_param((2, nb, bs, bs * hf), device, gen, "normal")
        self.b1 = new_param((2, nb, bs * hf), device, gen, "normal")
        self.w2 = new_param((2, nb, bs * hf, bs), device, gen, "normal")
        self.b2 = new_param((2, nb, bs), device, gen, "normal")

    def forward(self, x):
        bias, in_dtype = x, x.dtype
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        b, h, w, c = x.shape
        xf = torch.fft.rfft2(x, dim=(1, 2), norm="ortho")
        xf = xf.reshape(b, h, w // 2 + 1, self.num_blocks, c // self.num_blocks)

        total_modes = h // 2 + 1
        kept = int(total_modes * self.hard_thresholding_fraction)
        # kept region: rows [total - kept, total + kept) (clamped at h),
        # columns [0, kept)
        r0, r1 = total_modes - kept, total_modes + kept
        xk = xf[:, r0:r1, :kept]

        w1, b1, w2, b2 = (p.to(x.dtype) for p in (self.w1, self.b1, self.w2, self.b2))
        mul = lambda a, wgt: torch.einsum("...bi,bio->...bo", a, wgt)  # noqa: E731
        xr, xi = xk.real, xk.imag
        o1r = torch.relu(mul(xr, w1[0]) - mul(xi, w1[1]) + b1[0])
        o1i = torch.relu(mul(xi, w1[0]) + mul(xr, w1[1]) + b1[1])
        o2r = mul(o1r, w2[0]) - mul(o1i, w2[1]) + b2[0]
        o2i = mul(o1i, w2[0]) + mul(o1r, w2[1]) + b2[1]
        ok = torch.complex(softshrink(o2r, self.sparsity_threshold),
                           softshrink(o2i, self.sparsity_threshold))

        out = torch.zeros_like(xf)
        out[:, r0:r1, :kept] = ok
        y = torch.fft.irfft2(out.reshape(b, h, w // 2 + 1, c), s=(h, w), dim=(1, 2),
                             norm="ortho")
        return y.to(in_dtype) + bias


class AFNOBlock(nn.Module):
    """norm1 -> AFNO2D -> (+ residual) -> norm2 -> MLP -> + residual
    (reference Block, afnonet.py:283-323)."""

    def __init__(self, dim: int, mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 num_blocks: int = 8, sparsity_threshold: float = 0.01,
                 hard_thresholding_fraction: float = 1.0, double_skip: bool = True,
                 device=None, gen=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, device)
        self.filter = AFNO2D(dim, num_blocks, sparsity_threshold, hard_thresholding_fraction,
                             device=device, gen=gen)
        self.norm2 = LayerNorm(dim, device)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), drop_rate, device, gen)
        self.double_skip = double_skip

    def forward(self, x, rng=None):
        residual = x
        x = self.filter(self.norm1(x))
        if self.double_skip:
            x = x + residual
            residual = x
        return self.mlp(self.norm2(x), rng) + residual


class PatchEmbed(nn.Module):
    """The stride-p convolution of the reference's PatchEmbed
    (`patch_embed.proj`, weight (D, C, ph, pw)) as a reshape and one
    product over (p1 p2 c)-flattened patches."""

    def __init__(self, patch_size, in_chans: int, embed_dim: int, device=None, gen=None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Module()
        self.proj.weight = new_param((embed_dim, in_chans, *patch_size), device, gen,
                                     "trunc_normal")
        self.proj.bias = new_param((embed_dim,), device, gen)

    def forward(self, x):
        b, h, w, c = x.shape
        ph, pw = self.patch_size
        x = x.reshape(b, h // ph, ph, w // pw, pw, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // ph, w // pw, ph * pw * c)
        kernel = self.proj.weight.permute(2, 3, 1, 0).reshape(ph * pw * c, -1)
        dt = torch.promote_types(x.dtype, kernel.dtype)
        return torch.matmul(x.to(dt), kernel.to(dt)) + self.proj.bias.to(dt)


class AFNONet(nn.Module):
    """Patch-embedded AFNO transformer (reference AFNONet,
    afnonet.py:350-458): (B, H, W, in_chans) -> (B, H, W, out_chans).
    Built on `device` (CUDA unless "cpu" is asked for) with weights drawn
    from `seed`."""

    def __init__(self, img_size=(720, 1440), patch_size=(8, 8), in_chans: int = 26,
                 out_chans: int = 26, embed_dim: int = 768, depth: int = 12,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0, num_blocks: int = 8,
                 sparsity_threshold: float = 0.01, hard_thresholding_fraction: float = 1.0,
                 device=None, seed: int = 0):
        super().__init__()
        self.device = device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        ph, pw = patch_size
        self.grid = (img_size[0] // ph, img_size[1] // pw)
        self.patch_size = (ph, pw)
        self.out_chans = out_chans
        self.drop_rate = drop_rate
        self.patch_embed = PatchEmbed((ph, pw), in_chans, embed_dim, device, gen)
        self.pos_embed = new_param((1, self.grid[0] * self.grid[1], embed_dim), device, gen,
                                   "trunc_normal")
        self.blocks = nn.ModuleList([
            AFNOBlock(embed_dim, mlp_ratio, drop_rate, num_blocks, sparsity_threshold,
                      hard_thresholding_fraction, device=device, gen=gen)
            for _ in range(depth)
        ])
        self.head = _linear(embed_dim, out_chans * ph * pw, device, gen, bias=False)

    def forward(self, x, rng=None):
        b = x.shape[0]
        (gh, gw), (ph, pw) = self.grid, self.patch_size
        with span("net.encoder", x):
            x = self.patch_embed(x)
            x = x + self.pos_embed.reshape(1, gh, gw, -1).to(x.dtype)
            if self.drop_rate > 0.0 and rng is not None:
                # pos_drop after the positional-embed add (afnonet.py:385, 435)
                x = dropout(x, self.drop_rate, rng)
        for i, blk in enumerate(self.blocks):
            with span("net.block", x, i):
                x = blk(x, rng)
        with span("net.decoder", x):
            x = self.head(x).reshape(b, gh, gw, ph, pw, self.out_chans)
            return x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * ph, gw * pw, self.out_chans)


class PrecipNet(nn.Module):
    """Precipitation head over an AFNONet (reference PrecipNet,
    afnonet.py:326-348): periodic padding in longitude, zero padding in
    latitude, a 3x3 convolution and a ReLU.  The backbone's parameters are
    "backbone.*", as in the reference."""

    def __init__(self, backbone: AFNONet, seed: int = 1):
        super().__init__()
        self.backbone = backbone
        c, dev = backbone.out_chans, backbone.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        # flax nn.Conv's defaults: lecun_normal kernel, zero bias
        self.conv = nn.Module()
        self.conv.weight = nn.Parameter(_lecun_normal((c, c, 3, 3), 9 * c, dev, gen))
        self.conv.bias = new_param((c,), dev)

    def forward(self, x, rng=None):
        x = self.backbone(x, rng)
        x = torch.cat([x[:, :, -1:], x, x[:, :, :1]], dim=2)  # periodic in lon
        x = F.pad(x.permute(0, 3, 1, 2), (0, 0, 1, 1))  # zero rows in lat
        x = F.conv2d(x, self.conv.weight.to(x.dtype), self.conv.bias.to(x.dtype))
        return torch.relu(x).permute(0, 2, 3, 1)


def unlog_tp(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inverse log-precipitation transform (reference afnonet.py:55-60)."""
    return eps * (torch.exp(x) - 1.0)
