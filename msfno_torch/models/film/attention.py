"""Transformer building blocks of the FiLM generators (port of
msfno_tpu/models/film/attention.py; reference MSFNO/Models/vit/vit.py
Attention / FeedForward / Transformer and MSFNO/Models/mae/maenet.py).

Masked pre-norm attention and feed-forward over a static token grid: the
reference drops NaN-dominated tokens, giving dynamic token counts
(vit.py:119-160, maenet.py:304-336); as in the JAX package the token count
stays static, invalid tokens are excluded as keys by an additive bias of
NEG_INF (not -inf, so a row whose keys are all masked stays finite) and
from any pooling.

Layers follow flax's `dtype=` semantics, which the JAX generators run
under: parameters stay fp32; a Dense casts its input and weights to the
compute dtype (with none, to the wider of input and weights); a LayerNorm
takes its statistics and affine in fp32 and returns the compute dtype.
Parameter names and layouts are the reference's (`to_qkv.weight` (3
inner, dim), `to_out.0`, `net.0` / `net.1` / `net.4`), as
msfno_tpu/models/convert.py exports them.  Dropout acts when a forward is
given a `torch.Generator` (`rng`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from msfno_torch.models.sfno.layers import dropout
from msfno_torch.runtime import torch_dtype

NEG_INF = -1e9
LN_EPS = 1e-6  # flax LayerNorm's epsilon


def patchify(x: torch.Tensor, pt: int, ph: int, pw: int) -> torch.Tensor:
    """(B, T, H, W) -> (B, N, pt*ph*pw) tokens, N = (T/pt)(H/ph)(W/pw), in
    the order of einops' "b (t pt) (h ph) (w pw) -> b (t h w) (pt ph pw)"."""
    b, t, h, w = x.shape
    x = x.reshape(b, t // pt, pt, h // ph, ph, w // pw, pw)
    return x.permute(0, 1, 3, 5, 2, 4, 6).reshape(b, -1, pt * ph * pw)


def unpatchify(tok: torch.Tensor, pt: int, ph: int, pw: int, t: int, h: int,
               w: int) -> torch.Tensor:
    """(B, N, pt*ph*pw) -> (B, T, H, W); t, h, w count patches."""
    b = tok.shape[0]
    x = tok.reshape(b, t, h, w, pt, ph, pw).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(b, t * pt, h * ph, w * pw)


def token_validity(tokens: torch.Tensor, nan_threshold: float):
    """(NaN mask per element, valid per token): a token is valid iff its
    NaN share is below the threshold (Transformer_patch_embedding.
    rm_embed_nan, maenet.py:318-327)."""
    nan_mask = torch.isnan(tokens)
    return nan_mask, nan_mask.float().mean(dim=-1) < nan_threshold


def masked_mean(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Mean over the token axis of the valid tokens, in x's dtype."""
    m = valid[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def _lecun_normal(shape, fan_in, device, gen) -> torch.Tensor:
    """flax's default Dense kernel init: a normal of variance 1 / fan_in
    truncated at two standard deviations (folded back by fmod)."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return torch.randn(shape, device=device, generator=gen).fmod(2.0) * std


class LayerNorm(nn.Module):
    """flax nn.LayerNorm (epsilon 1e-6, E[x^2] - E[x]^2 variance clipped at
    0) over the last axis, statistics and affine in fp32, output in
    `dtype`."""

    def __init__(self, dim: int, dtype="float32", device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, device=device))
        self.bias = nn.Parameter(torch.zeros(dim, device=device))
        self.dtype = torch_dtype(dtype)

    def forward(self, x):
        x = x.float()
        mu = x.mean(dim=-1, keepdim=True)
        var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        y = (x - mu) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias
        return y.to(self.dtype)


class Dense(nn.Module):
    """flax nn.Dense with a reference nn.Linear's weight (out, in): input,
    weight and bias cast to `dtype` (None: the wider of input and weight)
    before the product.  `init_scale` switches to the uniform(-s, s) init
    of kernel and bias, s = 1 / sqrt(fan_in) / init_scale (the MAE film
    head, sfnonet.py:884-889); `zero_init` to zeros."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, dtype=None,
                 init_scale: float | None = None, zero_init: bool = False, device=None,
                 gen=None):
        super().__init__()
        shape = (out_features, in_features)
        if zero_init:
            w = torch.zeros(shape, device=device)
        elif init_scale is not None:
            s = 1.0 / math.sqrt(in_features) / init_scale
            w = torch.empty(shape, device=device).uniform_(-s, s, generator=gen)
        else:
            w = _lecun_normal(shape, in_features, device, gen)
        self.weight = nn.Parameter(w)
        self.bias = None
        if bias:
            b = torch.zeros(out_features, device=device)
            if init_scale is not None and not zero_init:
                b.uniform_(-s, s, generator=gen)
            self.bias = nn.Parameter(b)
        self.dtype = None if dtype is None else torch_dtype(dtype)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = torch.matmul(x.to(dt), self.weight.to(dt).t())
        return y if self.bias is None else y + self.bias.to(dt)


class MaskedAttention(nn.Module):
    """Pre-norm multi-head self-attention with a key-validity mask
    (reference vit.py Attention, maenet.py MHA): the softmax is taken over
    the scores plus NEG_INF at invalid keys."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout_rate: float = 0.0,
                 dtype="float32", device=None, gen=None):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.dropout_rate = heads, dim_head, dropout_rate
        self.norm = LayerNorm(dim, dtype, device)
        self.to_qkv = Dense(dim, inner * 3, bias=False, dtype=dtype, device=device, gen=gen)
        # the reference's Sequential(Linear, Dropout): its Linear is "to_out.0"
        self.to_out = nn.ModuleList([Dense(inner, dim, dtype=dtype, device=device, gen=gen),
                                     nn.Identity()])

    def forward(self, x, valid=None, rng=None):
        b, n, _ = x.shape
        qkv = self.to_qkv(self.norm(x))
        q, k, v = (t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        scores = torch.matmul(q, k.transpose(-1, -2)) * self.dim_head ** -0.5
        if valid is not None:
            bias = torch.where(valid, 0.0, NEG_INF).to(scores.dtype)
            scores = scores + bias[:, None, None, :]
        attn = torch.softmax(scores, dim=-1)
        if self.dropout_rate > 0.0 and rng is not None:
            attn = dropout(attn, self.dropout_rate, rng)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(b, n, -1)
        return self.to_out[0](out)


class FeedForward(nn.Module):
    """LayerNorm -> Dense -> GELU (exact) -> Dense (reference vit.py
    FeedForward); `init_scale` gives both Denses the MAE film head's
    uniform init."""

    def __init__(self, dim: int, hidden_dim: int, dropout_rate: float = 0.0,
                 out_dim: int | None = None, dtype="float32", init_scale: float | None = None,
                 device=None, gen=None):
        super().__init__()
        self.dropout_rate = dropout_rate
        # the reference's Sequential(LayerNorm, Linear, GELU, Dropout, Linear,
        # Dropout): its parameters are "net.0", "net.1" and "net.4"
        self.net = nn.ModuleList([
            LayerNorm(dim, dtype, device),
            Dense(dim, hidden_dim, dtype=dtype, init_scale=init_scale, device=device, gen=gen),
            nn.Identity(), nn.Identity(),
            Dense(hidden_dim, out_dim or dim, dtype=dtype, init_scale=init_scale,
                  device=device, gen=gen),
            nn.Identity(),
        ])

    def forward(self, x, rng=None):
        y = F.gelu(self.net[1](self.net[0](x)))
        if self.dropout_rate > 0.0 and rng is not None:
            y = dropout(y, self.dropout_rate, rng)
        return self.net[4](y)


class Transformer(nn.Module):
    """Pre-norm residual transformer (reference vit.py Transformer): depth
    x (attention, feed-forward) pairs, then a LayerNorm."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout_rate: float = 0.0, dtype="float32", device=None, gen=None):
        super().__init__()
        self.layers = nn.ModuleList([
            nn.ModuleList([
                MaskedAttention(dim, heads, dim_head, dropout_rate, dtype, device, gen),
                FeedForward(dim, mlp_dim, dropout_rate, dtype=dtype, device=device, gen=gen),
            ]) for _ in range(depth)
        ])
        self.norm = LayerNorm(dim, dtype, device)

    def forward(self, x, valid=None, rng=None):
        for attn, ff in self.layers:
            x = x + attn(x, valid, rng)
            x = x + ff(x, rng)
        return self.norm(x)
