"""ContextCast masked autoencoder over SST (port of
msfno_tpu/models/film/mae.py; reference MSFNO/Models/mae/maenet.py).

Used two ways, as in the reference:
  1. pretraining: reconstruct randomly masked SST patches, predicting a
     per-patch (mean, std) trained with NormalCRPS (mae/model.py);
  2. FiLM generation: the encoder class token feeds a FeedForward film head
     (Film_wrapper, sfnonet.py:879-889; `FilmWrapper` here).

NaN-dominated tokens stay in the token grid: they are flagged invalid and
masked out of attention (NEG_INF as a key), of the reconstruction and of
the loss masks, as in the JAX package.  Random masking keeps the first
m_keep tokens of a per-sample argsort of uniform noise (maenet.py:234-246)
and gathers them, for both of the JAX package's realisations: a Python
float `mask_ratio` keeps max(int(n (1 - r)), 1) tokens (fp64 arithmetic),
a tensor ratio (the per-batch U(0.4, 0.8) of pretraining) keeps
max(floor(n (1 - r)), 1) computed in fp32.  The JAX package runs every token
through the encoder for a traced ratio and masks the dropped ones as keys;
gathering keeps the same tokens and gives the same outputs, up to the
order of a softmax's sums.

The network runs in fp32 whatever the film config's compute dtype: the
JAX wrapper passes it none.  Parameter names follow the flax modules:
`patch_norm1`, `patch_proj`, `enc_attn_{i}.inner.*` (the building blocks'
reference names: `to_qkv`, `to_out.0`, `net.{0,1,4}`), `to_mean`, ...
"""

from __future__ import annotations

import math

import torch
from torch import nn

from msfno_torch.models.film.attention import (
    Dense,
    FeedForward,
    LayerNorm,
    MaskedAttention,
    patchify,
    token_validity,
    unpatchify,
)


class LayerScaled(nn.Module):
    """Residual wrapper with an optional per-channel scale (maenet.py
    MHA / FFN): x + gamma * inner(x, ...)."""

    def __init__(self, inner: nn.Module, dim: int, layer_scale: float | None = None,
                 device=None):
        super().__init__()
        self.inner = inner
        self.gamma = None
        if layer_scale is not None:
            self.gamma = nn.Parameter(torch.full((dim,), float(layer_scale), device=device))

    def forward(self, x, *args, **kwargs):
        y = self.inner(x, *args, **kwargs)
        if self.gamma is not None:
            y = y * self.gamma
        return x + y


def _xavier_dense(d_in: int, d_out: int, device, gen) -> Dense:
    """A Dense with flax's xavier_uniform kernel and a zero bias."""
    layer = Dense(d_in, d_out, zero_init=True, device=device)
    limit = math.sqrt(6.0 / (d_in + d_out))
    with torch.no_grad():
        layer.weight.uniform_(-limit, limit, generator=gen)
    return layer


def kept_count(n: int, mask_ratio) -> int:
    """Tokens the encoder keeps: max(int(n (1 - r)), 1) for a Python
    float, max(floor(n (1 - r)), 1) in fp32 for a tensor ratio (a host
    read of the ratio)."""
    if isinstance(mask_ratio, torch.Tensor):
        m = torch.floor(n * (1.0 - mask_ratio.float()))
        return max(int(m.item()), 1)
    return max(int(n * (1.0 - mask_ratio)), 1)


class ContextCast(nn.Module):
    """Masked autoencoder over (B, T, H, W) SST (reference ContextCast,
    maenet.py:78-271).  The token grid, and with it the position codes, is
    fixed at build time by `sst_shape` (T, H, W)."""

    def __init__(self, sst_shape: tuple[int, int, int],
                 patch_size: tuple[int, int, int] = (28, 9, 9), encoder_dim: int = 512,
                 decoder_dim: int = 512, encoder_depth: int = 4, decoder_depth: int = 2,
                 heads: int = 8, dropout_rate: float = 0.0, predict_std: bool = True,
                 layer_scale: float | None = None, nan_mask_threshold: float = 0.5,
                 device=None, gen=None):
        super().__init__()
        t, h, w = sst_shape
        pt, ph, pw = patch_size
        pt = min(pt, t)
        if t % pt or h % ph or w % pw:
            raise ValueError(f"SST shape {(t, h, w)} not divisible by patch {(pt, ph, pw)}")
        self.patch = (pt, ph, pw)
        self.grid = (t // pt, h // ph, w // pw)
        self.nan_mask_threshold = nan_mask_threshold
        n, pdim = math.prod(self.grid), pt * ph * pw
        de, dd = encoder_dim, decoder_dim

        def normal(shape, std):
            return nn.Parameter(std * torch.randn(shape, device=device, generator=gen))

        self.patch_norm1 = LayerNorm(pdim, device=device)
        self.patch_proj = Dense(pdim, de, dtype="float32", device=device, gen=gen)
        self.patch_norm2 = LayerNorm(de, device=device)
        self.encoder_position_code = normal((n, de), 0.2)
        self.decoder_position_code = normal((n, dd), 0.2)
        self.class_token = normal((1, de), 0.02)
        self.mask_token = normal((1, dd), 0.02)

        def blocks(dim, depth, prefix):
            for i in range(depth):
                setattr(self, f"{prefix}_attn_{i}", LayerScaled(
                    MaskedAttention(dim, heads, dim // heads, dropout_rate, device=device,
                                    gen=gen), dim, layer_scale, device))
                setattr(self, f"{prefix}_ff_{i}", LayerScaled(
                    FeedForward(dim, 4 * dim, dropout_rate, device=device, gen=gen), dim,
                    layer_scale, device))

        blocks(de, encoder_depth, "enc")
        self.dec_proj_norm = LayerNorm(de, device=device)
        self.dec_proj = Dense(de, dd, dtype="float32", device=device, gen=gen)
        blocks(dd, decoder_depth, "dec")
        self.to_mean_norm = LayerNorm(dd, device=device)
        self.to_mean = _xavier_dense(dd, pdim, device, gen)
        self.predict_std = predict_std
        if predict_std:
            self.to_std_norm = LayerNorm(dd, device=device)
            self.to_std = _xavier_dense(dd, pdim, device, gen)
        self.depths = (encoder_depth, decoder_depth)

    def _stack(self, x, valid, prefix: str, depth: int, rng):
        for i in range(depth):
            x = getattr(self, f"{prefix}_attn_{i}")(x, valid, rng=rng)
            x = getattr(self, f"{prefix}_ff_{i}")(x, rng=rng)
        return x

    def _encode(self, obs, mask_ratio, noise, gen, rng):
        """Patch embedding, masking and the encoder: (z_enc with the class
        token first, kept token indices or None, kept (B, N), valid (B, N),
        NaN elements (B, N, pdim))."""
        if obs.dim() == 5:  # (B, C=1, T, H, W) -> (B, T, H, W)
            obs = obs[:, 0]
        b = obs.shape[0]
        tokens = patchify(obs.float(), *self.patch)
        n = tokens.shape[1]
        nan_el, valid = token_validity(tokens, self.nan_mask_threshold)
        z = self.patch_norm2(self.patch_proj(self.patch_norm1(torch.nan_to_num(tokens))))
        z = z + self.encoder_position_code

        if noise is None and gen is None:
            # only legitimate with no masking: a fixed mask pattern would be
            # frozen across every batch of a pretraining run
            if isinstance(mask_ratio, torch.Tensor) or mask_ratio != 0.0:
                raise ValueError("ContextCast: mask_ratio > 0 (or a tensor ratio) requires "
                                 "`noise` or a generator `gen`")
            keep_idx = None
            kept = torch.ones((b, n), dtype=torch.bool, device=obs.device)
            z_kept, valid_kept = z, valid
        else:
            if noise is None:
                noise = torch.rand((b, n), generator=gen, device=gen.device)
            m_keep = kept_count(n, mask_ratio)
            keep_idx = torch.argsort(noise.to(obs.device), dim=1, stable=True)[:, :m_keep]
            kept = torch.zeros((b, n), dtype=torch.bool, device=obs.device)
            kept.scatter_(1, keep_idx, True)
            z_kept = torch.gather(z, 1, keep_idx[..., None].expand(-1, -1, z.shape[-1]))
            valid_kept = torch.gather(valid, 1, keep_idx)

        ones = torch.ones((b, 1), dtype=torch.bool, device=obs.device)
        z_enc = torch.cat([self.class_token.expand(b, 1, -1), z_kept], dim=1)
        z_enc = self._stack(z_enc, torch.cat([ones, valid_kept], dim=1), "enc",
                            self.depths[0], rng)
        return z_enc, keep_idx, kept, valid, nan_el

    def encoder_class_token(self, obs, rng=None) -> torch.Tensor:
        """The encoder's class token at mask ratio 0, (B, encoder_dim): the
        FiLM generator's input to its head.  The decoder does not run (the
        JAX package's compiled film path drops it as dead code)."""
        return self._encode(obs, 0.0, None, None, rng)[0][:, 0]

    def forward(self, obs, mask_ratio=0.0, noise=None, gen=None, rng=None):
        """Returns ((mean, std), (loss_mask, nan_elements), cls_encoder,
        cls_decoder); mean, std and the masks are (B, T, H, W).

        `mask_ratio` is a Python float or a 0-d tensor; with a ratio above
        0 the shuffle comes from `noise` ((B, N) uniform) or is drawn from
        `gen`; `rng` drives dropout."""
        z_enc, keep_idx, kept, valid, nan_el = self._encode(obs, mask_ratio, noise, gen, rng)
        b, n = kept.shape
        cls_encoder = z_enc[:, 0]

        # decoder: project, mask tokens where the encoder dropped a token
        # (the kept ones back in their places), the position code
        y = self.dec_proj(self.dec_proj_norm(z_enc))
        cls_dec_in, y_kept = y[:, :1], y[:, 1:]
        if keep_idx is None:
            y_full = y_kept
        else:
            y_full = self.mask_token.expand(b, n, -1).clone()
            y_full = y_full.scatter(1, keep_idx[..., None].expand(-1, -1, y.shape[-1]), y_kept)
        y_full = torch.cat([cls_dec_in, y_full + self.decoder_position_code], dim=1)
        ones = torch.ones((b, 1), dtype=torch.bool, device=valid.device)
        y_full = self._stack(y_full, torch.cat([ones, valid], dim=1), "dec", self.depths[1],
                             rng)
        cls_decoder = y_full[:, 0]
        out_tok = y_full[:, 1:]

        to_img = lambda tok: unpatchify(tok, *self.patch, *self.grid)  # noqa: E731
        mean = to_img(self.to_mean(self.to_mean_norm(out_tok)))
        std = None
        if self.predict_std:
            std = to_img(self.to_std(self.to_std_norm(out_tok)))

        # loss masks as images: score only masked, valid, non-NaN elements
        scored = (~kept & valid)[..., None] & ~nan_el
        loss_mask = to_img(scored.float())
        nan_elements = to_img(nan_el | ~valid[..., None])
        return (mean, std), (loss_mask, nan_elements), cls_encoder, cls_decoder
