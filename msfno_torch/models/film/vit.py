"""ViT FiLM generator (port of msfno_tpu/models/film/vit.py; reference
MSFNO/Models/vit/vit.py:163-258).

3-D patches of the coarse SST history (B, T, H, W), LayerNorm -> Dense ->
LayerNorm patch embedding, a learned position code, the pre-norm masked
transformer, the mean of the valid tokens and a zero-initialised film head.
NaN-heavy tokens (land) stay in the static token grid and are masked as
keys and in the pooling (attention.py).  The film head has no compute
dtype: it runs in fp32 on the pooled tokens, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from msfno_torch.models.film.attention import (
    Dense,
    LayerNorm,
    Transformer,
    masked_mean,
    patchify,
    token_validity,
)
from msfno_torch.models.sfno.layers import dropout


class PatchEmbedding(nn.Module):
    """The reference's to_patch_embedding: norm1 -> lin -> norm2."""

    def __init__(self, patch_dim: int, dim: int, dtype, device=None, gen=None):
        super().__init__()
        self.norm1 = LayerNorm(patch_dim, dtype, device)
        self.lin = Dense(patch_dim, dim, dtype=dtype, device=device, gen=gen)
        self.norm2 = LayerNorm(dim, dtype, device)

    def forward(self, tokens):
        return self.norm2(self.lin(self.norm1(tokens)))


class ViTFilmGenerator(nn.Module):
    """SST history (B, T, Hs, Ws) or (B, Hs, Ws) -> (B, out_features).
    The token grid, and with it the position code, is fixed at build time
    by `sst_shape` (T, Hs, Ws)."""

    def __init__(self, out_features: int, sst_shape: tuple[int, int, int],
                 patch_size: tuple[int, int, int] = (28, 9, 9), dim: int = 512,
                 depth: int = 6, heads: int = 16, dim_head: int = 64, mlp_dim: int = 512,
                 nan_mask_threshold: float = 0.5, dropout_rate: float = 0.0,
                 dtype="float32", device=None, gen=None):
        super().__init__()
        t, h, w = sst_shape
        pt, ph, pw = patch_size
        pt = min(pt, t)
        if t % pt or h % ph or w % pw:
            raise ValueError(f"SST shape {(t, h, w)} not divisible by patch {(pt, ph, pw)}")
        self.patch = (pt, ph, pw)
        self.nan_mask_threshold = nan_mask_threshold
        self.dropout_rate = dropout_rate
        n = (t // pt) * (h // ph) * (w // pw)
        self.to_patch_embedding = PatchEmbedding(pt * ph * pw, dim, dtype, device, gen)
        self.encoder_position_code = nn.Parameter(
            0.2 * torch.randn((1, n, dim), device=device, generator=gen))
        self.transformer = Transformer(dim, depth, heads, dim_head, mlp_dim, dropout_rate,
                                       dtype, device, gen)
        self.head_film = Dense(dim, out_features, zero_init=True, device=device)

    def forward(self, sst, rng=None):
        if sst.dim() == 3:
            sst = sst[:, None]
        tokens = patchify(sst.float(), *self.patch)
        _, valid = token_validity(tokens, self.nan_mask_threshold)
        x = self.to_patch_embedding(torch.nan_to_num(tokens))
        x = x + self.encoder_position_code
        if self.dropout_rate > 0.0 and rng is not None:
            x = dropout(x, self.dropout_rate, rng)
        x = self.transformer(x, valid, rng)
        return self.head_film(masked_mean(x, valid))
