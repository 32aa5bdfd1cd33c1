"""FiLM generator mux (port of msfno_tpu/models/film/wrapper.py; reference
Film_wrapper, sfnonet.py:863-912).

Selects the generator by film_gen_type and reshapes its output to
(B, 2, film_layers, num_film_features): gamma = [:, 0], beta = [:, 1].
For the "mae" generator, the ContextCast encoder's class token (at
mask_ratio 0) feeds a FeedForward film head (`film_head`, the reference's
`film_gen.film_head.net.{0,1,4}`), as in the reference (sfnonet.py:879-889,
900-912); with `cls_input` the forward takes a precomputed (B, embed_dim)
class token where the SST would go and only the film head is built.
`model_depth` is not wired to ContextCast (encoder depth 4, decoder depth
2, 8 heads), as in both the JAX package and the reference.
"""

from __future__ import annotations

from torch import nn

from msfno_torch.config import FilmConfig
from msfno_torch.models.film.attention import FeedForward
from msfno_torch.models.film.gcn import GCNFilmGenerator
from msfno_torch.models.film.mae import ContextCast
from msfno_torch.models.film.vit import ViTFilmGenerator


class FilmWrapper(nn.Module):
    def __init__(self, cfg: FilmConfig, device=None, gen=None):
        super().__init__()
        self.cfg = cfg
        out = cfg.num_film_features * cfg.film_layers * 2
        kind = cfg.film_gen_type
        if kind not in ("gcn", "gcn_custom", "transformer", "mae", "none", None):
            raise ValueError(
                f"unknown film_gen_type {kind!r}; expected gcn, gcn_custom, "
                "transformer, mae, or none"
            )
        if kind == "mae":
            if not cfg.cls_input:
                self.film_gen = ContextCast(
                    (cfg.temporal_step, *cfg.sst_shape), patch_size=cfg.patch_size,
                    encoder_dim=cfg.embed_dim, decoder_dim=cfg.embed_dim,
                    dropout_rate=cfg.dropout, nan_mask_threshold=cfg.nan_mask_threshold,
                    device=device, gen=gen,
                )
            self.film_head = FeedForward(cfg.embed_dim, cfg.mlp_dim, cfg.dropout, out_dim=out,
                                         init_scale=cfg.scale_weight, device=device, gen=gen)
        elif kind == "transformer":
            self.film_gen = ViTFilmGenerator(
                out, (cfg.temporal_step, *cfg.sst_shape), patch_size=cfg.patch_size,
                dim=cfg.embed_dim, depth=cfg.model_depth, mlp_dim=cfg.mlp_dim,
                nan_mask_threshold=cfg.nan_mask_threshold, dropout_rate=cfg.dropout,
                dtype=cfg.compute_dtype, device=device, gen=gen,
            )
        else:
            # "none"/None mean "no generator requested": the reference maps
            # them to the gcn_custom default (main.py:130-134)
            self.film_gen = GCNFilmGenerator(
                out, cfg.embed_dim, cfg.model_depth, custom=kind != "gcn",
                in_features=cfg.temporal_step, dtype=cfg.compute_dtype,
                use_pallas=cfg.pallas_gcn, device=device, gen=gen,
            )

    def forward(self, sst, rng=None):
        """(B, 2, film_layers, C); `rng` drives the ViT's and the MAE's
        dropout (the GCN generators have none).  With the "mae" generator
        and `cls_input`, `sst` is the (B, embed_dim) class token."""
        if self.cfg.film_gen_type == "mae":
            cls = sst if self.cfg.cls_input else self.film_gen.encoder_class_token(sst, rng=rng)
            x = self.film_head(cls, rng=rng)
        elif isinstance(self.film_gen, ViTFilmGenerator):
            x = self.film_gen(sst, rng=rng)
        else:
            x = self.film_gen(sst)
        cfg = self.cfg
        return x.reshape(sst.shape[0], 2, cfg.film_layers, cfg.num_film_features)
