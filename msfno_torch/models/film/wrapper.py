"""FiLM generator mux (port of msfno_tpu/models/film/wrapper.py; reference
Film_wrapper, sfnonet.py:863-912).

Selects the generator by film_gen_type and reshapes its output to
(B, 2, film_layers, num_film_features): gamma = [:, 0], beta = [:, 1].
"""

from __future__ import annotations

from torch import nn

from msfno_torch.config import FilmConfig
from msfno_torch.models.film.gcn import GCNFilmGenerator
from msfno_torch.models.film.vit import ViTFilmGenerator


class FilmWrapper(nn.Module):
    def __init__(self, cfg: FilmConfig, device=None, gen=None):
        super().__init__()
        self.cfg = cfg
        out = cfg.num_film_features * cfg.film_layers * 2
        kind = cfg.film_gen_type
        if kind == "mae":
            raise NotImplementedError(
                "film_gen_type='mae': the MAE generator (models/film/mae.py) comes in the "
                "next slice"
            )
        if kind not in ("gcn", "gcn_custom", "transformer", "none", None):
            raise ValueError(
                f"unknown film_gen_type {kind!r}; expected gcn, gcn_custom, "
                "transformer, mae, or none"
            )
        if kind == "transformer":
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
        """(B, 2, film_layers, C); `rng` drives the ViT's dropout (the GCN
        generators have none)."""
        if isinstance(self.film_gen, ViTFilmGenerator):
            x = self.film_gen(sst, rng=rng)
        else:
            x = self.film_gen(sst)
        cfg = self.cfg
        return x.reshape(sst.shape[0], 2, cfg.film_layers, cfg.num_film_features)
