"""FiLM generator mux (port of msfno_tpu/models/film/wrapper.py; reference
Film_wrapper, sfnonet.py:863-912).

Selects the generator by film_gen_type and reshapes its output to
(B, 2, film_layers, num_film_features): gamma = [:, 0], beta = [:, 1].
"""

from __future__ import annotations

from torch import nn

from msfno_torch.config import FilmConfig
from msfno_torch.models.film.gcn import GCNFilmGenerator


class FilmWrapper(nn.Module):
    def __init__(self, cfg: FilmConfig, device=None, gen=None):
        super().__init__()
        self.cfg = cfg
        out = cfg.num_film_features * cfg.film_layers * 2
        kind = cfg.film_gen_type
        if kind in ("transformer", "mae"):
            raise NotImplementedError(
                f"film_gen_type={kind!r}: the ViT and MAE generators come in a "
                "later slice"
            )
        if kind not in ("gcn", "gcn_custom", "none", None):
            raise ValueError(
                f"unknown film_gen_type {kind!r}; expected gcn, gcn_custom, "
                "transformer, mae, or none"
            )
        # "none"/None mean "no generator requested": the reference maps them
        # to the gcn_custom default (main.py:130-134)
        self.film_gen = GCNFilmGenerator(
            out, cfg.embed_dim, cfg.model_depth, custom=kind != "gcn",
            in_features=cfg.temporal_step, dtype=cfg.compute_dtype,
            use_pallas=cfg.pallas_gcn, device=device, gen=gen,
        )

    def forward(self, sst):
        x = self.film_gen(sst)
        cfg = self.cfg
        return x.reshape(sst.shape[0], 2, cfg.film_layers, cfg.num_film_features)
