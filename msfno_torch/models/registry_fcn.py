"""FourCastNet (AFNO) wrappers (port of msfno_tpu/models/registry_fcn.py;
reference MSFNO/Models/fourcastnet/model.py).

Variants (SURVEY.md section 2.5):
  fcn 0 / release -> FourCastNet0, 20 channels (model.py:255-296)
  fcn 1 / latest  -> FourCastNet1, 26 channels (model.py:298-346)

The net takes and returns (B, 720, 1440, C), as in the JAX package and
the reference: no crop of the 721-row grid is added.
"""

from __future__ import annotations

from msfno_torch.config import SFNOConfig
from msfno_torch.convert import from_flax_afno_params
from msfno_torch.models.afno.afnonet import AFNONet
from msfno_torch.models.registry import ModelWrapper

FCN0_SFC = ["10u", "10v", "2t", "sp", "msl", "tcwv"]
FCN0_PL = (["t", "u", "v", "z", "r"], [1000, 850, 500, 50])
# 20-channel ordering EXACTLY as the reference lists it (model.py:266-287):
# NOT sfc-then-pl — t850 sits at index 5, tcwv at 19, r500 before r850
FCN0_ORDERING = [
    "10u", "10v", "2t", "sp", "msl", "t850",
    "u1000", "v1000", "z1000", "u850", "v850", "z850",
    "u500", "v500", "z500", "t500", "z50", "r500", "r850", "tcwv",
]

FCN1_SFC = ["10u", "10v", "2t", "sp", "msl", "tcwv", "100u", "100v"]
FCN1_PL = (["t", "u", "v", "z", "r"], [1000, 850, 500, 250, 50])
# 26-channel ordering = FCN0's 20 + the v0.1 additions, verbatim from
# model.py:309-336 (100u/100v then the 250 hPa levels)
FCN1_ORDERING = FCN0_ORDERING + ["100u", "100v", "u250", "v250", "z250", "t250"]


def fcn_config(channels: int) -> SFNOConfig:
    """The AFNO dims in the shared config container."""
    return SFNOConfig(
        img_size=(720, 1440),
        scale_factor=8,  # patch size
        in_chans=channels,
        out_chans=channels,
        embed_dim=768,
        num_layers=12,
        spectral_transform="fft",
        film=None,
    )


class FCNWrapper(ModelWrapper):
    """FourCastNet v1.  `load_model` reads this package's `.pt`, a JAX
    `.npz` (through `from_flax_afno_params`) and a reference checkpoint
    (`model_state`, "module." prefixes and the dead final norm dropped, the
    keys it does not load logged)."""

    ordering: list[str] = FCN1_ORDERING

    def build_module(self):
        c = self.cfg
        return AFNONet(
            img_size=c.img_size,
            patch_size=(c.scale_factor, c.scale_factor),
            in_chans=c.in_chans,
            out_chans=c.out_chans,
            embed_dim=c.embed_dim,
            depth=c.num_layers,
            device=self.device,
            seed=self.seed,
        )

    def from_flax(self, tree):
        return from_flax_afno_params(tree, (self.cfg.scale_factor, self.cfg.scale_factor))

    @classmethod
    def for_version(cls, version: str, cfg: SFNOConfig | None = None, **kw) -> "FCNWrapper":
        if version in ("0", "release"):
            w = cls(cfg or fcn_config(20), **kw)
            w.ordering = FCN0_ORDERING
            return w
        w = cls(cfg or fcn_config(26), **kw)
        w.ordering = FCN1_ORDERING
        return w
