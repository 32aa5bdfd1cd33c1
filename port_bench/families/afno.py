"""Family `afno`: FourCastNet's AFNO net (`msfno_torch`'s `fcn` registry
entry), with no hand-written kernel.  See `families/sfno_gcn.py` for what
a family provides."""

from __future__ import annotations

import dataclasses

from port_bench.harness.program import call
from port_bench.reference import afno as reference
from port_bench.work import flops

Net = reference.AFNONet
parameter_specs = reference.parameter_specs


def program_config(cfg: dict):
    base = call(cfg["program"]["config_fn"], cfg["in_chans"])
    return dataclasses.replace(
        base, img_size=tuple(cfg["img_size"]), scale_factor=cfg["patch_size"],
        embed_dim=cfg["embed_dim"], num_layers=cfg["depth"])


def control(net, kind: str) -> None:
    raise ValueError(f"afno has no control {kind!r} of its own")


def forward_flops(cfg: dict) -> float:
    return flops.afno_forward(cfg)


def launch_least_seconds(cfg: dict, batch: int) -> dict[str, float]:
    return {}


def build(cfg: dict) -> None:
    pass
