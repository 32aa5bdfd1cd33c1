"""Family `sfno_gcn`: the GCN-filmed SFNO (`msfno_torch`'s filmed
FourierNeuralOperatorNet) as a configuration file of this family names it.

What the harness asks of a family, found by the configuration's `family`:
the program's config object, the plain reference net and its parameters,
the trainable leaves of a fine-tune, the controls of the check, the model
FLOPs of a forward and of a training step, each hand-written kernel's
least time per launch, and the build of those kernels.
"""

from __future__ import annotations

import dataclasses

from port_bench.harness.program import call
from port_bench.reference import sfno_gcn as reference
from port_bench.work import flops, kernels

Net = reference.FilmedSFNO
parameter_specs = reference.parameter_specs
trainable = reference.film_params
train = reference.train


def program_config(cfg: dict):
    """The configuration's function (`program.config_fn`), its sizes
    replaced by the file's."""
    base = call(cfg["program"]["config_fn"])
    film = cfg["film"]
    film_cfg = dataclasses.replace(
        base.film, film_gen_type=film["film_gen_type"], model_depth=film["model_depth"],
        embed_dim=film["embed_dim"], temporal_step=film["temporal_step"],
        sst_shape=tuple(film["sst_shape"]), film_layers=film["film_layers"],
        compute_dtype=film["compute_dtype"], num_film_features=cfg["embed_dim"])
    return dataclasses.replace(
        base, img_size=tuple(cfg["img_size"]), in_chans=cfg["in_chans"],
        out_chans=cfg["out_chans"], embed_dim=cfg["embed_dim"],
        num_layers=cfg["num_layers"], scale_factor=cfg["scale_factor"],
        spectral_layers=cfg["spectral_layers"], mlp_ratio=cfg["mlp_ratio"], film=film_cfg)


def control(net, kind: str) -> None:
    """Put the precision below the configuration's into the reference."""
    if kind != "fp8_operands":
        raise ValueError(f"sfno_gcn has no control {kind!r}")
    net.q = reference.fp8_operands


def forward_flops(cfg: dict) -> float:
    return flops.sfno_gcn_forward(cfg)


def train_flops(cfg: dict, multi_step_training: int) -> float:
    return flops.sfno_gcn_finetune(cfg, multi_step_training)


def launch_least_seconds(cfg: dict, batch: int) -> dict[str, float]:
    return kernels.launch_least_seconds(cfg, batch)


def build(cfg: dict) -> None:
    """Build the family's hand-written kernels that are not built yet, all
    at once, into the program's build directory inside the checkout."""
    from msfno_torch.ops.kernels import build as build_kernels

    build_kernels(tuple(kernels.launch_least_seconds(cfg, 1)))
