"""The program under test and its plain reference, by the configuration's
`family`: `families/<family>.py` holds what belongs to one family (see
`families/sfno_gcn.py`); this module finds it by name and adds what every
family shares: the seeded weights and the reference net that holds them,
and the controls of the check."""

from __future__ import annotations

import contextlib
import importlib

import torch

from port_bench.harness.weights import make_weights


def call(path: str, *args):
    """Call `module:function` with `args`."""
    mod, _, fn = path.partition(":")
    return getattr(importlib.import_module(mod), fn)(*args)


def family(cfg: dict):
    """`families/<family>.py` of the configuration."""
    return importlib.import_module(f"port_bench.families.{cfg['family']}")


def program_config(cfg: dict):
    """The program's config object for the configuration file."""
    return family(cfg).program_config(cfg)


def seeded_weights(cfg: dict, seed: int, device, tag: str = "weights") -> dict:
    """name -> fp32 tensor of the configuration's weights for `seed` (and
    `tag`: another tag draws another set)."""
    specs = family(cfg).parameter_specs(cfg)
    return make_weights(specs, cfg["weights"], seed, device, cfg["served_dtype"], tag)


def reference_net(cfg: dict, seed: int, device):
    """The plain reference, in fp32, with the seed's weights."""
    net = family(cfg).Net(cfg, device="meta")
    net.load_state_dict(seeded_weights(cfg, seed, device), assign=True)
    return net


@contextlib.contextmanager
def control(cfg: dict, net, kind: str | None):
    """While open, `net` computes the check's control (`kind`): TF32
    products for any family, else the family's own (float8 operands);
    `None` leaves it the reference."""
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = kind == "tf32"
    if kind is not None and not tf32:
        family(cfg).control(net, kind)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield net
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
