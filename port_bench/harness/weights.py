"""Seeded weights of a configuration, made on the device in one draw.

A configuration's reference module lists its parameters with an
initialisation family (`parameter_specs`); the configuration file's
`weights` table gives each family its mean and scale:

- `w<fan_in>` (a product's weight): normal, std `gain` / sqrt(fan_in);
- `spectral<fan_in>` (a complex weight's real pair): normal, std
  `spectral_gain` / sqrt(2 fan_in);
- any other family: normal with the table's [mean, std];
- `scale`: a factor on named parameters (a damped output layer).

All values come from one `torch.randn` over the summed element count, on
the device, from a generator seeded by the run's seed; with `served_dtype`
"bfloat16" every value is rounded to bf16, so the program's bf16 copy of
its weights holds exactly the values the fp32 reference is given.
"""

from __future__ import annotations

import math

import torch

from port_bench.harness.common import derive_seed


def family_std(kind: str, table: dict) -> tuple[float, float]:
    if kind.startswith("spectral"):
        return 0.0, table.get("spectral_gain", 1.0) / math.sqrt(2 * int(kind[8:]))
    if kind.startswith("w") and kind[1:].isdigit():
        return 0.0, table.get("gain", 1.0) / math.sqrt(int(kind[1:]))
    mean, std = table[kind]
    return float(mean), float(std)


def make_weights(specs, table: dict, seed: int, device, served_dtype: str = "float32",
                 tag: str = "weights") -> dict:
    """name -> fp32 tensor on `device` for every (name, shape, kind) of
    `specs`, drawn from `seed` under `tag`."""
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, tag))
    total = sum(math.prod(shape) for _, shape, _ in specs)
    draw = torch.randn(total, generator=gen, device=device)
    scale = table.get("scale", {})
    out, off = {}, 0
    for name, shape, kind in specs:
        n = math.prod(shape)
        mean, std = family_std(kind, table)
        t = draw[off:off + n].view(shape).mul_(std * scale.get(name, 1.0)).add_(mean)
        if served_dtype == "bfloat16":
            t = t.to(torch.bfloat16).float()
        out[name] = t
        off += n
    return out
