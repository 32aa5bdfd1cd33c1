"""Mix kind `train_pool`: `pool` distinct samples of `multi_step_training
+ 2` states and SST windows, resident on the device, which the trainer
cycles.  The first state of a sample is drawn from the seed; each later
one is a model (`make`'s `model`) stepped from the one before, plus
`target_noise` of its scale in smooth noise.  The entry that feeds the
trainer chooses the model: the plain reference with the mix's
`target_trainable` leaves (see `entries/finetune.py`).
"""

from __future__ import annotations

import torch

from port_bench.harness.common import derive_seed
from port_bench.harness.traffic import land_mask, smooth_field, sst_series


def make(mix: dict, cfg: dict, seed: int, device, model, count: int | None = None):
    """(era5 (P, S, B, H, W, C), sst (P, S, B, T, hs, ws)) on `device`;
    `model(state, sst)` steps the targets.  With `count`, the pool's first
    `count` samples alone, the same values."""
    p, b = min(mix["pool"], count or mix["pool"]), mix["batch"]
    s = mix["multi_step_training"] + 2
    h, w = cfg["img_size"]
    film = cfg["film"]
    t, (hs, ws) = film["temporal_step"], film["sst_shape"]
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, "train_pool"))
    land = land_mask(hs, ws, cfg["assumed"]["land_share"])
    era5 = torch.empty((p, s, b, h, w, cfg["in_chans"]), device=device)
    sst = torch.empty((p, s, b, t, hs, ws), device=device)
    for i in range(p):
        for k in range(s):
            era5[i, k] = smooth_field(gen, (b, h, w, cfg["in_chans"]), device)
            sst[i, k] = sst_series(gen, b, t, hs, ws, land, device)
        for k in range(1, s):
            with torch.no_grad():
                out = model(era5[i, k - 1], sst[i, k])
            rms = out.pow(2).mean(dim=(1, 2, 3), keepdim=True).sqrt()
            era5[i, k] = out + mix["target_noise"] * rms * era5[i, k]
    return era5, sst
