#!/usr/bin/env python3
"""Where the time of the MAE and FourCastNet steps goes, at full width on a
CUDA card (chip_smoke.py phase 15's configurations).

    python3 tools/profile_mae_afno.py

Profiles (torch.profiler, after two warm-up calls) three calls:
  - the MAE FiLM generator's film path (`FilmWrapper` with
    film_gen_type="mae" at FilmConfig's defaults: ContextCast's encoder
    over 800 tokens and the film head) on a (1, 28, 180, 360) SST;
  - one MAE pretraining step (`MAEWrapper.train_step`, batch 2, Adam);
  - one FourCastNet step (`get_model("fcn", "1")`, 720x1440x26).
For each: the host-clock ms of the call, the device-busy ms and share, the
CUDA kernels launched, and the ops by device time (table).  Prints the
card's name and power limit first.  No hand-written kernel runs here.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _profile(name, fn):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms, copy_ms = cs.device_busy_ms(prof)
    kernels = sum(ev.count for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    print(json.dumps({"call": name, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                      "of_which_copies_ms": copy_ms, "device_busy_share": busy_ms / wall_ms,
                      "cuda_kernels_launched": kernels}), flush=True)
    print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=12), flush=True)


def main() -> int:
    import torch

    from msfno_torch.config import FilmConfig, SFNOConfig, TrainConfig
    from msfno_torch.data.synthetic import synthetic_land_mask
    from msfno_torch.models import get_model
    from msfno_torch.models.film.wrapper import FilmWrapper
    from msfno_torch.runtime import resolve_device
    from msfno_torch.training.optim import Optimizer

    if not torch.cuda.is_available():
        print("profile_mae_afno: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    film = FilmConfig(film_gen_type="mae")
    g = torch.Generator(device=dev).manual_seed(0)
    sst = torch.randn((2, film.temporal_step, *film.sst_shape), device=dev, generator=g)
    sst[..., torch.as_tensor(synthetic_land_mask(*film.sst_shape), device=dev)] = float("nan")

    gen_net = FilmWrapper(film, device=dev, gen=g)
    with torch.inference_mode():
        _profile("mae_film_generator", lambda: gen_net(sst[:1]))
    del gen_net

    mae = get_model("mae", cfg=SFNOConfig(film=film), device=dev)
    opt = Optimizer(TrainConfig(learning_rate=1e-3))
    state = {"opt": opt.init(dict(mae.module.named_parameters()))}

    def pretrain_step():
        state["opt"], _ = mae.train_step(opt, state["opt"], sst, g)

    _profile("mae_pretrain_step", pretrain_step)
    del mae, state
    torch.cuda.empty_cache()

    fcn = get_model("fcn", "1", device=dev)
    c = fcn.cfg
    x = torch.randn((1, *c.img_size, c.in_chans), device=dev, generator=g)
    with torch.inference_mode():
        _profile("fcn_step", lambda: fcn.module(x))
    return 0


if __name__ == "__main__":
    sys.exit(main())
