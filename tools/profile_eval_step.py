#!/usr/bin/env python3
"""Where the time of one step of a checkpoint skill evaluation goes, at full
width on a CUDA card.

    python3 tools/profile_eval_step.py

Builds the kernels, writes a full-width npy store in a temporary directory
(chip_smoke.write_store, removed at the end) and takes 2 init times of 4
steps from it; saves the seeded `serving_config()` net as this package's
checkpoint.  Then:
  - `evaluate_checkpoints` of that checkpoint twice, host clock around each
    call (the first pays each cache's first use: SHT constants, the
    kernels' prepared weights, the checkpoint's page-cache read);
  - the evaluation loop by parts, synchronized after each: the rollout
    step, the target's copy to the card, the climatology, the two
    normalisations, `SkillSums.add` (ms per step, each step listed);
  - a third call under torch.profiler: the ops by host time and by device
    time (tables), with the device-busy share of the call.
Prints the card's name and power limit first.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS = 4
INITS = 2


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from msfno_torch.config import serving_config
    from msfno_torch.data.era5 import ERA5Dataset, NpyBackend
    from msfno_torch.inference import evaluate_checkpoints
    from msfno_torch.inference.evaluate import SkillSums, climatology_step
    from msfno_torch.inference.rollout import _states
    from msfno_torch.models import FourierNeuralOperatorNetFilmed
    from msfno_torch.ops.kernels import build
    from msfno_torch.runtime import resolve_device
    from msfno_torch.training import checkpoint as ckpt_io

    if not torch.cuda.is_available():
        print("profile_eval_step: no CUDA device is available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    dev = resolve_device()
    build()
    cfg = serving_config()
    root = tempfile.mkdtemp(prefix="msfno_eval_profile_")
    try:
        cs.write_store(root, cfg)
        norm, sst_norm = cs.store_normalizers(root)
        ds = ERA5Dataset(NpyBackend(root), multi_step=STEPS - 1,
                         temporal_step=cfg.film.temporal_step)
        batches = [ds.get_batch([i]) for i in range(INITS)]
        clim = torch.as_tensor(batches[0].era5[0, 0], device=dev).float()
        net = FourierNeuralOperatorNetFilmed(cfg, device=dev, seed=0)
        cp = ckpt_io.save_checkpoint(os.path.join(root, "checkpoint.pt"), net.state_dict(),
                                     extra={"film_scale": 1.0})

        def evaluate():
            return evaluate_checkpoints(net, [cp], batches, clim, STEPS, normalizer=norm,
                                        sst_normalizer=sst_norm)

        calls_ms = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            evaluate()
            torch.cuda.synchronize()
            calls_ms.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps({"evaluate_checkpoints_ms": calls_ms, "steps_a_call": STEPS * INITS,
                          "ms_per_step": [c / (STEPS * INITS) for c in calls_ms]}), flush=True)

        parts = {k: [] for k in ("step", "target", "climatology", "normalise", "metrics")}
        with torch.inference_mode():
            for b in batches:
                sums = SkillSums(STEPS, cfg.in_chans, dev)
                shape = (STEPS,) + tuple(b.era5.shape[1:])
                states = _states(net, b.era5[0], STEPS, b.sst[1:STEPS + 1], norm, sst_norm, 1.0)
                for k in range(STEPS):
                    marks = [time.perf_counter()]

                    def mark():
                        torch.cuda.synchronize()
                        marks.append(time.perf_counter())

                    state = next(states)
                    mark()
                    target = torch.as_tensor(np.asarray(b.era5[k + 1]), device=dev).float()
                    mark()
                    c = climatology_step(clim, k, shape, None, dev, False)
                    mark()
                    out_n = state.float()
                    fc, tn = norm(out_n, reverse=True), norm(target)
                    mark()
                    sums.add(k, fc, target, c, out_n, tn)
                    mark()
                    for key, a, z in zip(parts, marks, marks[1:]):
                        parts[key].append((z - a) * 1e3)
        print(json.dumps({"ms_by_part": parts,
                          "median_ms": {k: float(np.median(v)) for k, v in parts.items()}}),
              flush=True)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            evaluate()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy_ms, copy_ms = cs.device_busy_ms(prof)
        print(json.dumps({"profiled_call_ms": wall_ms, "device_busy_ms": busy_ms,
                          "of_which_copies_ms": copy_ms, "device_busy_share": busy_ms / wall_ms}),
              flush=True)
        print(prof.key_averages().table(sort_by="cpu_time_total", row_limit=15), flush=True)
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=15), flush=True)
    finally:
        shutil.rmtree(root)
    return 0


if __name__ == "__main__":
    sys.exit(main())
