#!/usr/bin/env python3
"""Where the time of one serving step of the PyTorch port goes, on a CUDA card.

    python3 tools/profile_torch_step.py [--steps N] [--trace FILE]

Builds the full-width filmed SFNO of `msfno_torch.config.serving_config()`
(seeded random weights), runs two warm-up steps, then profiles N chained
steps with torch.profiler (CPU + CUDA activity).  Prints one JSON line per
kernel or op, sorted by device time (ms per step), the device busy share of
the window, and the card's name and power limit; with --trace, writes the
Chrome trace to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import model_inputs
    from msfno_torch.config import serving_config
    from msfno_torch.models import FourierNeuralOperatorNetFilmed
    from msfno_torch.runtime import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()
    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    cfg = serving_config()
    net = FourierNeuralOperatorNetFilmed(cfg, device=dev, seed=0)
    x0, _, sst_seq = model_inputs(cfg, dev, args.steps)
    with torch.inference_mode():
        state = x0
        for i in range(2):
            state = net(state, sst_seq[i % args.steps])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(args.steps):
                state = net(state, sst_seq[i])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / args.steps
    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): op-level rows
        # would count their kernels a second time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / args.steps, ev.key, ev.count // args.steps))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    for ms, key, count in rows[:25]:
        print(json.dumps({"op": key[:90], "ms_per_step": ms, "calls_per_step": count,
                          "share_of_busy": ms / busy if busy else None}))
    print(json.dumps({"card": card, "wall_ms_per_step": wall,
                      "device_busy_ms_per_step": busy,
                      "device_idle_share": 1.0 - busy / wall if wall else None}))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
