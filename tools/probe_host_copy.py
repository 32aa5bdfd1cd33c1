#!/usr/bin/env python3
"""Where a rollout field's trip to the host goes, on one card: one
full-width denormalised field, (1, 721, 1440, 73) fp32 = 303.2 MB, moved
five ways, each timed five times in turns after a first round that is
dropped:

  pinned_d2h             the card into a pinned buffer (non_blocking, then
                         synchronize): the copy stream's part of
                         `inference/rollout.py:_Fetch`;
  torch_empty_copy       a pinned buffer into a fresh pageable tensor
                         (torch.empty + copy_, the intra-op threads): the
                         worker thread's part of `_Fetch`;
  numpy_empty_torch_copy the same into a fresh numpy array;
  numpy_copyto           the same with np.copyto (one thread);
  pageable_cpu           the card into fresh pageable memory (`.cpu()`):
                         the synchronous fetch.

Prints the card's name and power limit, torch's thread count, whether the
host exposes transparent huge pages, then one JSON line of medians (ms)
and one of every time.

    python3 tools/probe_host_copy.py
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

SHAPE = (1, 721, 1440, 73)
ROUNDS = 6


def main() -> int:
    import numpy as np
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    thp = "/sys/kernel/mm/transparent_hugepage/enabled"
    print(json.dumps({"card": smi, "torch_threads": torch.get_num_threads(),
                      "cpus": os.cpu_count(),
                      "transparent_hugepage": open(thp).read().strip()
                      if os.path.exists(thp) else None}), flush=True)
    dev = torch.randn(SHAPE, device="cuda")
    pin = torch.empty(SHAPE, pin_memory=True)
    pin.copy_(dev)
    torch.cuda.synchronize()
    ways = {
        "pinned_d2h": lambda: pin.copy_(dev, non_blocking=True),
        "torch_empty_copy": lambda: torch.empty(SHAPE).copy_(pin).numpy(),
        "numpy_empty_torch_copy":
            lambda: torch.from_numpy(np.empty(SHAPE, np.float32)).copy_(pin).numpy(),
        "numpy_copyto": lambda: np.copyto(np.empty(SHAPE, np.float32), pin.numpy()),
        "pageable_cpu": lambda: dev.cpu().numpy(),
    }
    times = {k: [] for k in ways}
    for r in range(ROUNDS):
        for name, way in ways.items():
            t0 = time.perf_counter()
            out = way()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            del out
            if r:
                times[name].append(ms)
    print(json.dumps({k: statistics.median(v) for k, v in times.items()}))
    print(json.dumps(times))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
