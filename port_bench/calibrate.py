"""Readings that set a cell's check limits, on the card at the cell's own
size, through the run's own path (`run_cell`) with a short window: for
each seed, the program's numbers against the plain fp32 reference (the
lower readings) and, for the first `--control-seeds` seeds, the control's:
the reference computed a precision below the configuration's (the upper
readings).  The window has to hold what a run compares: a rollout cell's
first forecast whole (`--seconds` 12 at its load), a fine-tune's check
steps come before it (`--seconds` 1).

    python3 port_bench/calibrate.py --workload <cell> --seconds <s> --seeds 1 2 3 [--control-seeds 3]

prints one JSON line per seed.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(bench: dict, cell: str, seed: int, seconds: float, control: bool, device,
             root=None) -> dict:
    from port_bench.harness import common
    from port_bench.harness.cell import run_cell

    entries = []
    t = time.perf_counter()
    result = run_cell(bench, cell, seed, seconds, False, device, t,
                      root=root or common.BENCH_DIR, entry_hook=entries.append,
                      control=control)
    out = {"cell": cell, "seed": seed, "seconds": time.perf_counter() - t,
           "correct": result["correct"], "attempted": result["attempted"],
           "program": {k: c["value"] for k, c in result["checks"].items()}}
    if control:
        out["control"] = result["control"]
    losses = getattr(entries[0], "reference_losses", None)
    if losses:
        out["losses"] = losses
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for i, seed in enumerate(args.seeds):
        rec = readings(bench, args.workload, seed, args.seconds, i < args.control_seeds,
                       torch.device("cuda", 0))
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
