"""The benchmark of msfno_torch on NVIDIA GPUs: one run of one cell.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout.  Prints the numbers the check compared,
each beside its limit, as the last lines of standard error, and one JSON
object as the last line of standard output.  Exits non-zero, printing no
result, where there is no CUDA device or fewer than the cell asks for, or
where a module of the JAX stack or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache of the program inside the checkout, at fixed paths
CACHE = ROOT / ".port_bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    from port_bench.harness import common

    wl = common.load_json("workloads", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"port_bench: cell {args.workload} needs {wl['chips']} CUDA device(s), "
              f"found {have}; no result", file=sys.stderr)
        return 2
    from port_bench.harness.cell import run_cell

    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), T_START)
    found = common.forbidden_modules()
    if found:
        print(f"port_bench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
