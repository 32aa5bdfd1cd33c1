"""One run of one cell: set-up, the measured window (traced or not), the
program's state freed, the check against the plain reference, and the
result line.  Everything belonging to a cell is found by name:
`workloads/<cell>.json` names its configuration (`configs/`, whose
`family` names `families/<family>.py`), its traffic mix (`traffic/`,
whose `kind` names `generators/<kind>.py`), its entry
(`entries/<entry>.py`) and the limits of its check; every metric is a
reader `metrics/<metric>.py` of the run's record, read in the cells that
BENCHMARK.json lists for it.
"""

from __future__ import annotations

import importlib
import math
import sys
import time

import torch

from port_bench.harness import common, program
from port_bench.harness.trace import DeviceTrace
from port_bench.work.kernels import PEAK_OPS_PER_S


class CudaTiming:
    """Events on the current stream of the card: the device's clock."""

    def __init__(self, device):
        self.device = device

    def event(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    @staticmethod
    def elapsed(a, b) -> float:
        return a.elapsed_time(b) * 1e-3

    def sync(self):
        torch.cuda.synchronize(self.device)


class HostTiming:
    """The host's clock, for a run on the CPU (the harness's own tests)."""

    event = staticmethod(time.perf_counter)

    @staticmethod
    def elapsed(a, b) -> float:
        return b - a

    def sync(self):
        pass


def _launch_counts(on):
    if not on:
        return {}
    from msfno_torch.ops.kernels import launch_counts

    return launch_counts()


def _reset_launch_counts(on):
    if on:
        from msfno_torch.ops.kernels import reset_launch_counts

        reset_launch_counts()


def metric_names(bench: dict, cell: str, kind: str) -> list[dict]:
    """The metrics of `kind` ("end_to_end" or "per_layer") that BENCHMARK.json
    gives this cell."""
    return [m for m in bench[kind] if "workloads" not in m or cell in m["workloads"]]


def run_cell(bench: dict, cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root=common.BENCH_DIR, entry_hook=None,
             control: bool = False) -> dict:
    """The result of one run as a dict with the keys of the result line.
    `entry_hook(entry)`, when given, is called with the entry after its
    set-up (the harness's tests plant faults with it).  With `control`,
    the result also holds, under `control`, the numbers of the check's
    control against the reference (the calibration's upper readings)."""
    wl = common.load_json("workloads", cell, root)
    cfg = common.load_json("configs", wl["config"], root)
    mix = common.load_json("traffic", wl["traffic"], root)
    entry_mod = importlib.import_module(f"port_bench.entries.{wl['entry']}")
    cuda = torch.device(device).type == "cuda"
    timing = CudaTiming(device) if cuda else HostTiming()
    if cuda:
        program.family(cfg).build(cfg)
    entry = entry_mod.Entry(cfg, mix, seed, torch.device(device))
    entry.setup()
    if entry_hook is not None:
        entry_hook(entry)
    spans = {"trace": trace}
    with DeviceTrace(trace and cuda) as tr:
        timing.sync()
        t0 = time.perf_counter()
        setup_s = t0 - t_start - entry.reference_s
        _reset_launch_counts(trace)
        counts = entry.window(seconds, spans, timing)
        timing.sync()
        tr.window_s = time.perf_counter() - t0
        launches = _launch_counts(trace)
    traced = tr.record()
    if traced:
        print(f"port_bench: traced device seconds by activity {traced['device_kinds_s']}",
              file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    entry.release()
    reference = entry.reference()
    numbers = entry_mod.compare(entry.readings(), reference)
    limits = wl["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = (counts["failed"] == 0 and counts["attempted"] > 0
               and all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items()))

    rec = {**counts, **spans, **traced, "seconds": seconds, "setup_s": setup_s,
           "launches": launches,
           "launch_least_s": program.family(cfg).launch_least_seconds(cfg, entry.batch),
           "flops_per_unit": entry.flops_per_unit(),
           "peak_ops_per_s": PEAK_OPS_PER_S[cfg["precision"]]}
    metrics = {}
    for m in metric_names(bench, cell, "per_layer" if trace else "end_to_end"):
        value = common.load_module("metrics", m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": wl["chips"], "memory_peak_bytes": peak}
    if cuda:
        dev.update(common.nvidia_smi())
    result = {"correct": bool(correct), "attempted": counts["attempted"],
              "failed": counts["failed"], "metrics": metrics, "device": dev}
    if trace and traced:
        dev["busy_s"], dev["window_s"] = traced["busy_s"], traced["window_s"]
        result["breakdown"] = traced["breakdown"]
    if control:
        result["control"] = entry_mod.compare(entry.reference(control=True), reference)
    result["checks"] = checks
    return result
