"""The traced run's reading of the device: torch.profiler's CUDA activity
(CUPTI: the device's records and the CUDA calls that issued them; no
operator tracing on the host, which would slow a host-bound step) over the
measured window, reduced to what the per-layer readers take.

- the window: the host's clock around it, from a synchronised start to a
  synchronised end, while the profiler records;
- busy: the union of every device interval (kernels, copies, memsets) in
  it, so work that overlaps on two streams counts once;
- device time by kernel name, of the copies between host and device, and
  of the program's hand-written kernels: the `__global__` functions of its
  CUDA sources, by name (they sit in anonymous namespaces, as some of
  torch's kernels do);
- a breakdown: the device operations that took most time, and the idle
  stretches summed by the CUDA call the host was in (or none).
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict
from pathlib import Path

from port_bench.harness.common import ROOT, gaps, union_length

_GLOBAL = re.compile(
    r"(?:__global__|CH_KERNEL)\s+(?:void\s+)?(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?"
    r"(?:void\s+)?(\w+)\s*\(")


def handwritten_kernels(csrc: Path = ROOT / "msfno_torch" / "csrc") -> set[str]:
    """Names of the `__global__` functions in the program's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(_GLOBAL.findall(path.read_text(errors="replace")))
    return names - {"__launch_bounds__"}


def base_name(name: str) -> str:
    """`void ns::kernel<T, 3>(Args)` and `void (anonymous
    namespace)::kernel<3>(Args)` -> `kernel`."""
    name = name.removeprefix("void ").strip().replace("(anonymous namespace)::", "")
    for stop in ("<", "("):
        name = name.split(stop, 1)[0]
    return name.rsplit("::", 1)[-1].strip()


# the device's own work; the device timeline also carries annotations of
# host ranges and synchronisation records, which are not work
WORK = ("kernel", "gpu_memcpy", "gpu_memset")
# a kernel record whose name is empty
UNNAMED = "(unnamed kernel)"


def reduce_events(events, handwritten: set[str], window_s: float) -> dict:
    """The record of one traced window of `window_s` seconds from (name,
    kind, is_device, start_ns, end_ns, thread) tuples, `kind` the profiler's
    activity type; `handwritten` the names of the program's own kernels."""
    device = [(n, k, s, e) for n, k, dev, s, e, _ in events if dev and k in WORK]
    if not device:
        return {}
    lo, hi = min(s for _, _, s, _ in device), max(e for _, _, _, e in device)
    spans = [(s, e) for _, _, s, e in device]
    busy = union_length(spans, lo, hi)
    by_name, kinds = defaultdict(float), defaultdict(float)
    copies = handmade = 0.0
    for n, k, s, e in device:
        d = (min(e, hi) - max(s, lo)) * 1e-9
        kinds[k] += d
        key = n if k != "kernel" else (base_name(n) or UNNAMED)
        by_name[key] += d
        if k == "gpu_memcpy":
            copies += d
        elif k == "kernel" and key in handwritten:
            handmade += d
    host = sorted(((s, e, n) for n, _, dev, s, e, _ in events if not dev),
                  key=lambda t: t[0])
    starts = [s for s, _, _ in host]
    # the host call reaching furthest among those begun by each point
    reach, far = [], (float("-inf"), "(no CUDA call)")
    for s, e, n in host:
        far = max(far, (e, n))
        reach.append(far)
    idle = defaultdict(float)
    for g0, g1 in gaps(spans, lo, hi):
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid) - 1
        label = reach[i][1] if i >= 0 and reach[i][0] >= mid else "(no CUDA call)"
        idle[label] += (g1 - g0) * 1e-9
    top = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]  # noqa: E731
    return {"window_s": window_s, "busy_s": busy * 1e-9, "copy_s": copies,
            "handwritten_s": handmade, "kernel_s": dict(by_name), "device_kinds_s": dict(kinds),
            "breakdown": {"device_ops": top(by_name), "idle_gaps": top(idle)}}


class DeviceTrace:
    """Context manager: records CUDA activity while enabled; `window_s` is
    set by the caller to the window's length on the host's clock."""

    def __init__(self, enabled: bool):
        self.enabled, self.prof, self.window_s = enabled, None, 0.0

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def record(self) -> dict:
        if self.prof is None:
            return {}
        import torch

        raw = self.prof.profiler.kineto_results.events()
        cuda = torch.autograd.DeviceType.CUDA
        # the host call behind each device record, by correlation id
        calls = {ev.correlation_id(): ev.name() for ev in raw if ev.device_type() != cuda}
        events = []
        for ev in raw:
            dev = ev.device_type() == cuda
            s = ev.start_ns()
            kind = activity(ev, calls.get(ev.correlation_id(), "")) if dev else "host"
            events.append((ev.name(), kind, dev, s, s + ev.duration_ns(), ev.start_thread_id()))
        return reduce_events(events, handwritten_kernels(), self.window_s)


def activity(ev, call: str) -> str:
    """The profiler's activity type of a device record; where this torch's
    records do not carry it, worked out from the name and the host call
    that issued it: a launch is a kernel, a synchronisation is none."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type())
    name = ev.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    if hasattr(ev, "is_user_annotation") and ev.is_user_annotation():
        return "gpu_user_annotation"
    if "Launch" in call or (name and "ync" not in call and "Wait" not in call):
        return "kernel"
    return "other"
