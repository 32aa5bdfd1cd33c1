"""Timers, the progress stepper, metric logging and provenance (port of
msfno_tpu/utils/observability.py; reference Timer / LocalLog,
MSFNO/utils.py:10-58, Stepper, MSFNO/Models/stepper.py:14-45, wandb and
mem_log, MSFNO/Models/train.py:75-144, 747-756, provenance,
MSFNO/Models/provenance.py:15-53, 262-281), and the program's spans and
counters.

Host statistics are read from /proc and `os.times()` (Linux), not psutil;
device statistics from torch.cuda.

Spans (`span`) mark the program's layer boundaries: the trainer's phases,
the net's head, blocks and tail, the FiLM generator, the rollout's inputs,
outputs and fetch wait.  They record only while tracing is on: inside
`tracing()`, or while a torch.profiler records (its enabled flag,
`torch.autograd.profiler._is_profiler_enabled`).  Off, a span is one
check and a shared do-nothing context.  On, it records its name, host
start and end on the profiler's host clock (`time.time_ns()`, the clock
Kineto stamps host events with), its parent span, the current request
(`set_request`: a training step, or a forecast and its step) and its
thread; given a CUDA device it records a pair of timing events on the
current stream (none while that stream captures a graph), resolved only
when the totals are read; and it enters `record_function(name)`, so that a
profiler recording CPU activity shows it on the device timeline.  Totals
per name are kept, with a ring of the last `RING` raw spans; nothing is
written out.  Counters (`count`) are always on.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import logging
import os
import platform
import subprocess
import threading
import time
from typing import Any

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

log = logging.getLogger("msfno_torch")


class Timer:
    """Wall-clock context manager (reference Timer, utils.py:10-26)."""

    def __init__(self, label: str = "", divisor: int = 1):
        self.label = label
        self.divisor = max(divisor, 1)
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = (time.perf_counter() - self._t0) / self.divisor
        if self.label:
            log.info("%s: %.3fs", self.label, self.seconds)
        return False


class FinTraining(Exception):
    """Clean unwind of the training loop (reference FinTraining,
    MSFNO/utils.py; caught in main.py:271-272)."""


class Stepper:
    """Per-step throughput and ETA logger for inference rollouts
    (reference Stepper, stepper.py:14-45)."""

    def __init__(self, total_steps: int, log_every: int = 1):
        self.total = total_steps
        self.log_every = max(log_every, 1)
        self.t0 = time.perf_counter()

    def __call__(self, i: int, step_hours: int | None = None):
        if (i + 1) % self.log_every:
            return
        elapsed = time.perf_counter() - self.t0
        rate = (i + 1) / elapsed
        eta = (self.total - i - 1) / max(rate, 1e-9)
        lead = f" (+{step_hours * (i + 1)}h)" if step_hours else ""
        log.info("step %d/%d%s: %.2f steps/s, ETA %.0fs", i + 1, self.total, lead, rate, eta)


class LocalLog:
    """Append-dict metric log saved as .npy (reference LocalLog,
    utils.py:39-58).  Doubles as the writer interface: a wandb-like run can
    be attached via `mirror`."""

    def __init__(self, save_dir: str | None = None, mirror=None):
        self.save_dir = save_dir
        self.mirror = mirror
        self.records: list[dict[str, Any]] = []

    def log(self, metrics: dict[str, Any], step: int | None = None):
        rec = dict(metrics)
        if step is not None:
            rec["_step"] = step
        self.records.append(rec)
        if self.mirror is not None:
            if step is not None:
                self.mirror.log(metrics, step=step)
            else:
                self.mirror.log(metrics)

    def save(self, tag: str = ""):
        if self.save_dir is None:
            return None
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, f"training_log{tag}.npy")
        np.save(path, np.asarray(self.records, dtype=object), allow_pickle=True)
        return path


def nvidia_smi() -> str:
    """The first card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def gather_provenance_info(device=None) -> dict[str, Any]:
    """Module versions, platform and devices (reference
    provenance.py:262-281, minus its git probes).  `device`: the run's
    device (CUDA unless "cpu" is asked for).  On the card it records the
    card's name and power limit from nvidia-smi; a missing nvidia-smi is
    recorded as null only on a CPU run."""
    import scipy

    from msfno_torch.runtime import resolve_device

    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    info = {
        "platform": platform.platform(),
        "python": platform.python_version(),
        "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "scipy": scipy.__version__,
        "devices": ([torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
                    if on_card else ["cpu"]),
        "default_backend": dev.type,
    }
    if on_card:
        info["nvidia_smi"] = nvidia_smi()
    else:
        try:
            info["nvidia_smi"] = nvidia_smi()
        except (OSError, subprocess.SubprocessError):
            info["nvidia_smi"] = None
    return info


def dump_provenance(path: str, device=None) -> str:
    with open(path, "w") as f:
        json.dump(gather_provenance_info(device), f, indent=2)
    return path


def _meminfo_kib() -> dict[str, int]:
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, rest = line.split(":", 1)
            out[key] = int(rest.split()[0])
    return out


def _cpu_jiffies() -> tuple[int, int]:
    """(busy, total) jiffies of all CPUs since boot (/proc/stat)."""
    with open("/proc/stat") as f:
        fields = [int(x) for x in f.readline().split()[1:]]
    idle = fields[3] + (fields[4] if len(fields) > 4 else 0)  # idle + iowait
    total = sum(fields[:8])  # user .. steal; guest time is inside user
    return total - idle, total


def _rss_kib() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


def system_monitor(printout: bool = True, interval: float = 0.1) -> dict:
    """Host RAM, CPU and this process's share (the keys of the JAX
    package's psutil version, reference system_monitor,
    provenance.py:15-53): used RAM is total minus available, both CPU
    percentages are sampled over one `interval` (percent of one core for
    the process, as psutil gives it)."""
    mem = _meminfo_kib()
    total = mem["MemTotal"] * 1024
    used = total - mem.get("MemAvailable", mem["MemFree"]) * 1024
    busy0, all0 = _cpu_jiffies()
    t0, w0 = os.times(), time.perf_counter()
    time.sleep(interval)
    busy1, all1 = _cpu_jiffies()
    t1, w1 = os.times(), time.perf_counter()
    proc_s = (t1.user + t1.system) - (t0.user + t0.system)
    stats = {
        "ram_total_gb": round(total / 2**30, 2),
        "ram_used_gb": round(used / 2**30, 2),
        "ram_percent": round(100.0 * used / total, 1),
        "cpu_percent": round(100.0 * (busy1 - busy0) / max(all1 - all0, 1), 1),
        "process_rss_gb": round(_rss_kib() * 1024 / 2**30, 2),
        "process_cpu_percent": round(100.0 * proc_s / max(w1 - w0, 1e-9), 1),
    }
    if printout:
        log.info("system: %s", stats)
    return stats


def device_memory_stats() -> list[dict]:
    """Per-card memory (the JAX package's keys; reference mem_log,
    train.py:747-756): bytes in use and their peak from the caching
    allocator, the card's memory as the limit.  Empty without a card."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out


def create_writer(save_dir: str | None = None, use_wandb: bool = False,
                  project: str | None = None, run_name: str | None = None,
                  resume_id: str | None = None) -> LocalLog:
    """Writer factory (reference set_logger, train.py:75-144): a LocalLog
    that mirrors into a wandb run when asked for and wandb is installed;
    resume_id resumes a run with resume="must" (train.py:106-114).  Only
    rank 0 of an initialised torch.distributed group saves or opens wandb:
    other ranks keep their records in memory."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_rank() != 0:
        save_dir, use_wandb = None, False
    mirror = None
    if use_wandb:
        try:
            import wandb  # type: ignore
        except ImportError as e:
            log.warning("wandb unavailable (%s); logging locally only", e)
        else:
            kwargs = dict(project=project or "msfno-torch", name=run_name)
            if resume_id:
                kwargs.update(id=resume_id, resume="must")
            mirror = wandb.init(**kwargs)
    return LocalLog(save_dir=save_dir, mirror=mirror)


# ------------------------------------------------------- spans and counters

RING = 65536  # raw spans kept for export; totals per name cover all

_tracing = 0  # depth of `tracing()` contexts held
_local = threading.local()  # per thread: .stack (open span ids), .request
_lock = threading.Lock()
_ids = itertools.count(1)
_totals: dict[str, list] = {}  # name -> [count, host ns, device s or None]
_ring: collections.deque = collections.deque()
_counters: dict[str, int] = {}
_traced_counters: dict[str, int] = {}
_off_sites: dict[str, "_OffSpan"] = {}


@contextlib.contextmanager
def tracing():
    """Spans record while this is held, with or without a profiler."""
    global _tracing
    _tracing += 1
    try:
        yield
    finally:
        _tracing -= 1


def set_request(request) -> None:
    """The request this thread's spans belong to from now on: a training
    step's number, or (forecast, step)."""
    _local.request = request


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` (always on).  While tracing is on the
    count also goes to the traced tallies (`counters(traced=True)`)."""
    traced = _tracing or _autograd_profiler._is_profiler_enabled
    with _lock:
        _counters[name] = _counters.get(name, 0) + n
        if traced:
            _traced_counters[name] = _traced_counters.get(name, 0) + n


def counters(traced: bool = False) -> dict[str, int]:
    """Every counter: the program's, and the kernels' launches under
    `launches/<kernel>` (`ops.kernels.launch_counts`).  With `traced`, only
    the program's counts made while tracing was on."""
    if traced:
        return dict(_traced_counters)
    from msfno_torch.ops.kernels import launch_counts

    return {**_counters, **{f"launches/{k}": v for k, v in launch_counts().items()}}


def upload(x, device, dtype=None) -> torch.Tensor:
    """`torch.as_tensor(x, dtype, device)`, counting under `uploads.pageable`
    a host array or an unpinned host tensor (on a card, a copy that
    synchronises the stream)."""
    if not isinstance(x, torch.Tensor) or (x.device.type == "cpu" and not x.is_pinned()):
        count("uploads.pageable")
    return torch.as_tensor(x, dtype=dtype, device=device)


class _Record:
    __slots__ = ("name", "id", "parent", "request", "thread", "index", "start_ns",
                 "end_ns", "events", "device_s")

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__ if k != "events"}


def _settle(rec: _Record) -> None:
    """Resolve a span's device events into its device time and its name's
    total; the end event is waited for only if it has not completed."""
    start, end = rec.events
    if not end.query():
        end.synchronize()
    rec.events, rec.device_s = None, start.elapsed_time(end) * 1e-3
    total = _totals[rec.name]
    total[2] = (total[2] or 0.0) + rec.device_s


class _Span:
    """A recording span (tracing on)."""

    __slots__ = ("rec", "device", "rf")

    def __init__(self, name, device, index):
        rec = self.rec = _Record()
        rec.name, rec.index, rec.events, rec.device_s = name, index, None, None
        if device is not None and not isinstance(device, torch.device):
            device = device.device
        self.device = device

    def __enter__(self):
        rec = self.rec
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec.id = next(_ids)
        rec.parent = stack[-1] if stack else None
        rec.request = getattr(_local, "request", None)
        rec.thread = threading.get_ident()
        stack.append(rec.id)
        self.rf = torch.profiler.record_function(rec.name)
        self.rf.__enter__()
        rec.start_ns = time.time_ns()  # inside the profiler's range
        dev = self.device
        if dev is not None and dev.type == "cuda" and not torch.cuda.is_current_stream_capturing():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            rec.events = (start, None)
        return rec

    def __exit__(self, typ, value, tb):
        rec = self.rec
        if rec.events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            rec.events = (rec.events[0], end)
        rec.end_ns = time.time_ns()
        self.rf.__exit__(typ, value, tb)
        _local.stack.pop()
        host_ns = rec.end_ns - rec.start_ns
        if self.device is not None and self.device.type == "cpu":
            rec.device_s = host_ns * 1e-9  # the CPU's work ran inside the span
        with _lock:
            total = _totals.get(rec.name)
            if total is None:
                total = _totals[rec.name] = [0, 0, None]
            total[0] += 1
            total[1] += host_ns
            if rec.device_s is not None:
                total[2] = (total[2] or 0.0) + rec.device_s
            elif rec.events is not None and total[2] is None:
                total[2] = 0.0
            _ring.append(rec)
            if len(_ring) > RING:
                old = _ring.popleft()
                if old.events is not None:
                    _settle(old)
        return False

    def __call__(self, fn):
        return _decorate(fn, self.rec.name)


class _OffSpan:
    """The do-nothing span of one name (tracing off)."""

    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        return None

    def __exit__(self, typ, value, tb):
        return False

    def __call__(self, fn):
        return _decorate(fn, self.name)


def _decorate(fn, name):
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return traced


def span(name: str, device=None, index=None):
    """A span of the program's work named `name`: a context manager, or a
    decorator (recording each call under `name`).  `device`: where the work
    runs, a torch.device or a tensor on it; on a CUDA device the span also
    times the work on the device, on the CPU the device time is the host
    time.  `index`: the work's place among its siblings (a block's number),
    kept with the raw span.  Records only inside `tracing()` or while a
    torch.profiler records; off, it allocates nothing (so it takes no
    keyword attributes: their dict would be made on every call)."""
    if not (_tracing or _autograd_profiler._is_profiler_enabled):
        site = _off_sites.get(name)
        if site is None:
            site = _off_sites[name] = _OffSpan(name)
        return site
    return _Span(name, device, index)


def span_totals() -> dict[str, dict]:
    """Per span name: `count`, `host_s` and `device_s` (None where its spans
    had no device) since `reset_tracing`.  Device times of spans whose end
    event has not completed are left out: synchronise first."""
    with _lock:
        for rec in _ring:
            if rec.events is not None and rec.events[1].query():
                _settle(rec)
        return {name: {"count": c, "host_s": ns * 1e-9, "device_s": dev}
                for name, (c, ns, dev) in _totals.items()}


def raw_spans() -> list[dict]:
    """The last `RING` spans, oldest first: name, id, parent, request,
    thread, index, start_ns and end_ns on the profiler's host clock, and
    device_s (None where not timed or not yet completed)."""
    span_totals()
    with _lock:
        return [rec.as_dict() for rec in _ring]


def reset_tracing() -> None:
    """Clear the span totals, the raw spans and the program's counters
    (the kernels' launch counts are `ops.kernels.reset_launch_counts`)."""
    with _lock:
        _totals.clear()
        _ring.clear()
        _counters.clear()
        _traced_counters.clear()
