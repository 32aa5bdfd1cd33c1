"""Timers, the progress stepper, metric logging and provenance (port of
msfno_tpu/utils/observability.py; reference Timer / LocalLog,
MSFNO/utils.py:10-58, Stepper, MSFNO/Models/stepper.py:14-45, wandb and
mem_log, MSFNO/Models/train.py:75-144, 747-756, provenance,
MSFNO/Models/provenance.py:15-53, 262-281).

Host statistics are read from /proc and `os.times()` (Linux), not psutil;
device statistics from torch.cuda.
"""

from __future__ import annotations

import json
import logging
import os
import platform
import subprocess
import time
from typing import Any

import numpy as np
import torch

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
