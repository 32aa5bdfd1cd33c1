"""Timers, the metric log and the training-loop unwind (this package's copy
of `Timer`, `FinTraining` and `LocalLog` from msfno_tpu/utils/observability.py;
reference MSFNO/utils.py:10-58)."""

from __future__ import annotations

import logging
import os
import time
from typing import Any

import numpy as np

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
