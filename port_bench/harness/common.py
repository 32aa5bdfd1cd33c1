"""Shared pieces of the benchmark: seeds, files found by name, the device
record, the ban on the JAX stack, and interval arithmetic."""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
# top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "msfno_tpu")


def derive_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (`tag`) of the run's seed: the same seed
    and tag always give the same number."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF]
    words += [ord(ch) for ch in tag]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def load_json(kind: str, name: str, root: Path = BENCH_DIR) -> dict:
    """`root/<kind>/<name>.json`: a configuration, a traffic mix or a cell."""
    path = root / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, root: Path = BENCH_DIR):
    """`root/<kind>/<name>.py` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} named {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"port_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules of the JAX stack or the JAX package, compared by whole
    top-level name (`msfno_torch` is not `msfno_tpu`)."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".", 1)[0] in FORBIDDEN})


def nvidia_smi() -> dict:
    """The card's name and power limit as nvidia-smi reads them; {} where
    it cannot run."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return {}
    if not out:
        return {}
    name, _, limit = out[0].partition(",")
    return {"smi_name": name.strip(), "power_limit": limit.strip()}


def union_length(intervals, lo: float, hi: float) -> float:
    """Length of the union of [start, end) intervals clipped to [lo, hi):
    overlapping work on several streams counts once."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi) that no interval covers."""
    spans = sorted((max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi)
    out, t = [], lo
    for s, e in spans:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))
