"""Tiny configurations of the benchmark's cells for its CPU tests, written
beside copies of the real traffic mixes and cells in a temporary root, so
that a test drives the harness as a run does, only smaller."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "port_bench"

TINY_SFNO = {"img_size": [32, 64], "in_chans": 8, "out_chans": 8, "embed_dim": 32,
             "num_layers": 3, "scale_factor": 2, "spectral_layers": 2,
             "film": {"film_gen_type": "gcn_custom", "model_depth": 2, "embed_dim": 16,
                      "temporal_step": 4, "sst_shape": [8, 16], "film_layers": 1}}
TINY_AFNO = {"img_size": [32, 64], "in_chans": 8, "out_chans": 8, "patch_size": 8,
             "embed_dim": 32, "depth": 2}
# channels that both orderings hold among their first eight
TINY_CHANNELS = ["10u", "2t", "msl", "sp"]
# the fine-tune's check at the tiny size: the bf16 program reads up to
# ~0.035 against the reference there (a tiny net averages less rounding
# than the cell's), the float8 control 0.12 or more; the cell's own
# limits come from readings at its full size
TINY_LIMITS = {"sfno-gcnfilm-fp32gen.finetune-ms1":
               {"loss_gap": 0.3, "grad_gap": 0.1, "change_gap": 0.08}}


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    tiny = TINY_SFNO if cfg["family"] == "sfno_gcn" else TINY_AFNO
    cfg.update({**tiny, "film": {**cfg["film"], **tiny["film"]}} if "film" in tiny else tiny)
    return cfg


def tiny_mix(name: str) -> dict:
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    if mix["kind"] == "train_pool":
        mix.update(pool=3)
    else:
        mix.update(lead_time_h=6 * 6, initial_states=2, collect_channels=TINY_CHANNELS)
    return mix


@pytest.fixture
def tiny_root(tmp_path):
    """A benchmark root with every cell of BENCHMARK.json at a tiny size."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for kind in ("configs", "traffic", "workloads"):
        (tmp_path / kind).mkdir()
    for c in bench["configs"]:
        (tmp_path / "configs" / f"{c['name']}.json").write_text(json.dumps(tiny_config(c["name"])))
    for w in bench["workloads"]:
        (tmp_path / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(tiny_mix(w["traffic"])))
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        wl["limits"] = TINY_LIMITS.get(w["name"], wl["limits"])
        (tmp_path / "workloads" / f"{w['name']}.json").write_text(json.dumps(wl))
    return tmp_path
