"""The harness on the CPU at a tiny size: the manifest against the
benchmark's contract, the result line's schema, the imports of a run, the
traffic's repeatability, the trace arithmetic, and the check failing under
planted faults and under the control."""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from conftest import BENCH, ROOT, tiny_config, tiny_mix

from port_bench.harness import common, traffic
from port_bench.harness.cell import metric_names, run_cell
from port_bench.harness.trace import reduce_events

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MANIFEST["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SEED = 2**31 + 99
FINETUNE = [c for c in CELLS if c.endswith(".finetune-ms1")]
ROLLOUTS = [c for c in CELLS if c not in FINETUNE]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _run(root, cell, trace=False, seconds=0.3, **kw):
    return run_cell(MANIFEST, cell, SEED, seconds, trace, "cpu", time.perf_counter(),
                    root=root, **kw)


# ------------------------------------------------------------- manifest


def test_manifest_keys_and_names():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert MANIFEST["paths"] == ["port_bench"]
    assert MANIFEST["command"][1] == "port_bench/run.py"
    assert 1 <= MANIFEST["run_seconds"] <= 51
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    names += CELLS + [c["name"] for c in MANIFEST["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(MANIFEST["end_to_end"]) + 1 <= 17


def test_manifest_bounds_and_sources():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
    for m in MANIFEST["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = e2e[m["moves"]].get("workloads", CELLS)
        assert set(m["workloads"]) <= set(moved)


def test_manifest_cells_and_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    assert sum(w["chips"] == 4 for w in MANIFEST["workloads"]) <= max(1, len(CELLS) // 4)
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(CELLS)
    for w in MANIFEST["workloads"]:
        f = common.load_json("workloads", w["name"])
        assert (f["config"], f["traffic"], f["chips"], f["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert w["config"] in configs
        common.load_json("traffic", w["traffic"])
        e2e = [m["name"] for m in metric_names(MANIFEST, w["name"], "end_to_end")]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert metric_names(MANIFEST, w["name"], "per_layer")
    for c in configs.values():
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert callable(common.load_module("metrics", m["name"]).read)


FAMILY_API = ("Net", "parameter_specs", "program_config", "control", "forward_flops",
              "launch_least_seconds", "build")


@pytest.mark.parametrize("config", [c["name"] for c in MANIFEST["configs"]])
def test_each_configuration_finds_its_family_by_name(config):
    """Everything of one family sits in `families/<family>.py`, found by the
    configuration file's `family`: the harness has no table of families."""
    from port_bench.harness import program

    cfg = common.load_json("configs", config)
    fam = program.family(cfg)
    assert fam.__name__ == f"port_bench.families.{cfg['family']}"
    for name in FAMILY_API:
        assert hasattr(fam, name), name
    assert fam.forward_flops(cfg) > 0


@pytest.mark.parametrize("cell", CELLS)
def test_each_mix_finds_its_generator_by_kind(cell):
    wl = common.load_json("workloads", cell)
    mix = common.load_json("traffic", wl["traffic"])
    assert traffic.generator(mix).__name__ == f"port_bench.generators.{mix['kind']}"


def test_no_harness_file_names_a_family_entry_or_kind():
    """The shared harness and the readers branch on no name of a family, an
    entry or a mix kind: a new one of each is a new file."""
    names = {"sfno_gcn", "afno", "finetune", "rollout", "train_pool", "ensemble_rollout"}
    shared = sorted((BENCH / "harness").glob("*.py")) + sorted((BENCH / "metrics").glob("*.py"))
    for path in shared + [BENCH / "run.py", BENCH / "calibrate.py"]:
        code = "\n".join(line.split("#")[0] for line in path.read_text().splitlines()
                         if not line.lstrip().startswith(('"', "'")))
        for name in names:
            assert f'"{name}"' not in code and f"'{name}'" not in code, (path.name, name)


def test_run_seconds_fit_the_full_check():
    runs = 2 + 14 * 24
    assert runs * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


# ------------------------------------------------------------ a run


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_schema(tiny_root, cell):
    # long enough for the 20 intervals a rollout's tail needs
    r = _run(tiny_root, cell, seconds=2.0)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"]: m["unit"] for m in metric_names(MANIFEST, cell, "end_to_end")}
    assert {k: v["unit"] for k, v in r["metrics"].items()} == want
    for v in r["metrics"].values():
        assert isinstance(v["value"], float) and math.isfinite(v["value"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


def test_a_run_loads_no_jax(tiny_root):
    """A whole tiny run in a fresh process, then its modules by top-level
    name."""
    code = (
        "import sys, time, json, pathlib; sys.path[:0] = [%r, %r]\n"
        "import torch; torch.set_num_threads(2)\n"
        "from port_bench.harness import common\n"
        "from port_bench.harness.cell import run_cell\n"
        "m = json.load(open(%r))\n"
        "for w in m['workloads']:\n"
        "    run_cell(m, w['name'], 5, 0.2, False, 'cpu', time.perf_counter(),\n"
        "             root=pathlib.Path(%r))\n"
        "print(json.dumps(common.forbidden_modules()))\n"
    ) % (str(ROOT), str(BENCH / "tests"), str(ROOT / "BENCHMARK.json"), str(tiny_root))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_forbidden_modules_compare_whole_top_level_names():
    found = common.forbidden_modules(["msfno_torch", "msfno_torch.ops", "jaxtyping",
                                      "jax.numpy", "jaxlib", "flax.linen", "msfno_tpu.ops"])
    assert found == ["flax.linen", "jax.numpy", "jaxlib", "msfno_tpu.ops"]


def test_run_without_a_card_prints_no_result(tmp_path):
    """The sandbox has no card: the entry exits non-zero with nothing on
    standard output; so does a checkout of only the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for where in (ROOT, tmp_path):
        out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0],
                              "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=where,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""


# ------------------------------------------------------------- traffic


def test_train_pool_repeats_from_its_seed():
    from port_bench.harness import program

    cfg, mix = tiny_config("sfno-fcnv2small-gcnfilm"), tiny_mix("finetune-ms1-pool8")
    net = program.reference_net(cfg, 5, "cpu")
    make = traffic.generator(mix).make
    a, b, c = (make(mix, cfg, s, "cpu", model=net) for s in (2**33 + 1, 2**33 + 1, 2**33 + 2))
    assert all(torch.equal(x, y) for x, y in zip(a[0:1], b[0:1]))
    assert torch.equal(a[1].isnan(), b[1].isnan()) and torch.equal(
        a[1].nan_to_num(), b[1].nan_to_num())
    assert not torch.equal(a[0], c[0]) and a[0].shape == c[0].shape
    # the same ocean for every seed
    assert torch.equal(a[1].isnan(), c[1].isnan())
    # every sample of the pool differs
    assert not torch.equal(a[0][0], a[0][1])
    # the first samples alone are the same values
    first = make(mix, cfg, 2**33 + 1, "cpu", model=net, count=2)
    assert torch.equal(first[0], a[0][:2])


def test_forecasts_repeat_from_their_seed():
    cfg, mix = tiny_config("sfno-fcnv2small-gcnfilm"), tiny_mix("ens4-s2s-672h")
    gen = traffic.generator(mix)
    (x1, s1), (x2, s2) = (gen.forecast(mix, cfg, 77, 1, "cpu") for _ in range(2))
    (x3, _) = gen.forecast(mix, cfg, 78, 1, "cpu")
    assert np.array_equal(x1, x2) and np.array_equal(np.nan_to_num(s1), np.nan_to_num(s2))
    assert not np.array_equal(x1, x3) and x1.shape == x3.shape
    w = gen.sst_windows(mix, cfg, s1)
    assert len(w) == gen.rollout_steps(mix)
    assert w[0].shape == (mix["members"], cfg["film"]["temporal_step"], *cfg["film"]["sst_shape"])
    assert np.array_equal(w[3], w[0], equal_nan=True) and not np.array_equal(
        w[4], w[0], equal_nan=True)


# -------------------------------------------------------------- trace


def test_union_of_overlapping_streams_counts_once():
    compute = [(0, 10), (12, 20), (25, 30)]
    copies = [(5, 14), (26, 28), (40, 45)]
    assert common.union_length(compute + copies, 0, 50) == 20 + 5 + 5
    assert sum(e - s for s, e in compute + copies) > 30
    assert common.union_length([(0, 10)], 2, 6) == 4
    assert common.gaps(compute + copies, 0, 50) == [(20, 25), (30, 40), (45, 50)]


def test_trace_reduction_on_a_synthetic_trace():
    ms = 1_000_000
    events = [("void (anonymous namespace)::wgmma_gemm<3>(Args)", "kernel", True, 0, 30 * ms, 0),
              ("void wgmma_gemm<1>(Args)", "kernel", True, 30 * ms, 35 * ms, 0),
              # torch's kernels in anonymous namespaces, and a record with no
              # name, are not the program's
              ("void (anonymous namespace)::softmax_warp<float>(float*)", "kernel", True,
               35 * ms, 38 * ms, 0),
              ("", "kernel", True, 38 * ms, 40 * ms, 0),
              ("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", True, 30 * ms, 60 * ms, 0),
              ("ampere_sgemm_128x64_nn", "kernel", True, 70 * ms, 80 * ms, 0),
              # annotations and synchronisation records are no work
              ("range", "gpu_user_annotation", True, 0, 100 * ms, 0),
              ("", "cuda_sync", True, 80 * ms, 99 * ms, 0),
              ("cudaMemcpyAsync", "host", False, 62 * ms, 68 * ms, 1),
              ("cudaStreamSynchronize", "host", False, 79 * ms, 100 * ms, 1)]
    rec = reduce_events(events, {"wgmma_gemm"}, 0.1)
    assert rec["window_s"] == pytest.approx(0.1)
    assert rec["busy_s"] == pytest.approx(0.07)
    assert rec["copy_s"] == pytest.approx(0.03) and rec["handwritten_s"] == pytest.approx(0.035)
    assert rec["kernel_s"]["softmax_warp"] == pytest.approx(0.003)
    assert rec["kernel_s"]["(unnamed kernel)"] == pytest.approx(0.002)
    assert dict(rec["breakdown"]["idle_gaps"]) == pytest.approx({"cudaMemcpyAsync": 0.01})
    idle_share = common.load_module("metrics", "device_idle.rollout").read(rec)
    assert idle_share == pytest.approx(30.0)


def test_kernel_names_in_anonymous_namespaces():
    from port_bench.harness.trace import base_name, handwritten_kernels

    assert base_name("void (anonymous namespace)::gcn_stencil<4>(GcnArgs)") == "gcn_stencil"
    assert base_name("void at::native::vectorized_elementwise_kernel<4, F>(int, F)") == (
        "vectorized_elementwise_kernel")
    assert base_name("") == ""
    # every kernel a CUDA source of the program defines is found by name
    assert {"wgmma_gemm", "gcn_stencil", "dw_mma", "tile_reduce"} <= handwritten_kernels()


def test_device_activity_without_the_profilers_type():
    """A torch whose trace records carry no activity type: copies by name,
    kernels by the launch that issued them, synchronisation records none."""
    from port_bench.harness.trace import activity

    class Record:
        def __init__(self, name):
            self._name = name

        def name(self):
            return self._name

    assert activity(Record("Memcpy HtoD (Pageable -> Device)"), "cudaMemcpyAsync") == "gpu_memcpy"
    assert activity(Record(""), "cudaLaunchKernel") == "kernel"
    assert activity(Record("ampere_sgemm"), "cuLaunchKernel") == "kernel"
    assert activity(Record(""), "cudaEventSynchronize") == "other"


def test_per_layer_readers_on_a_record():
    rec = {"window_s": 2.0, "busy_s": 1.5, "units_traced": 10,
           "steps": 10, "host_enqueue_s": 0.5, "flops_per_unit": 1e12,
           "peak_ops_per_s": 1e15, "handwritten_s": 0.4,
           "launches": {"spectral_mlp": 100, "gcn_layer": 10},
           "launch_least_s": {"spectral_mlp": 1e-3, "gcn_layer": 2e-3}}
    read = lambda n, r=rec: common.load_module("metrics", n).read(r)  # noqa: E731
    assert read("host_enqueue_ms.finetune") == pytest.approx(50.0)
    assert read("device_idle.finetune") == pytest.approx(25.0)
    assert read("mfu.finetune") == pytest.approx(0.5)
    assert read("kernels_roofline.finetune") == pytest.approx(30.0)
    assert read("kernels_roofline.finetune", {**rec, "handwritten_s": 0.0}) is None
    # a cell whose family has no hand-written kernel has nothing to read
    assert read("kernels_roofline.rollout", {**rec, "launch_least_s": {}}) is None


# ----------------------------------------------------- faults, control


def _fault_state_unchanged(monkeypatch, cell):
    from msfno_torch.training import optim

    monkeypatch.setattr(optim.Optimizer, "step", lambda self, p, g, s: s)


def _fault_step_returns_state(monkeypatch, cell):
    from msfno_torch.models.afno import afnonet
    from msfno_torch.models.sfno import sfnonet

    monkeypatch.setattr(sfnonet.FourierNeuralOperatorNetFilmed, "forward",
                        lambda self, x, *a, **k: x)
    monkeypatch.setattr(afnonet.AFNONet, "forward", lambda self, x, *a, **k: x)


def _fault_half_batch(monkeypatch, cell):
    """The second half of the members left out of each step: their states
    come back as they went in."""
    from msfno_torch.models.sfno import sfnonet

    real = sfnonet.FourierNeuralOperatorNetFilmed.forward

    def half(self, x, sst, scale=1.0, rng=None):
        h = max(1, x.shape[0] // 2)
        y = real(self, x[:h], sst[:h], scale, rng)
        return torch.cat([y, x[h:].to(y.dtype)], 0)

    monkeypatch.setattr(sfnonet.FourierNeuralOperatorNetFilmed, "forward", half)


def _fault_answer_altered(monkeypatch, cell):
    if "finetune" in cell:
        from msfno_torch.training import trainer

        real = trainer.Trainer._rollout_loss

        def scaled(self, *a, **k):
            loss, per_step = real(self, *a, **k)
            return loss * 2.0, per_step

        monkeypatch.setattr(trainer.Trainer, "_rollout_loss", scaled)
    else:
        import importlib

        rollout = importlib.import_module("msfno_torch.inference.rollout")
        real = rollout._collect
        monkeypatch.setattr(rollout, "_collect", lambda t, c: real(t, c) * 1.5)


FAULTS = {
    "state_unchanged": (_fault_state_unchanged, FINETUNE),
    "step_returns_state": (_fault_step_returns_state, ROLLOUTS),
    "half_batch": (_fault_half_batch, ["sfno-gcnfilm.ens4-s2s"]),
    "answer_altered": (_fault_answer_altered, CELLS),
}


@pytest.mark.parametrize("fault,cell", [(f, c) for f, (_, cells) in FAULTS.items()
                                        for c in cells])
def test_check_fails_under_a_fault(tiny_root, monkeypatch, fault, cell):
    FAULTS[fault][0](monkeypatch, cell)
    assert _run(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("cell", [c for c in CELLS if "afno" not in c])
def test_control_fails_the_check(tiny_root, cell):
    """The reference on float8 operands in the program's place reads above
    the cell's limit, through the run's own path."""
    wl = common.load_json("workloads", cell, tiny_root)
    control = _run(tiny_root, cell, seconds=2.0, control=True)["control"]
    assert any(v > wl["limits"][k] for k, v in control.items()), control


@pytest.mark.cuda
def test_tf32_control_fails_the_afno_check(tiny_root):
    """TF32 products act on the card only: the control of the fp32 cell."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 products need a CUDA device")
    cell = "afno-fourcastnet.s2s"
    wl = common.load_json("workloads", cell, tiny_root)
    r = run_cell(MANIFEST, cell, SEED, 2.0, False, torch.device("cuda", 0),
                 time.perf_counter(), root=tiny_root, control=True)
    assert r["control"]["field_gap"] > wl["limits"]["field_gap"]
