"""The port's command line (`python -m msfno_torch.cli`) against the JAX
package's (msfno_tpu/cli.py): the parsers, the configs they assemble, the
resume merge, and the tiny actions of tests/test_cli.py run with --cpu.
The two CLIs' trained parameters and forecasts are compared in
tests/test_torch_cli_parity.py."""

import json
import os

import numpy as np
import pytest
import torch

from msfno_torch import cli
from msfno_tpu import cli as jcli

TINY = ["--img-size", "16", "32", "--scale-factor", "2", "--in-chans", "3",
        "--out-chans", "3", "--embed-dim", "8", "--num-layers", "2",
        "--spectral-layers", "1", "--synthetic-data", "--cpu"]
TINY_REAL = [a for a in TINY if a != "--synthetic-data"]
FILM = ["--model-version", "film", "--coarse-level", "2", "--model-depth", "1",
        "--film-embed-dim", "8", "--mlp-dim", "8", "--temporal-step", "2"]
FINETUNE = ["--model-version", "film", "--compute-dtype", "bfloat16", "--use-pallas",
            "--pallas-grid-mlp", "--spectral-mxu-dtype", "bfloat16", "--sht-mxu-dtype",
            "bfloat16", "--film-compute-dtype", "bfloat16", "--bf16-frozen-params",
            "--film-scale-start", "1.0", "--synthetic-data"]

ARGVS = {
    "defaults": [],
    "train": TINY + ["--train", "--num-iterations", "2", "--validation-interval", "0",
                     "--output-path", "out", "--seed", "7", "--debug", "--log-file", "l.txt"],
    "run": ["--run", "--lead-time", "12", "--date", "20200101", "--time", "6", "--output",
            "netcdf", "--output-variables", "v.json", "--hindcast",
            "--hindcast-reference-year", "2015", "--era5-path", "x.npy", "--sst-path", "s.npy",
            "--resume-checkpoint", "c.pt", "--film-weights", "f.npz", "--assets", "a"],
    "eval_and_tools": ["--eval-model", "--checkpoint-list", "a.pt", "b.npz", "--eval-sfno",
                       "--climatology-path", "c.npy", "--save-forecast", "--test-performance",
                       "--test-dataloader-speed", "--test-batch-size", "--batch-size-step",
                       "2", "--save-data", "--dump-provenance", "--multi-step-validation", "2",
                       "--validation-step-skip", "1", "--profile-dir", "p"],
    "training": ["--train", "--scheduler", "cosine", "--scheduler-horizon", "4000",
                 "--batch-size", "2", "--accumulation-steps", "1", "--optimizer", "adamw",
                 "--weight-decay", "0.01", "--training-step-skip", "1",
                 "--multi-step-training", "2", "--time-limit", "01:30:00", "--scan-steps", "4",
                 "--retrain-film", "--resume-optimizer", "--resume-scheduler", "--set-epoch",
                 "3", "--checkpoint-backend", "orbax", "--async-checkpoint",
                 "--advanced-logging", "--wandb", "--wandb-resume", "r1", "--loss-fn",
                 "SpectralL2Sphere", "--discount-factor", "0.9", "--save-checkpoint-interval",
                 "2", "--sfno-weights", "w.tar", "--learning-rate", "1e-3"],
    "data": ["--era5-path", "store", "--dataset-start-year", "1980",
             "--trainingset-start-year", "1981", "--trainingset-end-year", "1990",
             "--validationset-start-year", "1991", "--validationset-end-year", "1992",
             "--training-workers", "2", "--validation-batches", "3", "--past-sst",
             "--no-shuffle", "--batch-size-validation", "4", "--input-transfer-dtype",
             "bfloat16"],
    "architecture": ["--spectral-transform", "fft", "--filter-type", "linear", "--compression",
                     "tt", "--rank", "16", "--normalization-layer", "layer_norm",
                     "--hard-thresholding-fraction", "0.5", "--mlp-ratio=3.0",
                     "--checkpointing-mlp", "--checkpointing-block", "--checkpointing-encoder",
                     "--checkpointing-decoder", "--fuse-inner-mlp", "--no-fuse-decoder-tail",
                     "--no-fuse-encoder-dft", "--output-dtype", "bfloat16",
                     "--grid-mlp-mxu-dtype", "float32"],
    "film": ["--model-version", "film", "--film-gen", "transformer", "--film-layers", "2",
             "--repeat-film", "--model-depth", "3", "--film-embed-dim", "64", "--mlp-dim", "32",
             "--temporal-step", "4", "--patch-size", "4", "3", "3", "--coarse-level", "2",
             "--nan-mask-threshold", "0.25", "--dropout", "0.1", "--film-compute-dtype",
             "bfloat16", "--no-pallas-gcn", "--scale-weight", "2.0"],
    "mae": ["--model", "mae", "--model-version", "lin-probe", "--train", "--cls", "x.npy",
            "--oni-path", "o.npy", "--film-gen", "mae", "--film-embed-dim", "8"],
    "finetune": FINETUNE,
    "mesh_none": TINY + ["--mesh", "none"],
    "mesh_explicit": ["--mesh", "2,1,1", "--coordinator-address", "127.0.0.1:29500",
                      "--num-processes", "2", "--process-id", "1"],
    "mesh_equals_auto": ["--mesh=auto", "--scan-steps", "auto", "--cpu",
                         "--validation-interval", "12"],
}

# flags whose help text says what the port does where it differs from JAX
PORT_HELP = {"cpu", "sfno_weights", "checkpoint_backend", "async_checkpoint", "scan_steps",
             "profile_dir", "pallas_grid_mlp", "no_fuse_decoder_tail", "no_fuse_encoder_dft",
             "no_pallas_gcn", "mesh", "coordinator_address", "film_compute_dtype"}


@pytest.mark.parametrize("name", sorted(ARGVS))
def test_parsers_and_configs_match_jax(name):
    argv = ARGVS[name]
    a, j = cli.build_parser().parse_args(argv), jcli.build_parser().parse_args(argv)
    assert vars(a) == vars(j)
    a, j = cli.postprocess_args(a, world_size=2), jcli.postprocess_args(j, world_size=2)
    assert vars(a) == vars(j)
    from msfno_torch.config import to_json
    from msfno_tpu.utils.config import to_json as jto_json

    (mc, tc), (jmc, jtc) = cli.configs_from_args(a), jcli.configs_from_args(j)
    assert to_json(mc) == jto_json(jmc)
    assert to_json(tc) == jto_json(jtc)


def test_parser_actions_match_jax():
    mine = {a.dest: a for a in cli.build_parser()._actions}
    ref = {a.dest: a for a in jcli.build_parser()._actions}
    assert set(mine) == set(ref)
    for dest, a in mine.items():
        r = ref[dest]
        assert (a.option_strings, a.default, a.choices, a.nargs, a.type, a.const,
                a.metavar) == (r.option_strings, r.default, r.choices, r.nargs, r.type, r.const,
                               r.metavar), dest
        if dest not in PORT_HELP:
            assert a.help == r.help, dest


def test_finetune_flags_give_the_bench_configs():
    from msfno_torch.config import finetune_config, finetune_train_config, to_json

    mc, tc = cli.configs_from_args(cli.build_parser().parse_args(FINETUNE))
    assert to_json(mc) == to_json(finetune_config())
    assert to_json(tc) == to_json(finetune_train_config())


def test_time_limit_and_postprocess():
    assert cli.parse_time_limit("01:00:00") == 3600
    assert cli.parse_time_limit("90") == 90
    assert cli.parse_time_limit(None) is None
    args = cli.postprocess_args(cli.build_parser().parse_args(
        ["--multi-step-training", "2", "--training-step-skip", "1",
         "--multi-step-validation", "3", "--validation-step-skip", "2"]))
    assert (args.multi_step_training, args.multi_step_validation) == (4, 9)
    args = cli.postprocess_args(cli.build_parser().parse_args(
        ["--scheduler", "cosine", "--batch-size", "2", "--accumulation-steps", "1"]),
        world_size=2)
    assert args.scheduler_horizon == 2000 // 8


@pytest.mark.parametrize("argv", [
    ["--mlp-ratio=4.0", "--learning-rate", "1e-3"],
    ["--mlp-rat", "4.0", "--embed-d", "16"],
    ["--compute-dtype=bfloat16", "--train", "--img-size", "8", "16"],
])
def test_explicit_flags_match_jax(argv):
    assert cli.explicit_flags(argv) == jcli.explicit_flags(argv)


@pytest.mark.parametrize("kind", ["npz", "pt"])
def test_merge_resume_config_matches_jax(tmp_path, kind):
    """Explicit flags win over the stored config (the equals form and an
    abbreviation too); the protected architecture stays the checkpoint's."""
    from msfno_torch.config import from_json, to_json
    from msfno_torch.training.checkpoint import save_checkpoint
    from msfno_tpu.training.checkpoint import save_checkpoint as jsave
    from msfno_tpu.utils.config import to_json as jto_json

    stored, _ = jcli.configs_from_args(jcli.build_parser().parse_args(TINY + FILM))
    npz, pt = str(tmp_path / "cp.npz"), str(tmp_path / "cp.pt")
    jsave(npz, {"x": np.zeros(1)}, config_json=jto_json(stored))
    save_checkpoint(pt, {"x": torch.zeros(1)}, config_json=jto_json(stored))
    flags = ["--train", "--mlp-ratio=3.0", "--compute-dt", "bfloat16", "--embed-dim", "16",
             "--num-layers", "4", "--resume-checkpoint"]
    argv = TINY + flags + [npz if kind == "npz" else pt]
    a = cli.postprocess_args(cli.build_parser().parse_args(argv))
    merged, _ = cli.merge_resume_config(cli.configs_from_args(a)[0], a, argv=argv)
    jargv = TINY + flags + [npz]  # the JAX package reads its .npz only
    j = jcli.postprocess_args(jcli.build_parser().parse_args(jargv))
    jmerged, _ = jcli.merge_resume_config(jcli.configs_from_args(j)[0], j, argv=jargv)
    assert to_json(merged) == jto_json(jmerged)
    assert (merged.mlp_ratio, merged.compute_dtype) == (3.0, "bfloat16")
    assert (merged.embed_dim, merged.num_layers) == (8, 2)
    assert merged.film == from_json(jto_json(stored)).film


# ------------------------------------------------------------ actions


def _cps(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".pt"))


def _train(out, extra=()):
    rc = cli.main(TINY + ["--train", "--num-iterations", "2", "--validation-interval", "0",
                          "--output-path", str(out), *extra])
    assert rc == 0
    return out / _cps(out)[-1]


def test_no_card_without_cpu_exits(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in TINY if a != "--cpu"]
    with pytest.raises(SystemExit, match="no CUDA device is available"):
        cli.main(argv + ["--train", "--output-path", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_train_synthetic_and_resume(tmp_path):
    from msfno_torch.training.checkpoint import load_checkpoint

    cp = _train(tmp_path)
    assert cp.name == "checkpoint_iter=2_epoch=0.pt"
    assert (tmp_path / "training_log_epoch0.npy").exists()
    rc = cli.main(TINY + ["--train", "--num-iterations", "1", "--training-epochs", "2",
                          "--validation-interval", "0", "--resume-checkpoint", str(cp),
                          "--resume-optimizer", "--output-path", str(tmp_path / "r")])
    assert rc == 0
    assert _cps(tmp_path / "r") == ["checkpoint_iter=3_epoch=1.pt"]
    _, opt, meta = load_checkpoint(str(tmp_path / "r" / _cps(tmp_path / "r")[0]),
                                   with_opt_state=True)
    assert meta["step"] == 3 and opt["inner"]["count"] == 3


def test_restore_train_state_semantics(tmp_path):
    """Parameters always from the checkpoint; the schedule position alone
    under --resume-scheduler (Adam's count stays 0)."""
    from msfno_torch.models.registry import load_statistics  # noqa: F401
    from msfno_torch.training.checkpoint import load_checkpoint
    from msfno_torch.training.trainer import Trainer

    cp = _train(tmp_path)
    args = cli.build_parser().parse_args(TINY + ["--train", "--resume-checkpoint", str(cp),
                                                 "--resume-scheduler", "--scheduler",
                                                 "cosine"])
    mc, tc = cli.configs_from_args(args)
    tr = Trainer(mc, tc, device="cpu")
    state = cli.restore_train_state(tr.init_state(), tr, args, mc, tc)
    saved, _, meta = load_checkpoint(str(cp))
    for k, v in state.trainable.items():
        assert torch.equal(v.detach(), saved[k]), k
    assert state.step == meta["step"] == 2
    assert state.opt_state["inner"]["sched_count"] == 2 and state.opt_state["inner"]["count"] == 0
    assert tr.start_epoch == tr.epoch + 1


def test_run_test_performance_and_provenance(tmp_path, capsys):
    assert cli.main(TINY + ["--run", "--lead-time", "12", "--output-path", str(tmp_path)]) == 0
    data = np.load(tmp_path / "forecast.npz")["forecast"]
    assert data.shape == (2, 1, 16, 32, 3) and np.isfinite(data).all()
    assert cli.main(TINY + ["--test-performance", "--dump-provenance",
                            "--output-path", str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out)["model_fwd_s"] > 0
    prov = json.loads((tmp_path / "provenance.json").read_text())
    assert prov["devices"] == ["cpu"] and prov["default_backend"] == "cpu"


def test_save_data_and_dataloader_speed(tmp_path, capsys):
    assert cli.main(TINY + ["--save-data", "--num-iterations", "2",
                            "--output-path", str(tmp_path)]) == 0
    files = sorted(os.listdir(tmp_path / "data"))
    assert len(files) == 2 and "era5" in np.load(tmp_path / "data" / files[0])
    assert cli.main(TINY + ["--test-dataloader-speed", "--output-path", str(tmp_path)]) == 0
    assert "dataloader_s_per_batch" in json.loads(capsys.readouterr().out.splitlines()[-1])


def test_film_weights_merge(tmp_path):
    """Train film briefly, then merge its film weights onto a fresh backbone
    for --run: the forecast changes with them."""
    assert cli.main(TINY + FILM + ["--train", "--num-iterations", "1", "--learning-rate",
                                   "1e-2", "--validation-interval", "0",
                                   "--output-path", str(tmp_path)]) == 0
    cp = tmp_path / _cps(tmp_path)[-1]
    runs = {}
    for tag, extra in (("fresh", []), ("merged", ["--film-weights", str(cp)])):
        assert cli.main(TINY + FILM + ["--run", "--lead-time", "6", "--output-path",
                                       str(tmp_path / tag), *extra]) == 0
        runs[tag] = np.load(tmp_path / tag / "forecast.npz")["forecast"]
    assert np.isfinite(runs["merged"]).all() and not np.array_equal(runs["fresh"],
                                                                    runs["merged"])


def test_sfno_weights_loads_backbone(tmp_path):
    from msfno_torch.training.checkpoint import load_checkpoint

    cp = _train(tmp_path)
    rc = cli.main(TINY + FILM + ["--train", "--num-iterations", "1",
                                 "--validation-interval", "0", "--sfno-weights", str(cp),
                                 "--output-path", str(tmp_path / "film")])
    assert rc == 0
    backbone, _, _ = load_checkpoint(str(cp))
    tuned, _, _ = load_checkpoint(str(tmp_path / "film" / _cps(tmp_path / "film")[-1]))
    assert all(torch.equal(tuned[k], v) for k, v in backbone.items())  # frozen
    assert any(k.startswith("film_gen.") for k in tuned)


def test_save_forecast_and_eval_model(tmp_path):
    _train(tmp_path)
    assert cli.main(TINY + ["--save-forecast", "--num-iterations", "1",
                            "--multi-step-validation", "1", "--output-path", str(tmp_path)]) == 0
    assert (tmp_path / "forecast_store" / "header.json").exists()
    assert cli.main(TINY + ["--eval-model", "--multi-step-validation", "1", "--eval-sfno",
                            "--output-path", str(tmp_path)]) == 0
    names = os.listdir(tmp_path / "eval")
    assert any(f.endswith("_skill.npy") for f in names) and "skill.pdf" in names
    assert cli.main(TINY + ["--eval-model", "--output-path", str(tmp_path / "none")]) == 1


def _reference_tar(tmp_path, film=False):
    """A reference-layout torch checkpoint of a fresh tiny net."""
    from msfno_torch.models.registry import get_model

    mc, _ = cli.configs_from_args(cli.build_parser().parse_args(TINY + (FILM if film else [])))
    w = get_model("sfno", "film" if film else "latest", cfg=mc, device="cpu", seed=3)
    tar = tmp_path / "weights.tar"
    torch.save({"model_state": {f"module.{k}": v for k, v in w.module.state_dict().items()}},
               str(tar))
    return tar, w


def test_reference_tar_run_eval_and_filmed_resume(tmp_path):
    tar, w = _reference_tar(tmp_path)
    assert cli.main(TINY + ["--run", "--lead-time", "12", "--resume-checkpoint", str(tar),
                            "--output-path", str(tmp_path / "run")]) == 0
    got = np.load(tmp_path / "run" / "forecast.npz")["forecast"]
    x0 = np.random.default_rng(42).standard_normal((1, 16, 32, 3)).astype(np.float32)
    want = np.stack(list(w.running(x0, lead_time_h=12)))
    np.testing.assert_array_equal(got, want)
    assert cli.main(TINY + ["--eval-model", "--checkpoint-list", str(tar),
                            "--multi-step-validation", "1",
                            "--output-path", str(tmp_path / "ev")]) == 0
    assert any(f.endswith("_mse_model.npy") for f in os.listdir(tmp_path / "ev" / "eval"))
    # a backbone-only tar resumed into a filmed net keeps its generator
    assert cli.main(TINY + FILM + ["--train", "--num-iterations", "1",
                                   "--validation-interval", "0", "--resume-checkpoint",
                                   str(tar), "--output-path", str(tmp_path / "film")]) == 0
    assert _cps(tmp_path / "film")


def test_mae_pretrain_sst_only_store_and_lin_probe(tmp_path, capsys):
    store = tmp_path / "sstonly"
    os.makedirs(store)
    rng = np.random.default_rng(2)
    for i in range(10):
        sst = rng.standard_normal((16, 32)).astype(np.float32)
        sst[0, :4] = np.nan
        np.save(store / f"sst_{i:06d}.npy", sst)
    mae = ["--model", "mae", "--train", "--img-size", "17", "32", "--scale-factor", "2",
           "--in-chans", "3", "--out-chans", "3", "--embed-dim", "8", "--num-layers", "1",
           "--spectral-layers", "1", "--model-depth", "1", "--film-embed-dim", "32",
           "--mlp-dim", "32", "--temporal-step", "4", "--coarse-level", "1", "--patch-size",
           "4", "4", "4", "--cpu"]
    assert cli.main(mae + ["--sst-path", str(store), "--batch-size", "2",
                           "--output-path", str(tmp_path / "out")]) == 0
    assert (tmp_path / "out" / "checkpoint_mae_final.pt").exists()
    assert cli.main(mae + ["--synthetic-data", "--num-iterations", "2",
                           "--output-path", str(tmp_path / "syn")]) == 0
    cls_tokens = rng.standard_normal((50, 8)).astype(np.float32)
    oni = (cls_tokens @ rng.standard_normal(8)).astype(np.float32)
    np.save(tmp_path / "cls.npy", cls_tokens)
    np.save(tmp_path / "oni.npy", oni)
    capsys.readouterr()
    assert cli.main(["--model", "mae", "--model-version", "lin-probe", "--train", "--cpu",
                     "--film-embed-dim", "8", "--cls", str(tmp_path / "cls.npy"),
                     "--oni-path", str(tmp_path / "oni.npy"),
                     "--output-path", str(tmp_path / "probe")]) == 0
    res = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert res["lin_probe_mae"] < 1e-2 < res["climatology_mae"]
    assert (tmp_path / "probe" / "checkpoint_linprobe.pt").exists()


def test_run_netcdf_and_hindcast_file_outputs(tmp_path):
    from scipy.io import netcdf_file

    assert cli.main(TINY + ["--run", "--lead-time", "12", "--output", "netcdf",
                            "--output-path", str(tmp_path)]) == 0
    files = sorted((tmp_path / "forecast").glob("*.nc"))
    assert len(files) == 2
    with netcdf_file(str(files[0]), "r") as nc:
        assert "latitude" in nc.variables and int(nc.variables["step"][0]) == 6
    assert cli.main(TINY + ["--run", "--lead-time", "6", "--output", "file", "--hindcast",
                            "--hindcast-reference-year", "2015",
                            "--output-path", str(tmp_path / "h")]) == 0
    m = json.load(open(tmp_path / "h" / "forecast" / "manifest.json"))
    assert str(m["metadata"]["reference_date"]).startswith("2015")


@pytest.fixture
def cli_store(tmp_path):
    """A 16-step npy store of the TINY grid, SST at the coarse-level-2 film
    shape (7, 16)."""
    root = str(tmp_path / "store")
    os.makedirs(root)
    rng = np.random.default_rng(1)
    for i in range(16):
        np.save(f"{root}/era5_{i:06d}.npy", rng.standard_normal((16, 32, 3)).astype(np.float32))
        sst = rng.standard_normal((7, 16)).astype(np.float32)
        sst[0, :3] = np.nan
        np.save(f"{root}/sst_{i:06d}.npy", sst)
    return root


def test_store_train_run_with_date_and_sst_windows(tmp_path, cli_store, monkeypatch):
    from msfno_torch.data import era5 as era5_mod

    assert cli.main(TINY_REAL + ["--train", "--era5-path", cli_store, "--no-shuffle",
                                 "--batch-size-validation", "2", "--validation-interval", "0",
                                 "--validation-batches", "1", "--training-workers", "1",
                                 "--output-path", str(tmp_path / "tr")]) == 0
    assert _cps(tmp_path / "tr") == ["checkpoint_iter=14_epoch=0.pt"]
    assert cli.main(TINY_REAL + ["--run", "--lead-time", "12", "--era5-path", cli_store,
                                 "--date", "19790102", "--time", "6",
                                 "--output-path", str(tmp_path / "run")]) == 0
    data = np.load(tmp_path / "run" / "forecast.npz")["forecast"]
    assert data.shape == (2, 1, 16, 32, 3) and np.isfinite(data).all()
    calls = []
    orig = era5_mod.NpyBackend.sst
    monkeypatch.setattr(era5_mod.NpyBackend, "sst", lambda self, i: calls.append(i) or orig(self, i))
    assert cli.main(TINY_REAL + FILM + ["--run", "--lead-time", "12", "--era5-path", cli_store,
                                        "--date", "19790101", "--time", "18",
                                        "--output-path", str(tmp_path / "film")]) == 0
    assert calls == [3, 4, 5, 5, 6]  # the guard read, then windows [4, 5], [5, 6]


def test_error_cases(tmp_path, cli_store):
    with pytest.raises(SystemExit, match="hour 0-23"):
        cli.main(TINY + ["--run", "--time", "1200", "--output-path", str(tmp_path)])
    for mesh, match in (("2x2", "three comma-separated"), ("16,16,16", "Queue 1 item 7"),
                        ("2,1,1", "world size is 1")):
        with pytest.raises(SystemExit, match=match):
            cli.main(TINY + ["--train", "--mesh", mesh, "--output-path", str(tmp_path)])
    with pytest.raises(SystemExit, match="Queue 1 item 2"):
        cli.main(TINY + ["--train", "--checkpoint-backend", "orbax",
                         "--output-path", str(tmp_path)])
    with pytest.raises(SystemExit, match="fix the year flags"):
        cli.main(TINY_REAL + ["--train", "--era5-path", cli_store, "--trainingset-start-year",
                              "2000", "--output-path", str(tmp_path)])
    assert cli.main(TINY_REAL + ["--run", "--era5-path", cli_store, "--date", "20250101",
                                 "--output-path", str(tmp_path)]) == 1
    with pytest.raises(SystemExit, match="needs SST frames"):
        cli.main(TINY_REAL + FILM + ["--run", "--lead-time", "48", "--era5-path", cli_store,
                                     "--date", "19790104", "--output-path", str(tmp_path)])


def test_profile_dir_writes_a_trace(tmp_path):
    """In a fresh process: torch.profiler imports torch._dynamo, which trips
    over the stub `xarray` module other tests leave in sys.modules."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    prof = tmp_path / "trace"
    out = subprocess.run(
        [sys.executable, "-m", "msfno_torch.cli", *TINY, "--train", "--num-iterations", "1",
         "--validation-interval", "0", "--profile-dir", str(prof), "--output-path",
         str(tmp_path)], cwd=repo, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert list(prof.glob("*.pt.trace.json")) and _cps(tmp_path)


def test_cli_and_parallel_import_no_jax():
    """The command line, parallel/* and observability import nothing of JAX
    or of the JAX package; `python -m msfno_torch.cli --help` runs."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "import msfno_torch.cli, msfno_torch.parallel, msfno_torch.parallel.sharded_train\n"
            "import msfno_torch.utils.observability\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'msfno_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    out = subprocess.run([sys.executable, "-m", "msfno_torch.cli", "--help"], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--mesh" in out.stdout, out.stderr
