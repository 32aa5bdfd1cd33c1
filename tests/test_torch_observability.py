"""The port's observability module (msfno_torch/utils/observability.py)
against tests/test_observability.py and the JAX package's functions: Timer,
Stepper, LocalLog, provenance, the host and device statistics without
psutil, rank-0-only writers, and the Trainer's advanced logging keys."""

import json
import logging
import sys

import numpy as np
import pytest
import torch

from msfno_torch.config import FilmConfig, SFNOConfig, TrainConfig, from_json, to_json
from msfno_torch.utils import observability as obs

TINY_CFG = SFNOConfig(img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3, embed_dim=8,
                      num_layers=2, spectral_layers=1)


def test_timer_measures_and_divides():
    import time

    with obs.Timer() as t:
        time.sleep(0.01)
    assert t.seconds >= 0.005
    with obs.Timer(divisor=10) as t:
        time.sleep(0.02)
    assert t.seconds < 0.02


def test_stepper_logs(caplog):
    with caplog.at_level(logging.INFO, logger="msfno_torch"):
        s = obs.Stepper(total_steps=3)
        for i in range(3):
            s(i, step_hours=6)
    assert any("3/3 (+18h)" in r.getMessage() for r in caplog.records)


def test_local_log_save(tmp_path):
    w = obs.LocalLog(save_dir=str(tmp_path))
    w.log({"loss": 1.0}, step=1)
    w.log({"loss": 0.5}, step=2)
    records = np.load(w.save("_t"), allow_pickle=True)
    assert len(records) == 2 and records[1]["loss"] == 0.5 and records[1]["_step"] == 2


def test_create_writer_without_wandb(tmp_path, monkeypatch, caplog):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    with caplog.at_level(logging.WARNING, logger="msfno_torch"):
        w = obs.create_writer(save_dir=str(tmp_path), use_wandb=True)
    w.log({"x": 1})
    assert w.mirror is None and w.save_dir == str(tmp_path)
    assert any("wandb unavailable" in r.getMessage() for r in caplog.records)


def test_create_writer_saves_on_rank_zero_only(tmp_path, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    w = obs.create_writer(save_dir=str(tmp_path), use_wandb=True)
    w.log({"loss": 1.0}, step=1)
    assert w.save_dir is None and w.mirror is None and w.save("_r1") is None
    assert len(w.records) == 1 and not list(tmp_path.iterdir())
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    assert obs.create_writer(save_dir=str(tmp_path)).save_dir == str(tmp_path)


def test_provenance_dump_on_cpu(tmp_path, monkeypatch):
    import scipy

    def no_smi():
        raise FileNotFoundError("nvidia-smi")

    monkeypatch.setattr(obs, "nvidia_smi", no_smi)
    info = json.loads(open(obs.dump_provenance(str(tmp_path / "prov.json"), "cpu")).read())
    assert info["devices"] == ["cpu"] and info["default_backend"] == "cpu"
    assert info["torch"] == torch.__version__ and info["numpy"] == np.__version__
    assert info["scipy"] == scipy.__version__ and "cuda" in info
    assert info["nvidia_smi"] is None and "jax" not in info
    for key in ("platform", "python", "time"):
        assert info[key]


def test_provenance_without_card_needs_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        obs.gather_provenance_info()


def test_system_monitor_without_psutil(monkeypatch):
    """The keys of the JAX package's psutil version, read from /proc with
    psutil made unimportable; the sizes agree with psutil's."""
    psutil = pytest.importorskip("psutil")
    from msfno_tpu.utils.observability import system_monitor as jax_system_monitor

    want = jax_system_monitor(printout=False)
    total_gb = psutil.virtual_memory().total / 2**30
    monkeypatch.setitem(sys.modules, "psutil", None)
    got = obs.system_monitor(printout=False)
    assert set(got) == set(want)
    assert got["ram_total_gb"] == want["ram_total_gb"]
    assert got["process_rss_gb"] == pytest.approx(want["process_rss_gb"], abs=0.05)
    assert 0 <= got["ram_percent"] <= 100 and 0 <= got["cpu_percent"] <= 100
    assert got["process_cpu_percent"] >= 0
    assert got["ram_used_gb"] == pytest.approx(total_gb * got["ram_percent"] / 100, abs=0.05)


def test_device_memory_stats_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert obs.device_memory_stats() == []


def test_fin_training_is_exception():
    with pytest.raises(obs.FinTraining, match="done"):
        raise obs.FinTraining("done")


def test_config_json_roundtrip_nested():
    cfg = SFNOConfig(img_size=(64, 128),
                     film=FilmConfig(film_gen_type="transformer", sst_shape=(16, 32)))
    assert from_json(to_json(cfg)) == cfg
    tcfg = TrainConfig(learning_rate=1e-3, time_limit_s=120.0)
    assert from_json(to_json(tcfg)) == tcfg


def test_advanced_logging_keys_match_jax():
    """--advanced-logging: the port's validation logs the JAX trainer's
    telemetry keys (host ram percent, process rss gb; device{i} hbm gb where
    a device reports its bytes in use: none on the CPU, in either package)."""
    from msfno_torch.training.trainer import Trainer
    from msfno_tpu.training.trainer import Trainer as JTrainer
    from msfno_tpu.utils import config as jconfig

    tcfg = TrainConfig(advanced_logging=True, multi_step_validation=0)
    pt = Trainer(TINY_CFG, tcfg, device="cpu")
    pt.validation(pt.init_state())
    jt = JTrainer(jconfig.from_json(to_json(TINY_CFG)), jconfig.from_json(to_json(tcfg)))
    jt.validation(jt.init_state())
    port, ref = pt.writer.records[-1], jt.writer.records[-1]
    assert set(port) == set(ref)
    assert {"host ram percent", "process rss gb"} <= set(port)
    assert not any(k.startswith("device") for k in port)


def test_advanced_logging_device_keys(monkeypatch):
    """On a card, one "device{i} hbm gb" per card from device_memory_stats."""
    from msfno_torch.training import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "device_memory_stats", lambda: [
        {"device": "cuda:0", "bytes_in_use": 3 * 2**30, "peak_bytes_in_use": 4 * 2**30,
         "bytes_limit": 80 * 2**30}])
    pt = trainer_mod.Trainer(TINY_CFG, TrainConfig(advanced_logging=True), device="cpu")
    pt.validation(pt.init_state())
    assert pt.writer.records[-1]["device0 hbm gb"] == 3.0


def test_running_logs_steps(caplog):
    """ModelWrapper.running reports each step through Stepper, as the JAX
    wrapper does (msfno_tpu/models/registry.py:133)."""
    from msfno_torch.models.registry import get_model

    w = get_model("sfno", cfg=TINY_CFG, device="cpu")
    x0 = np.random.default_rng(0).standard_normal((1, 16, 32, 3)).astype(np.float32)
    with caplog.at_level(logging.INFO, logger="msfno_torch"):
        outs = list(w.running(x0, lead_time_h=12))
    assert len(outs) == 2
    msgs = [r.getMessage() for r in caplog.records]
    assert any("step 1/2 (+6h)" in m for m in msgs) and any("step 2/2 (+12h)" in m for m in msgs)
