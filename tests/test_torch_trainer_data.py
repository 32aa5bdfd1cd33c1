"""The port's Trainer fed from a store, against the JAX package's: both start
from the JAX trainer's `init_state` at `small_cfg(film=True)` and train
through their own PrefetchLoader over the same npy store (3 steps and a
validation fed by an islice of a second loader, as the JAX CLI wires it).
Then the Trainer's data and performance tools: `save_data` (the same .npz
files as JAX), `chunk_input_bytes_per_step` / `auto_scan_steps` (JAX's at
given budgets), `test_batch_size` (only an out-of-memory failure ends the
sweep), `test_model_speed` / `test_dataloader_speed`, a bf16-transfer
loader, and `ModelWrapper.trainer()`."""

import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from msfno_torch.config import TrainConfig as TTrainConfig
from msfno_torch.config import from_json
from msfno_torch.data import era5 as te
from msfno_torch.data.normalization import SSTNormalizer as TSSTNormalizer
from msfno_torch.models import registry as tregistry
from msfno_torch.training import trainer as ttrainer
from msfno_tpu.data import era5 as je
from msfno_tpu.data.synthetic import synthetic_land_mask
from msfno_tpu.training import trainer as jtrainer
from msfno_tpu.utils.config import SFNOConfig, TrainConfig, to_json
from tests.test_torch_trainer import CFG, pair, report, tree_rel

torch.set_num_threads(2)

T = CFG.film.temporal_step
N_TRAIN = 3  # samples, so 3 steps an epoch at batch 1


def write_store(root, n, seed=0):
    """A store at the small config's shapes: (16, 32, 3) states and (8, 16)
    SST frames with NaN over land."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    h, w = CFG.img_size
    hs, ws = CFG.film.sst_shape
    land = synthetic_land_mask(hs, ws)
    for i in range(n):
        np.save(f"{root}/era5_{i:06d}.npy",
                rng.standard_normal((h, w, CFG.in_chans)).astype(np.float32))
        sst = rng.standard_normal((hs, ws)).astype(np.float32)
        sst[land] = np.nan
        np.save(f"{root}/sst_{i:06d}.npy", sst)
    return str(root)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    # a sample needs 1 + T frames past its start (ms = 0, past_sst=False)
    return write_store(tmp_path_factory.mktemp("store"), N_TRAIN + 1 + T)


def loaders(pkg, root, **kw):
    """(train loader, validation factory) of one package over the store."""
    ds = pkg.ERA5Dataset(pkg.NpyBackend(root), multi_step=0, temporal_step=T)
    train = pkg.PrefetchLoader(ds, batch_size=1, shuffle=True, seed=11, num_shards=1, **kw)
    val = pkg.PrefetchLoader(ds, batch_size=1, num_shards=1, **kw)
    return train, lambda: itertools.islice(val.epoch(0), 2)


def test_train_through_loader_matches_jax(store):
    tcfg = TrainConfig(film_scale_start=0.5, validation_interval=0, training_epochs=1)
    jt, js, pt, ps = pair(CFG, tcfg)
    jl, jv = loaders(je, store)
    tl, tv = loaders(te, store)
    js = jt.train(js, loader=jl, val_loader=jv)
    ps = pt.train(ps, loader=tl, val_loader=tv)
    assert int(js.step) == ps.step == N_TRAIN
    recs = lambda w, key: [r[key] for r in w.records if key in r]  # noqa: E731
    j_loss, p_loss = recs(jt.writer, "loss"), recs(pt.writer, "loss")
    assert len(p_loss) == len(j_loss) == N_TRAIN
    for key in ("validation loss step=0", "gamma mean", "beta mean"):
        j_loss, p_loss = j_loss + recs(jt.writer, key), p_loss + recs(pt.writer, key)
    assert len(p_loss) == len(j_loss) == N_TRAIN + 3
    err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(p_loss, j_loss))
    assert report("trainer through the loader, losses", err) <= 1e-5
    assert report("trainer through the loader, trainable",
                  tree_rel(ps.trainable, js.trainable)) <= 1e-5
    assert ps.film_scale == pytest.approx(float(js.film_scale))


def test_bf16_transfer_loader_trains(store):
    """A bf16-transfer loader hands tensors over; `_device_batch` takes them
    as they are and the loss is that of the same batch cast by hand."""
    pt = ttrainer.Trainer(from_json(to_json(CFG)), TTrainConfig(film_scale_start=1.0),
                          device="cpu")
    ps = pt.init_state()
    tl, tv = loaders(te, store, transfer_dtype=torch.bfloat16)
    batch = next(iter(tl.epoch(0)))
    era5, sst = pt._device_batch(batch)
    assert era5.dtype == sst.dtype == torch.bfloat16
    ref = next(iter(loaders(te, store)[0].epoch(0)))
    with torch.no_grad():
        l16, _ = pt._rollout_loss(era5, sst, 1.0)
        l32, _ = pt._rollout_loss(torch.from_numpy(ref.era5).bfloat16(),
                                  torch.from_numpy(ref.sst).bfloat16(), 1.0)
    assert float(l16) == float(l32)
    ps = pt.train(ps, loader=tl, val_loader=tv)
    assert ps.step == N_TRAIN and all(np.isfinite(r["loss"]) for r in pt.writer.records
                                      if "loss" in r)


def test_save_data_matches_jax(store, tmp_path):
    jt = jtrainer.Trainer(CFG, TrainConfig())
    pt = ttrainer.Trainer(from_json(to_json(CFG)), TTrainConfig(), device="cpu")
    jl, _ = loaders(je, store)
    tl, _ = loaders(te, store)
    jt.save_data(jl.epoch(0), str(tmp_path / "jax"), num_batches=2)
    pt.save_data(tl.epoch(0), str(tmp_path / "port"), num_batches=2)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == ["batch_0000.npz", "batch_0001.npz"]
    for name in names:
        with np.load(tmp_path / "jax" / name) as a, np.load(tmp_path / "port" / name) as b:
            assert sorted(a.files) == sorted(b.files) == ["era5", "sst", "times"]
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("vi", [0, 7, 12, 100])
@pytest.mark.parametrize("ms", [0, 1])
@pytest.mark.parametrize("budget_steps", [0.5, 3, 40])
def test_scan_steps_match_jax(vi, ms, budget_steps):
    for cfg in (CFG, SFNOConfig(img_size=(16, 32), in_chans=3, out_chans=3, embed_dim=8)):
        jtcfg = TrainConfig(validation_interval=vi, multi_step_training=ms, batch_size=2)
        ttcfg, tcfg_model = from_json(to_json(jtcfg)), from_json(to_json(cfg))
        per = jtrainer.chunk_input_bytes_per_step(cfg, jtcfg)
        assert ttrainer.chunk_input_bytes_per_step(tcfg_model, ttcfg) == per
        budget = int(budget_steps * per)
        for max_k in (4, 16):
            assert (ttrainer.auto_scan_steps(tcfg_model, ttcfg, budget, max_k)
                    == jtrainer.auto_scan_steps(cfg, jtcfg, budget, max_k))


def test_auto_scan_steps_needs_a_budget_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="hbm_budget_bytes"):
        ttrainer.auto_scan_steps(from_json(to_json(CFG)), TTrainConfig())


def test_batch_size_sweep_stops_only_at_out_of_memory(monkeypatch):
    pt = ttrainer.Trainer(from_json(to_json(CFG)), TTrainConfig(), device="cpu")
    probed = []

    def oom_above(limit, exc):
        def probe(b):
            probed.append(b)
            if b > limit:
                raise exc
        return probe

    monkeypatch.setattr(pt, "_probe_batch_size",
                        oom_above(4, torch.cuda.OutOfMemoryError("CUDA out of memory")))
    assert pt.test_batch_size() == 4 and probed == [1, 2, 4, 8]
    probed.clear()
    monkeypatch.setattr(pt, "_probe_batch_size",
                        oom_above(1, RuntimeError("CUDA error: out of memory")))
    assert pt.test_batch_size() == 1 and probed == [1, 2]
    monkeypatch.setattr(pt, "_probe_batch_size", oom_above(2, RuntimeError("shape mismatch")))
    with pytest.raises(RuntimeError, match="shape mismatch"):
        pt.test_batch_size()
    monkeypatch.setattr(pt, "_probe_batch_size", oom_above(0, ValueError("bad config")))
    with pytest.raises(ValueError, match="bad config"):
        pt.test_batch_size()


def test_batch_size_probe_runs_a_step():
    """The real probe on the CPU: a train step at each candidate."""
    pt = ttrainer.Trainer(from_json(to_json(CFG)), TTrainConfig(), device="cpu")
    assert pt.test_batch_size(candidates=(1, 2)) == 2


def test_speed_tools(store):
    pt = ttrainer.Trainer(from_json(to_json(CFG)), TTrainConfig(), device="cpu")
    ps = pt.init_state()
    assert pt.test_model_speed(ps, iters=2) > 0
    tl, _ = loaders(te, store)
    assert pt.test_dataloader_speed(tl.epoch(0), iters=2) > 0


def test_wrapper_trainer_carries_normalizers(tmp_path):
    """`ModelWrapper.trainer()` builds the port's Trainer with the wrapper's
    config, normalizers and device, as the JAX wrapper's does."""
    cfg = from_json(to_json(CFG))
    means = np.arange(3, dtype=np.float32)
    stds = np.arange(1, 4, dtype=np.float32)
    np.save(tmp_path / "global_means.npy", means.reshape(1, 3, 1, 1))
    np.save(tmp_path / "global_stds.npy", stds.reshape(1, 3, 1, 1))
    wrap = tregistry.get_model("sfno", "film", cfg=cfg, assets=str(tmp_path), device="cpu")
    wrap.sst_normalizer = TSSTNormalizer(1.5, 2.0)
    tr = wrap.trainer(TTrainConfig(learning_rate=1e-3))
    assert isinstance(tr, ttrainer.Trainer) and tr.cfg == cfg and tr.device.type == "cpu"
    assert tr.normalizer is wrap.normalizer and tr.sst_normalizer is wrap.sst_normalizer
    np.testing.assert_array_equal(tr.normalizer.means, means)
    assert tr.tcfg.learning_rate == 1e-3 and tr.filmed
    plain = tregistry.get_model("sfno", cfg=dataclasses.replace(cfg, film=None), device="cpu")
    assert not plain.trainer(TTrainConfig()).filmed
