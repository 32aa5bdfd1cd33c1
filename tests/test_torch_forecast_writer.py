"""The forecast archive of the PyTorch port (msfno_torch/inference/
forecast_writer.py) and the trainer's `save_forecast` against the JAX
package's: the same arrays give byte-identical archives (header.json and
every time_*.npy), re-opening resumes, a channel mismatch raises, either
package reads the other's archive; `save_forecast` from the same weights
writes the JAX header byte for byte and chunks within 1e-5."""

import os

import jax
import numpy as np
import pytest
import torch

from msfno_torch.config import from_json
from msfno_torch.convert import from_flax_train_state
from msfno_torch.inference.forecast_writer import ForecastWriter as TWriter
from msfno_torch.training.trainer import Trainer as TTrainer
from msfno_torch.training.trainer import save_forecast as tsave_forecast
from msfno_tpu.data.synthetic import gen_batch
from msfno_tpu.inference.forecast_writer import ForecastWriter as JWriter
from msfno_tpu.training.trainer import Trainer as JTrainer
from msfno_tpu.training.trainer import save_forecast as jsave_forecast
from msfno_tpu.utils.config import TrainConfig, to_json
from tests.test_training import small_cfg

torch.set_num_threads(2)

CHANNELS = ["10u", "10v", "2t"]


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


def _chunks(seed, n=2, steps=3, h=4, w=8):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((steps, h, w, len(CHANNELS))).astype(np.float32)
            for _ in range(n)]


def _write(cls, path, chunks, times, lat=None, lon=None):
    h, w = chunks[0].shape[1:3]
    lat = np.linspace(90, -90, h) if lat is None else lat
    lon = np.linspace(0, 360, w, endpoint=False) if lon is None else lon
    writer = cls(path, CHANNELS, lat=lat, lon=lon)
    for t, c in zip(times, chunks):
        writer.append(t, c)
    return writer


def test_archive_bytes_match_jax(tmp_path):
    chunks, times = _chunks(0), [2020010100, 2020010106]
    _write(JWriter, str(tmp_path / "jax"), chunks, times)
    _write(TWriter, str(tmp_path / "port"), chunks, times)
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(a) == sorted(b) == ["header.json", "time_00000.npy", "time_00001.npy"]
    assert a == b
    meta_t, data_t = TWriter.read(str(tmp_path / "port"))
    meta_j, data_j = JWriter.read(str(tmp_path / "port"))
    assert meta_t == meta_j and data_t.shape == (3, 2, 4, 8, 3)
    np.testing.assert_array_equal(data_t, data_j)
    np.testing.assert_array_equal(data_t[:, 1], chunks[1])


def test_resume_and_channel_check_match_jax(tmp_path):
    chunks = _chunks(1, n=3)
    for cls, name in ((JWriter, "jax"), (TWriter, "port")):
        path = str(tmp_path / name)
        _write(cls, path, chunks[:2], [1, 2])
        # a restarted job re-opens the archive and appends after it
        _write(cls, path, chunks[2:], [3])
        with pytest.raises(ValueError, match="channels"):
            cls(path, ["u", "v", "t"], lat=np.zeros(4), lon=np.zeros(8))
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")
    meta, data = TWriter.read(str(tmp_path / "jax"))
    assert meta["times"] == [1, 2, 3] and data.shape[1] == 3
    assert not any(f.endswith(".tmp") for f in os.listdir(tmp_path / "port"))


def test_save_forecast_matches_jax(tmp_path):
    """Both trainers from the JAX trainer's init_state; two init times with
    valid times; the header byte for byte, the chunks within 1e-5."""
    cfg = small_cfg(film=True)
    tcfg = TrainConfig(film_scale_start=0.7)
    jt = JTrainer(cfg, tcfg)
    js = jt.init_state()
    pt = TTrainer(from_json(to_json(cfg)), from_json(to_json(tcfg)), device="cpu")
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    pt.model.load_state_dict(from_flax_train_state(np_tree(js.trainable), np_tree(js.frozen)))
    ps = pt.init_state()
    steps = 2
    batches = [gen_batch(cfg, b, steps, seed=20 + i) for i, b in enumerate((1, 2))]
    for i, batch in enumerate(batches):
        batch.times = batch.times + 2021030100 + 6 * i
    jsave_forecast(jt, js, batches, steps, str(tmp_path / "jax"), channels=CHANNELS)
    out = tsave_forecast(pt, ps, batches, steps, str(tmp_path / "port"), channels=CHANNELS)
    a, b = _files(tmp_path / "jax"), _files(out)
    assert sorted(a) == sorted(b) and len(a) == 4  # header + 3 init times
    assert a["header.json"] == b["header.json"]
    (_, dj), (meta, dt) = JWriter.read(str(tmp_path / "jax")), TWriter.read(out)
    assert meta["times"] == [2021030100, 2021030106, 2021030106]
    assert dt.dtype == np.float32 and dt.shape == dj.shape == (steps, 3, *cfg.img_size, 3)
    err = float(np.linalg.norm(dt - dj) / np.linalg.norm(dj))
    print(f"parity save_forecast chunks rel_l2={err:.3e}")
    assert err <= 1e-5
