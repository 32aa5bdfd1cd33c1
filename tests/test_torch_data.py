"""The port's data layer (msfno_torch/data) against the JAX package's
(msfno_tpu/data), bit for bit, on small stores written from a numpy seed:
the time-index functions, channel assembly, ERA5Dataset items and bulk
batches, PrefetchLoader epochs (order, shards, partial batches, the bf16
transfer's bit patterns), the native reader, the SST store and ONI, the
climatology, the synthetic generators and the zarr backend through the
stubbed xarray of tests/test_zarr_backend.py.  Then the port's loader on its
own: worker errors, abandoned epochs, and imports free of JAX."""

import itertools
import os
import subprocess
import sys
import threading
import time

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from msfno_torch.config import from_json
from msfno_torch.data import climatology as tclim
from msfno_torch.data import era5 as te
from msfno_torch.data import native_loader as tn
from msfno_torch.data import sst as tsst
from msfno_torch.data import synthetic as tsyn
from msfno_tpu.data import climatology as jclim
from msfno_tpu.data import era5 as je
from msfno_tpu.data import native_loader as jn
from msfno_tpu.data import sst as jsst
from msfno_tpu.data import synthetic as jsyn
from msfno_tpu.utils.config import to_json
from tests.test_training import small_cfg
from tests.test_zarr_backend import NT, RH_LAG_STEPS, stores  # noqa: F401 (fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 40


def write_store(root, n=N_FRAMES, with_sst=True, dtype=np.float32, seed=0):
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n):
        np.save(f"{root}/era5_{i:06d}.npy", rng.standard_normal((4, 8, 3)).astype(dtype))
        if with_sst:
            sst = rng.standard_normal((4, 8)).astype(dtype)
            sst[0, :2] = np.nan
            np.save(f"{root}/sst_{i:06d}.npy", sst)
    return str(root)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    return write_store(tmp_path_factory.mktemp("store"))


@pytest.fixture(scope="module")
def store_no_sst(tmp_path_factory):
    return write_store(tmp_path_factory.mktemp("store_no_sst"), with_sst=False)


def assert_batches_equal(a, b):
    np.testing.assert_array_equal(a.era5, b.era5)
    np.testing.assert_array_equal(a.times, b.times)
    assert (a.sst is None) == (b.sst is None)
    if a.sst is not None:
        np.testing.assert_array_equal(a.sst, b.sst)  # NaNs in the same places


# ------------------------------------------------------------ pure functions


@pytest.mark.parametrize("start,first,last", [(1979, 1980, 1981), (1980, 1980, 1985),
                                              (1999, 2000, 2001), (2023, 2024, 2026)])
def test_time_functions_match_jax(start, first, last):
    assert te.year_range_indices(start, first, last) == je.year_range_indices(start, first, last)
    s, e = te.year_range_indices(start, first, last)
    for idx in (0, 1, 235, 236, 239, s, s + 3, e, e + 1, 4 * 366 + 7):
        t = te.index_to_yyyymmddhh(start, idx)
        assert t == je.index_to_yyyymmddhh(start, idx)
        assert te.yyyymmddhh_to_index(start, t) == je.yyyymmddhh_to_index(start, t) == idx
        assert te.yyyymmddhh_to_index(start, t + 5) == je.yyyymmddhh_to_index(start, t + 5)
    for past in (False, True):
        assert (te.rollout_sst_window_start(10, 2, 4, past)
                == je.rollout_sst_window_start(10, 2, 4, past))
    assert te.zarr_level_order() == je.zarr_level_order()


def test_leap_day_times():
    # 1980 is leap: Feb 29 exists, 2100 is not
    assert te.index_to_yyyymmddhh(1980, 4 * 59) == 1980022900
    assert te.index_to_yyyymmddhh(2100, 4 * 59) == 2100030100


def test_assemble_channels_matches_jax():
    rng = np.random.default_rng(3)
    scf, u, v = rng.standard_normal((6, 4, 8)), rng.standard_normal((4, 8)), rng.standard_normal((4, 8))
    pl5, pl4, r = (rng.standard_normal((5, 13, 4, 8)), rng.standard_normal((4, 13, 4, 8)),
                   rng.standard_normal((13, 4, 8)))
    for args in ((scf, u, v, pl5), (scf, u, v, pl4, r)):
        a, b = te.assemble_channels(*args), je.assemble_channels(*args)
        assert a.dtype == b.dtype == np.float32 and a.shape == (4, 8, 73)
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="73"):
        te.assemble_channels(scf, u, v, pl4)


# ----------------------------------------------------------- dataset, loader


@pytest.mark.parametrize("past_sst", [False, True])
@pytest.mark.parametrize("ms", [0, 1])
@pytest.mark.parametrize("sst_kind", ["sst", "with_sst=False", "no sst files"])
@pytest.mark.parametrize("start_year", [None, 1980])
def test_dataset_matches_jax(store, store_no_sst, past_sst, ms, sst_kind, start_year):
    root = store_no_sst if sst_kind == "no sst files" else store
    kw = dict(multi_step=ms, temporal_step=3, past_sst=past_sst, with_sst=sst_kind == "sst",
              dataset_start_year=start_year, start_idx=1, end_idx=N_FRAMES - 2)
    dt, dj = te.ERA5Dataset(te.NpyBackend(root), **kw), je.ERA5Dataset(je.NpyBackend(root), **kw)
    assert len(dt) == len(dj) and dt.end_idx == dj.end_idx
    for i in range(len(dt)):
        for a, b in zip(dt[i], dj[i]):
            if b is None:
                assert a is None
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    for idcs in ([0], [3, 1, 2], [len(dt) - 1, 0]):
        bt, bj = dt.get_batch(idcs), dj.get_batch(idcs)
        assert_batches_equal(bt, bj)
        assert bt.era5.dtype == bj.era5.dtype and bt.times.dtype == bj.times.dtype


def test_dataset_too_short_raises(store):
    with pytest.raises(ValueError, match="too short"):
        te.ERA5Dataset(te.NpyBackend(store), temporal_step=N_FRAMES)


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, shuffle=True, seed=3),
    dict(batch_size=3, shuffle=True, seed=7, drop_last=False),
    dict(batch_size=1, shuffle=False, num_workers=3, prefetch=1),
    dict(batch_size=2, shuffle=True, seed=1, shard_id=1, num_shards=3),
    dict(batch_size=4, shuffle=True, seed=2, shard_id=0, num_shards=2, drop_last=False),
])
def test_loader_epochs_match_jax(store, kw):
    """The epoch order under shuffle and seed, the shards and a partial last
    batch: the same batches in the same order, epoch after epoch."""
    kw = {"num_shards": 1, **kw}
    dt = te.ERA5Dataset(te.NpyBackend(store), multi_step=1, temporal_step=2)
    dj = je.ERA5Dataset(je.NpyBackend(store), multi_step=1, temporal_step=2)
    lt, lj = te.PrefetchLoader(dt, **kw), je.PrefetchLoader(dj, **kw)
    assert len(lt) == len(lj)
    for epoch in (0, 1):
        np.testing.assert_array_equal(lt._order(epoch), lj._order(epoch))
        bt, bj = list(lt.epoch(epoch)), list(lj.epoch(epoch))
        assert len(bt) == len(bj) == len(lt)
        for a, b in zip(bt, bj):
            assert_batches_equal(a, b)


def test_loader_shards_cover_the_dataset(store):
    ds = te.ERA5Dataset(te.NpyBackend(store), temporal_step=2)
    orders = [te.PrefetchLoader(ds, shuffle=True, seed=4, shard_id=k, num_shards=3)._order(0)
              for k in range(3)]
    seen = np.concatenate(orders)
    assert len(set(seen.tolist())) == len(seen) == 3 * (len(ds) // 3)


def test_loader_shard_default_is_single_process(store):
    ds = te.ERA5Dataset(te.NpyBackend(store), temporal_step=2)
    loader = te.PrefetchLoader(ds)
    assert (loader.shard_id, loader.num_shards) == (0, 1)


def test_bf16_transfer_bits_match_jax(store):
    """transfer_dtype=torch.bfloat16 hands bf16 tensors over whose bit
    patterns equal ml_dtypes' cast in the JAX loader (non-NaN values), with
    the same NaN mask; times stay int64 numpy."""
    dt = te.ERA5Dataset(te.NpyBackend(store), multi_step=1, temporal_step=3)
    dj = je.ERA5Dataset(je.NpyBackend(store), multi_step=1, temporal_step=3)
    bt = list(te.PrefetchLoader(dt, batch_size=2, shuffle=True, seed=5,
                                transfer_dtype=torch.bfloat16, num_shards=1).epoch(0))
    bj = list(je.PrefetchLoader(dj, batch_size=2, shuffle=True, seed=5,
                                transfer_dtype=jnp.bfloat16, num_shards=1).epoch(0))
    assert len(bt) == len(bj)
    for a, b in zip(bt, bj):
        assert a.times.dtype == np.int64
        np.testing.assert_array_equal(a.times, b.times)
        for x, y in ((a.era5, b.era5), (a.sst, b.sst)):
            assert isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16
            assert y.dtype == ml_dtypes.bfloat16
            nan_x, nan_y = torch.isnan(x).numpy(), np.isnan(y.astype(np.float32))
            np.testing.assert_array_equal(nan_x, nan_y)
            bits_x = x.view(torch.int16).numpy().view(np.uint16)
            np.testing.assert_array_equal(bits_x[~nan_x], y.view(np.uint16)[~nan_y])


# ------------------------------------------------------------- native reader


def test_native_reader_builds_into_the_package():
    lib = tn.get_lib()
    assert lib is not None, "g++ should be available in this image"
    path = tn.library_path()
    assert path.exists() and path.parent == tn.BUILD_DIR
    assert path.parent.name == "_build" and path.parent.parent.name == "msfno_torch"


def test_native_reader_matches_numpy_and_jax(store):
    paths = [f"{store}/era5_{i:06d}.npy" for i in range(8)]
    assert tn.npy_info(paths[0]) == jn.npy_info(paths[0]) == ((4, 8, 3), 4)
    got = tn.load_npy_batch(paths, (4, 8, 3), n_threads=4)
    np.testing.assert_array_equal(got, np.stack([np.load(p) for p in paths]))
    np.testing.assert_array_equal(got, jn.load_npy_batch(paths, (4, 8, 3), n_threads=4))
    nb = tn.NativeNpyBackend(store)
    assert nb.native and np.isnan(nb.sst(0)[0, :2]).all()
    kw = dict(multi_step=1, temporal_step=2)
    a = te.ERA5Dataset(nb, **kw)
    b = je.ERA5Dataset(jn.NativeNpyBackend(store), **kw)
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    assert_batches_equal(a.get_batch([2, 0]), b.get_batch([2, 0]))


def test_npy_backend_reports_the_native_path(store, tmp_path):
    assert te.NpyBackend(store).native
    f64 = write_store(str(tmp_path / "f64"), n=6, dtype=np.float64)
    assert not te.NpyBackend(f64).native


def test_non_fp32_store_keeps_its_dtype(tmp_path):
    """A store of another dtype takes the per-file np.load path, as in JAX:
    the dtype is kept exactly, not cast through the fp32 buffer."""
    root = write_store(str(tmp_path / "f64"), n=8, dtype=np.float64)
    bt, bj = te.NpyBackend(root), je.NpyBackend(root)
    a, b = bt.era5_batch([3, 1]), bj.era5_batch([3, 1])
    assert a.dtype == b.dtype == np.float64
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(bt.sst_batch([0, 2]), bj.sst_batch([0, 2]))


def test_native_reader_errors(store, tmp_path):
    with pytest.raises(IOError):
        tn.load_npy_batch([f"{store}/era5_999999.npy"], (4, 8, 3))
    short = str(tmp_path / "short.npy")
    np.save(short, np.zeros((4, 8), np.float32))
    with pytest.raises(IOError):  # a short file never half-fills the buffer
        tn.load_npy_batch([short], item_shape=(4, 8, 3))
    with pytest.raises(ValueError):
        tn.load_npy_batch([short], (4, 8), out=np.empty((2, 4, 8), np.float32))


@pytest.mark.parametrize("dt", [np.int32, np.int64, np.float64])
def test_native_reader_converts_by_value(tmp_path, dt):
    p = str(tmp_path / f"x_{np.dtype(dt).name}.npy")
    ref = (np.arange(24).reshape(2, 3, 4) - 7).astype(dt)
    np.save(p, ref)
    out = tn.load_npy_batch([p], item_shape=(2, 3, 4))
    np.testing.assert_array_equal(out[0], ref.astype(np.float32))
    np.testing.assert_array_equal(out, jn.load_npy_batch([p], item_shape=(2, 3, 4)))


def test_npy_backend_rejects_gaps(tmp_path):
    root = write_store(str(tmp_path / "gap"), n=5)
    os.remove(f"{root}/era5_000002.npy")
    np.save(f"{root}/era5_stats.npy", np.zeros(3, np.float32))  # not a frame
    with pytest.raises(FileNotFoundError, match="missing"):
        te.NpyBackend(root)


# ------------------------------------------------------------- SST, ONI


def test_sst_store_matches_jax(store, tmp_path):
    st, sj = tsst.SSTNpyStore(store, temporal_step=4), jsst.SSTNpyStore(store, temporal_step=4)
    assert len(st) == len(sj) == N_FRAMES - 3
    np.testing.assert_array_equal(st.window(5), sj.window(5))
    a = list(st.batches(3, epochs=2, seed=9))
    b = list(sj.batches(3, epochs=2, seed=9))
    assert len(a) == len(b) == 2 * ((N_FRAMES - 3) // 3)
    for x, y in zip(a, b):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)
    with pytest.raises(FileNotFoundError, match="need >= 50"):
        tsst.SSTNpyStore(store, temporal_step=50)
    gap = write_store(str(tmp_path / "gap"), n=6)
    os.remove(f"{gap}/sst_000003.npy")
    with pytest.raises(FileNotFoundError, match="not contiguous"):
        tsst.SSTNpyStore(gap, temporal_step=2)


def test_coarsen_nino34_and_oni_match_jax():
    rng = np.random.default_rng(4)
    n, h, w = 60, 18, 36
    lat, lon = np.linspace(-85, 85, h), np.linspace(0, 350, w)
    sst = rng.standard_normal((n, h, w)).astype(np.float32)
    sst[:, :3, :5] = np.nan
    doy = (np.arange(n) * 7) % 366 + 1
    np.testing.assert_array_equal(tsst.coarsen(sst, 3), jsst.coarsen(sst, 3))
    np.testing.assert_array_equal(tsst.nino34_mask(lat, lon), jsst.nino34_mask(lat, lon))
    for kw in (dict(), dict(smooth_days=5, samples_per_day=4)):
        np.testing.assert_array_equal(tsst.compute_oni(sst, doy, lat, lon, **kw),
                                      jsst.compute_oni(sst, doy, lat, lon, **kw))


# ------------------------------------------------------------ climatology


class _IdxBackend:
    """Frames filled from their index (2 years of 6-hour steps, tiny)."""

    def __init__(self, n):
        self.n = n

    def era5(self, idx):
        return np.full((2, 3, 2), np.sin(0.01 * idx), np.float32) + np.arange(2, dtype=np.float32)

    def era5_batch(self, idcs):
        return np.stack([self.era5(i) for i in idcs])


def test_climatology_matches_jax(tmp_path):
    be = _IdxBackend(4 * 366 * 3)
    a = tclim.build_climatology(be, 1979, [1979, 1980], out_path=str(tmp_path / "c.npy"))
    b = jclim.build_climatology(be, 1979, [1979, 1980])
    assert a.shape == (365, 4, 2, 3, 2) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.load(tmp_path / "c.npy"), a)
    for doy, hour, leap in ((1, 0, False), (59, 6, True), (60, 12, True), (61, 18, True),
                            (365, 0, False), (366, 6, True)):
        np.testing.assert_array_equal(tclim.climatology_at(a, doy, hour, leap),
                                      jclim.climatology_at(a, doy, hour, leap))


# --------------------------------------------------------------- synthetic


def test_synthetic_generators_match_jax():
    cfg = small_cfg(film=True)
    for seed in (0, 3):
        mask = tsyn.synthetic_land_mask(5, 7, seed=seed)
        a = tsyn.synthetic_sst(np.random.default_rng(seed), 2, 3, 5, 7)
        b = jsyn.synthetic_sst(np.random.default_rng(seed), 2, 3, 5, 7)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            tsyn.synthetic_sst(np.random.default_rng(seed), 1, 2, 5, 7, land_mask=mask),
            jsyn.synthetic_sst(np.random.default_rng(seed), 1, 2, 5, 7, land_mask=mask))
    kw = dict(num_batches=3, batch_size=2, multi_step=1, seed=4, coupling=0.7, decay=0.8)
    for a, b in zip(tsyn.gen_coupled_batches(from_json(to_json(cfg)), **kw),
                    jsyn.gen_coupled_batches(cfg, **kw)):
        assert_batches_equal(a, b)


# ------------------------------------------------------------------ zarr


def test_zarr_backend_matches_jax(stores):  # noqa: F811 (the fixture)
    kw = dict(u100_path="u100.zarr", v100_path="v100.zarr", sst_path="sst.zarr",
              rh_path="rh.zarr")
    bt, bj = te.ZarrBackend("main.zarr", **kw), je.ZarrBackend("main.zarr", **kw)
    assert len(bt) == len(bj) == NT and bt.rh_offset == bj.rh_offset == RH_LAG_STEPS
    for idx in (RH_LAG_STEPS, NT - 1):
        np.testing.assert_array_equal(bt.era5(idx), bj.era5(idx))
        np.testing.assert_array_equal(bt.sst(idx), bj.sst(idx))
    with pytest.raises(IndexError, match="predates the rh store"):
        bt.era5(RH_LAG_STEPS - 1)
    # SST coarsened from the main store
    ct = te.ZarrBackend("main.zarr", u100_path="u100.zarr", v100_path="v100.zarr",
                        rh_path="rh.zarr", coarse_level=2)
    cj = je.ZarrBackend("main.zarr", u100_path="u100.zarr", v100_path="v100.zarr",
                        rh_path="rh.zarr", coarse_level=2)
    np.testing.assert_array_equal(ct.sst(5), cj.sst(5))
    dkw = dict(multi_step=1, temporal_step=2, start_idx=RH_LAG_STEPS)
    lt = te.PrefetchLoader(te.ERA5Dataset(bt, **dkw), batch_size=2, num_shards=1)
    lj = je.PrefetchLoader(je.ERA5Dataset(bj, **dkw), batch_size=2, num_shards=1)
    for a, b in zip(lt.epoch(0), lj.epoch(0)):
        assert_batches_equal(a, b)


def test_zarr_backend_without_xarray_raises(monkeypatch):
    monkeypatch.setitem(sys.modules, "xarray", None)
    with pytest.raises(ImportError, match="ZarrBackend needs xarray"):
        te.ZarrBackend("main.zarr")


# ------------------------------------------------------ the port's loader


def test_worker_error_reaches_the_consumer(store):
    ds = te.ERA5Dataset(te.NpyBackend(store), temporal_step=2)

    class Broken:
        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            raise OSError("corrupt file")

    with pytest.raises(RuntimeError, match="worker failed") as info:
        list(te.PrefetchLoader(Broken(), batch_size=1, num_shards=1).epoch(0))
    assert isinstance(info.value.__cause__, OSError)


def test_abandoned_epoch_leaves_no_worker_threads(store):
    """Dropping an epoch early (an islice'd validation loader does every
    pass) joins its workers; none stays blocked on the full queue."""
    ds = te.ERA5Dataset(te.NpyBackend(store), temporal_step=2)
    loader = te.PrefetchLoader(ds, batch_size=1, num_workers=4, prefetch=1, num_shards=1)
    before = set(threading.enumerate())
    for _ in range(3):
        it = loader.epoch(0)
        assert len(list(itertools.islice(it, 2))) == 2
        it.close()
    deadline = time.time() + 5
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not (set(threading.enumerate()) - before)


def test_data_modules_import_no_jax():
    code = ("import sys\n"
            "import msfno_torch.data.era5, msfno_torch.data.sst, msfno_torch.data.climatology\n"
            "import msfno_torch.data.native_loader, msfno_torch.data.synthetic\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'msfno_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
