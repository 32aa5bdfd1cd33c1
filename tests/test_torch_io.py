"""Operational inputs and outputs of the PyTorch port (msfno_torch/
inference/io.py) against the JAX package's: the registries, `FileInput`
(npy, npz, 3-D) and `LocalInput` over an npy store read the same arrays,
the live-retrieval sources raise; `FileOutput`, `NetCDFOutput` and
`HindcastReLabel` write byte-identical files for the same arrays (the
output-variables filter, the reduced-model name trim, metadata), and raise
on the same bad filters; scipy reads each .nc back as the fp32 field bit
for bit; `ModelWrapper.running(output=...)` writes what it yields."""

import os

import numpy as np
import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.inference import io as tio
from msfno_torch.models import registry as treg
from msfno_torch.models.variables import ORDERING
from msfno_tpu.inference import io as jio
from msfno_tpu.models import variables as jvars

torch.set_num_threads(2)


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


def _field(seed, c=73, b=1, h=6, w=12):
    return np.random.default_rng(seed).standard_normal((b, h, w, c)).astype(np.float32)


def test_variables_are_the_jax_tables():
    assert ORDERING == jvars.ORDERING and len(ORDERING) == 73
    from msfno_torch.models import variables as tvars

    for name in ("PARAM_SFC", "PL_PARAMS", "PL_LEVELS", "ERA5_SFC_NAMES", "ERA5_PL_NAMES",
                 "GRID", "DOWNLOAD_FILES"):
        assert getattr(tvars, name) == getattr(jvars, name), name
    assert tvars.channel_index("z500") == jvars.channel_index("z500")


def test_registries_match_jax():
    assert tio.available_inputs() == jio.available_inputs()
    assert tio.available_outputs() == jio.available_outputs()


def test_inputs_match_jax(tmp_path):
    x = _field(0)
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "x3.npy", x[0])
    np.savez(tmp_path / "x.npz", state=x)
    for name in ("x.npy", "x3.npy", "x.npz"):
        a = tio.get_input("file", file=str(tmp_path / name)).all_fields()
        b = jio.get_input("file", file=str(tmp_path / name)).all_fields()
        assert a.dtype == np.float32 and a.shape == (1, 6, 12, 73)
        np.testing.assert_array_equal(a, b)
    store = tmp_path / "store"
    store.mkdir()
    for i in range(3):
        np.save(store / f"era5_{i:06d}.npy", _field(i + 1)[0])
    a = tio.get_input("localsource", path=str(store), time_index=2).all_fields()
    np.testing.assert_array_equal(
        a, jio.get_input("localsource", path=str(store), time_index=2).all_fields())
    for name in ("mars", "cds"):
        with pytest.raises(RuntimeError, match="egress"):
            tio.get_input(name)
    with pytest.raises(RuntimeError):
        tio.get_input("none").all_fields()
    with pytest.raises(ValueError):
        tio.get_input("file").all_fields()


@pytest.mark.parametrize("variables,channels", [
    (None, 73),  # every channel, named by the ordering
    (["z500", "2t", "10u"], 73),  # the output-variables filter
    (None, 5),  # a reduced-size model: the names trimmed to its channels
])
def test_file_and_netcdf_outputs_are_jax_bytes(tmp_path, variables, channels):
    from scipy.io import netcdf_file

    for kind in ("file", "netcdf"):
        for mod, name in ((jio, "jax"), (tio, "port")):
            out = mod.get_output(kind, path=str(tmp_path / f"{kind}_{name}"),
                                 variables=variables, ordering=jvars.ORDERING)
            for step in (6, 12):
                out.write(_field(step, c=channels), step=step)
            hind = mod.HindcastReLabel(None, out, reference_date=20200101, hdate=20100101)
            hind.write(_field(18, c=channels), step=18)
        a, b = _files(tmp_path / f"{kind}_jax"), _files(tmp_path / f"{kind}_port")
        assert sorted(a) == sorted(b) and a == b, kind
    # scipy reads the port's fields back, fp32, bit for bit
    names = variables or jvars.ORDERING[:channels]
    field = _field(12, c=channels)[0]
    with netcdf_file(str(tmp_path / "netcdf_port" / "step_0012.nc"), "r", mmap=False) as nc:
        assert int(nc.variables["step"][0]) == 12
        for name in names:
            v = nc.variables[name][:]
            assert v.dtype == np.dtype(">f4")  # NetCDF3 stores big-endian fp32
            np.testing.assert_array_equal(v[0], field[..., jvars.ORDERING.index(name)])


def test_output_filter_errors_match_jax(tmp_path):
    for mod in (jio, tio):
        for kind in ("file", "netcdf"):
            with pytest.raises(ValueError, match="ordering"):
                mod.get_output(kind, path=str(tmp_path / kind), variables=["z500"])
            out = mod.get_output(kind, path=str(tmp_path / kind), variables=["z500"],
                                 ordering=jvars.ORDERING)
            with pytest.raises(ValueError, match="beyond"):
                out.write(_field(0, c=5), step=6)
        mod.get_output("none").write(_field(0))


def test_running_writes_what_it_yields(tmp_path):
    """ModelWrapper.running with a NetCDF output: one .nc per 6-hour step
    holding the yielded fp32 field, channels named by the wrapper's
    ordering (trimmed to a small model's channels)."""
    from scipy.io import netcdf_file

    film = tcfg.FilmConfig(model_depth=1, embed_dim=8, mlp_dim=8, num_film_features=8,
                           sst_shape=(8, 16), temporal_step=2)
    cfg = tcfg.SFNOConfig(img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3,
                          embed_dim=8, num_layers=2, spectral_layers=1, film=film)
    w = treg.get_model("sfno", "film", cfg=cfg, device="cpu", seed=1)
    out = tio.get_output("netcdf", path=str(tmp_path / "nc"), ordering=w.ordering)
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((1, 16, 32, 3)).astype(np.float32)
    sst = rng.standard_normal((2, 1, 2, 8, 16)).astype(np.float32)
    fields = list(w.running(x0, lead_time_h=12, sst_seq=sst, output=out))
    assert sorted(os.listdir(tmp_path / "nc")) == ["step_0006.nc", "step_0012.nc"]
    for i, f in enumerate(fields):
        with netcdf_file(str(tmp_path / "nc" / f"step_{6 * (i + 1):04d}.nc"), "r",
                         mmap=False) as nc:
            assert set(ORDERING[:3]) <= set(nc.variables)
            for c, name in enumerate(ORDERING[:3]):
                np.testing.assert_array_equal(nc.variables[name][:][0], f[0, ..., c])
