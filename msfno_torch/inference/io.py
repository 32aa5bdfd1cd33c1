"""Operational input sources and output writers (port of
msfno_tpu/inference/io.py; reference MSFNO/inputs/__init__.py:99-297 and
MSFNO/outputs/__init__.py:12-246).

The reference's providers are climetlab/MARS/CDS-backed (grib) and need
network egress; they are registered but raise with a clear message, while
the file-backed providers (npy / npz, this package's npy store) work.
Outputs take numpy fields (what `ModelWrapper.running` yields: each step
is copied to the host there) and write the JAX package's files byte for
byte.  The registry API (`get_input`, `get_output`, `available_inputs`,
`available_outputs`) mirrors the reference.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Sequence

import numpy as np

log = logging.getLogger("msfno_torch")


# ----------------------------------------------------------------- inputs

class NoInput:
    """Placeholder input (reference NoInput)."""

    def __init__(self, owner, **kw):
        self.owner = owner

    def all_fields(self):
        raise RuntimeError("NoInput provides no fields")


class FileInput:
    """Initial conditions from an .npy/.npz file: (1, H, W, C) channels-last
    (reference FileInput reads grib; same role)."""

    def __init__(self, owner, file: str | None = None, **kw):
        self.owner = owner
        self.file = file

    def all_fields(self) -> np.ndarray:
        if self.file is None:
            raise ValueError("FileInput requires file=...")
        if self.file.endswith(".npz"):
            with np.load(self.file) as z:
                arr = z[list(z.files)[0]]
        else:
            arr = np.load(self.file)
        if arr.ndim == 3:
            arr = arr[None]
        return arr.astype(np.float32)


class LocalInput:
    """Initial conditions from an era5 npy store (see data/era5.NpyBackend)
    at a given time index (reference LocalInput reads a local netcdf tree)."""

    def __init__(self, owner, path: str | None = None, time_index: int = 0, **kw):
        self.owner = owner
        self.path = path
        self.time_index = time_index

    def all_fields(self) -> np.ndarray:
        from msfno_torch.data.era5 import NpyBackend

        return NpyBackend(self.path).era5(self.time_index)[None]


class _UnavailableInput:
    def __init__(self, name):
        self.name = name

    def __call__(self, owner, **kw):
        raise RuntimeError(
            f"input source {self.name!r} needs climetlab/cdsapi and network "
            "egress (reference MSFNO/inputs/__init__.py); pre-stage data and "
            "use 'file' or 'localsource' instead"
        )


INPUTS = {
    "mars": _UnavailableInput("mars"),
    "cds": _UnavailableInput("cds"),
    "file": FileInput,
    "localsource": LocalInput,
    "none": NoInput,
}


def available_inputs() -> list[str]:
    return sorted(INPUTS)


def get_input(name: str, owner=None, **kw):
    return INPUTS[name](owner, **kw)


# ---------------------------------------------------------------- outputs

class NoneOutput:
    """Discards output (reference NoneOutput)."""

    def __init__(self, owner=None, **kw):
        pass

    def write(self, data, step: int = 0, **kw):
        pass


def _channel_filter(variables, ordering):
    """(keep_indices | None, kept_names | None) for an output-variables
    request.  A filter without a channel ordering is an error, not a silent
    write-everything: the caller asked for specific variables by name."""
    if variables is None:
        return None, list(ordering) if ordering else None
    if not ordering:
        raise ValueError(
            "output-variables filter given but the model wrapper provides "
            "no channel ordering to resolve names against"
        )
    ordering = list(ordering)
    return [ordering.index(v) for v in variables], list(variables)


def _check_filter(keep, names, channels: int) -> None:
    """Filter indices must exist in the ACTUAL data: a reduced-size model
    carries fewer channels than the full ordering, and a bare IndexError
    mid-write (after earlier steps were written) is not a diagnosis."""
    bad = [n for k, n in zip(keep, names) if k >= channels]
    if bad:
        raise ValueError(
            f"output-variables {bad} sit beyond the model's {channels} "
            "channels (reduced-size model vs full ordering)"
        )


class FileOutput:
    """Per-step .npy dump with a JSON manifest (role of the reference's grib
    FileOutput, outputs/__init__.py:12-72).  Supports the
    output-variables.json channel filter (outputs/__init__.py:36-56)."""

    def __init__(self, owner=None, path: str = "./forecast",
                 variables: Sequence[str] | None = None,
                 ordering: Sequence[str] | None = None, **kw):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.ordering = list(ordering) if ordering else None
        self.keep, self.kept_names = _channel_filter(variables, ordering)
        self.manifest = {"steps": [], "variables": self.kept_names}

    def write(self, data: np.ndarray, step: int = 0, **kw):
        if self.keep is not None:
            _check_filter(self.keep, self.kept_names, data.shape[-1])
            data = data[..., self.keep]
        elif (
            self.manifest["variables"]
            and len(self.manifest["variables"]) != data.shape[-1]
        ):
            # reduced-size model with the full ordering table: record only
            # the names actually present (the NetCDF writer's names[:C])
            # so manifest consumers never map channels past the data
            self.manifest["variables"] = self.manifest["variables"][
                : data.shape[-1]
            ]
        np.save(os.path.join(self.path, f"step_{step:04d}.npy"), data)
        self.manifest["steps"].append(int(step))
        if kw:  # hindcast relabel metadata etc. (outputs/__init__.py:193-218)
            self.manifest.setdefault("metadata", {}).update(
                {k: v for k, v in kw.items() if isinstance(v, (int, float, str))}
            )
        with open(os.path.join(self.path, "manifest.json"), "w") as f:
            json.dump(self.manifest, f)


class NetCDFOutput:
    """Real NetCDF3 writer via scipy.io.netcdf_file — one .nc per step, the
    reference's layout (NetCDFOutput, outputs/__init__.py:74-189: per-step
    files under a subdirectory, combined later with open_mfdataset; per
    retained variable a (lat, lon) field plus latitude/longitude/step
    coordinates; step stored in hours)."""

    def __init__(self, owner=None, path: str = "./forecast",
                 variables: Sequence[str] | None = None,
                 ordering: Sequence[str] | None = None,
                 lat: np.ndarray | None = None,
                 lon: np.ndarray | None = None, **kw):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self.ordering = list(ordering) if ordering else None
        self.keep, self.kept_names = _channel_filter(variables, ordering)
        self.lat = lat
        self.lon = lon

    def write(self, data: np.ndarray, step: int = 0, **kw):
        from scipy.io import netcdf_file

        field = np.asarray(data)
        if field.ndim == 4:  # (B, H, W, C) -> first sample
            field = field[0]
        h, w, c = field.shape
        if self.keep is not None:
            _check_filter(self.keep, self.kept_names, c)
            field = field[..., self.keep]
        names = (self.kept_names or [f"var{i}" for i in range(field.shape[-1])])
        names = names[: field.shape[-1]]  # ordering may exceed the channels
        # of a reduced-size model; write what exists
        lat = self.lat if self.lat is not None else np.linspace(90, -90, h)
        lon = self.lon if self.lon is not None else np.linspace(
            0, 360, w, endpoint=False
        )
        out = os.path.join(self.path, f"step_{step:04d}.nc")
        with netcdf_file(out, "w") as nc:
            for k, v in kw.items():  # hindcast relabel metadata -> attrs
                if isinstance(v, (int, float, str)):
                    setattr(nc, k, v)
            nc.createDimension("latitude", h)
            nc.createDimension("longitude", w)
            nc.createDimension("step", 1)
            vlat = nc.createVariable("latitude", "f", ("latitude",))
            vlat[:] = lat.astype(np.float32)
            vlat.units = "degrees_north"
            vlon = nc.createVariable("longitude", "f", ("longitude",))
            vlon[:] = lon.astype(np.float32)
            vlon.units = "degrees_east"
            vstep = nc.createVariable("step", "i", ("step",))
            vstep[:] = np.asarray([step], np.int32)
            vstep.units = "hours"
            for i, name in enumerate(names):
                v = nc.createVariable(name, "f", ("step", "latitude", "longitude"))
                v[:] = field[None, :, :, i].astype(np.float32)
        return out


class HindcastReLabel:
    """Wraps an output, rewriting forecast init metadata to hindcast
    (referenceDate/hdate) semantics (reference outputs/__init__.py:193-218)."""

    def __init__(self, owner, output, reference_date: int, hdate: int, **kw):
        self.output = output
        self.reference_date = reference_date
        self.hdate = hdate

    def write(self, data, step: int = 0, **kw):
        kw.update(reference_date=self.reference_date, hdate=self.hdate)
        self.output.write(data, step=step, **kw)


OUTPUTS = {
    "file": FileOutput,
    "netcdf": NetCDFOutput,
    "none": NoneOutput,
}


def available_outputs() -> list[str]:
    return sorted(OUTPUTS)


def get_output(name: str, owner=None, **kw):
    return OUTPUTS[name](owner, **kw)
