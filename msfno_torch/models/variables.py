"""ERA5 variable tables for the 73-channel SFNO state (this package's copy of
msfno_tpu/models/variables.py; reference FourCastNetv2 class attrs,
MSFNO/Models/sfno/model.py:42-154)."""

from __future__ import annotations

PARAM_SFC = ["10u", "10v", "2t", "sp", "msl", "tcwv", "100u", "100v"]

PL_PARAMS = ["u", "v", "z", "t", "r"]
PL_LEVELS = [1000, 925, 850, 700, 600, 500, 400, 300, 250, 200, 150, 100, 50]

# 73-channel ordering (model.py:62-136): 8 surface fields then, per pl
# parameter, levels from 50 hPa up to 1000 hPa.
ORDERING = (
    ["10u", "10v", "100u", "100v", "2t", "sp", "msl", "tcwv"]
    + [f"{p}{lev}" for p in PL_PARAMS for lev in sorted(PL_LEVELS)]
)

assert len(ORDERING) == 73

# ERA5/xarray cfVarName aliases (model.py:137-154)
ERA5_SFC_NAMES = {
    "10u": "10m_u_component_of_wind",
    "10v": "10m_v_component_of_wind",
    "2t": "2m_temperature",
    "sp": "surface_pressure",
    "msl": "mean_sea_level_pressure",
    "tcwv": "total_column_water_vapour",
    "100u": "100m_u_component_of_wind",
    "100v": "100m_v_component_of_wind",
}

ERA5_PL_NAMES = {
    "u": "u_component_of_wind",
    "v": "v_component_of_wind",
    "z": "geopotential",
    "t": "temperature",
    "r": "relative_humidity",
}

# ECMWF pretrained asset endpoint (model.py:38-39); kept for provenance —
# this image has no egress, assets must be pre-staged.
DOWNLOAD_URL = (
    "https://get.ecmwf.int/repository/test-data/ai-models/fourcastnetv2/small/{file}"
)
DOWNLOAD_FILES = ["weights.tar", "global_means.npy", "global_stds.npy"]

GRID = {"area": [90, 0, -90, 360 - 0.25], "grid": [0.25, 0.25]}


def channel_index(name: str) -> int:
    return ORDERING.index(name)
