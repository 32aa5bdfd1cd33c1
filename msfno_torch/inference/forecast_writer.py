"""Forecast archive writer (port of msfno_tpu/inference/forecast_writer.py;
reference save_to_zarr_forecast, MSFNO/Models/train.py:1024-1110: dims
(prediction_timedelta, time, [level], lat, lon), chunked {time: 1},
append-dim time — the weatherbench2 layout).

The schema is written as a directory of per-forecast-time .npy chunks plus
a JSON header, byte for byte the JAX package's files: one chunk per init
time, appendable, convertible 1:1 to zarr offline (the header carries dims
and coords verbatim).  Chunks are numpy arrays: a caller with a forecast on
the card copies it to the host for `append`.
"""

from __future__ import annotations

import json
import os

import numpy as np


class ForecastWriter:
    """Appendable (prediction_timedelta, time, lat, lon, channel) archive."""

    def __init__(
        self,
        path: str,
        channels: list[str],
        lat: np.ndarray,
        lon: np.ndarray,
        step_hours: int = 6,
    ):
        self.path = path
        os.makedirs(path, exist_ok=True)
        header = os.path.join(path, "header.json")
        if os.path.exists(header):
            # append-dim semantics: re-opening an existing archive RESUMES
            # it (a restarted job must not clobber time_00000.npy and lose
            # every previously appended init time)
            with open(header) as f:
                self.meta = json.load(f)
            if self.meta.get("channels") != list(channels):
                raise ValueError(
                    f"existing archive at {path} has channels "
                    f"{self.meta.get('channels')}, not {list(channels)}"
                )
        else:
            self.meta = {
                "dims": ["prediction_timedelta", "time", "lat", "lon",
                         "channel"],
                "channels": list(channels),
                "step_hours": step_hours,
                "lat": np.asarray(lat).tolist(),
                "lon": np.asarray(lon).tolist(),
                "times": [],
            }

    def append(self, init_time: int, forecast: np.ndarray):
        """forecast: (prediction_timedelta, lat, lon, channel) for one init
        time (chunk {time: 1}, train.py:1090-1098)."""
        idx = len(self.meta["times"])
        np.save(os.path.join(self.path, f"time_{idx:05d}.npy"), forecast)
        self.meta["times"].append(int(init_time))
        # atomic replace: a crash mid-dump must not truncate header.json —
        # it is the index for every previously appended chunk, and both
        # resume (__init__) and read() would be dead on a partial file
        tmp = os.path.join(self.path, "header.json.tmp")
        with open(tmp, "w") as f:
            json.dump(self.meta, f)
        os.replace(tmp, os.path.join(self.path, "header.json"))

    @staticmethod
    def read(path: str) -> tuple[dict, np.ndarray]:
        with open(os.path.join(path, "header.json")) as f:
            meta = json.load(f)
        chunks = [
            np.load(os.path.join(path, f"time_{i:05d}.npy"))
            for i in range(len(meta["times"]))
        ]
        return meta, np.stack(chunks, axis=1)  # (pred_td, time, lat, lon, ch)
