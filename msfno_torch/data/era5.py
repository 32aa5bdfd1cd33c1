"""ERA5 dataset and loader (port of msfno_tpu/data/era5.py; reference
ERA5_galvani, MSFNO/Models/data.py:21-231).

A sample is S = multi_step + 2 consecutive 6-hour states plus an SST history
window per step, read through a backend:

- `NpyBackend`: a directory of per-step .npy files (the layout of
  tools/make_npy_store.py), read in bulk by the native C++ reader
  (data/native_loader.py);
- `ZarrBackend`: the weatherbench2 zarr stores, gated on xarray (importing
  it is deferred to construction, which raises a clear error without it).

`PrefetchLoader` assembles batches on worker threads.  Everything here is
numpy on the host, bit for bit the JAX package's arrays; with
`transfer_dtype=torch.bfloat16` the workers hand the float fields over as
bf16 torch tensors instead.  Channel assembly reproduces the reference's
recipe (data.py:161-196): vstack(scf[:2], u100, v100, scf[2:], pl at
ascending levels, r).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
from calendar import isleap
from datetime import datetime, timedelta
from typing import Iterator, Sequence

import numpy as np
import torch

from msfno_torch.data.native_loader import get_lib, load_npy_batch, npy_info
from msfno_torch.data.sst import coarsen, frame_indices
from msfno_torch.data.synthetic import Batch

STEPS_PER_DAY = 4  # 6-hourly

# pressure levels (hPa) and the ERA5 / xarray names of the fields
# (reference sfno/model.py:54-57,137-154)
PL_LEVELS = (1000, 925, 850, 700, 600, 500, 400, 300, 250, 200, 150, 100, 50)
ERA5_SFC_NAMES = {
    "10u": "10m_u_component_of_wind", "10v": "10m_v_component_of_wind",
    "2t": "2m_temperature", "sp": "surface_pressure", "msl": "mean_sea_level_pressure",
    "tcwv": "total_column_water_vapour",
}
ERA5_PL_NAMES = {
    "u": "u_component_of_wind", "v": "v_component_of_wind", "z": "geopotential",
    "t": "temperature", "r": "relative_humidity",
}


def zarr_level_order() -> list[int]:
    """Pressure levels in the order of the zarr reads, ascending 50..1000:
    the reference reverses its descending list before `.sel(level=...)`
    (data.py:157-158), so the channels run u50..u1000, the checkpoint's
    order."""
    return sorted(PL_LEVELS)


def year_range_indices(dataset_start_year: int, start_year: int, end_year: int):
    """(start_idx, end_idx) in 6-hour steps from the dataset start
    (reference data.py:138-151), leap years counted."""
    days = lambda y: 366 if isleap(y) else 365  # noqa: E731
    start_idx = STEPS_PER_DAY * sum(days(y) for y in range(dataset_start_year, start_year))
    end_idx = STEPS_PER_DAY * sum(days(y) for y in range(dataset_start_year, end_year)) - 1
    return start_idx, end_idx


def index_to_yyyymmddhh(dataset_start_year: int, idx: int) -> int:
    """6-hour-step index -> YYYYMMDDHH int, the reference's time format
    (data.py:162-163)."""
    t = datetime(dataset_start_year, 1, 1) + timedelta(hours=6 * idx)
    return t.year * 1000000 + t.month * 10000 + t.day * 100 + t.hour


def yyyymmddhh_to_index(dataset_start_year: int, t: int) -> int:
    """The inverse of index_to_yyyymmddhh; hours are floored to the 6-hour
    grid."""
    y, mo, d, h = t // 10**6, t // 10**4 % 100, t // 100 % 100, t % 100
    dt = datetime(y, mo, d, (h // 6) * 6) - datetime(dataset_start_year, 1, 1)
    return int(dt.total_seconds()) // (6 * 3600)


def rollout_sst_window_start(base: int, step: int, temporal_step: int, past_sst: bool) -> int:
    """Start of the SST window fed at rollout step `step` from the initial
    condition `base`, the training convention (the loss feeds window step+1
    of `ERA5Dataset`'s per-sample windows): past_sst=False starts at the
    forecast's valid time, past_sst=True ends strictly before it."""
    return base + step + 1 - (temporal_step + 1 if past_sst else 0)


def assemble_channels(scf: np.ndarray, u100: np.ndarray, v100: np.ndarray, pl: np.ndarray,
                      r: np.ndarray | None = None) -> np.ndarray:
    """The 73 channels, channels-last (reference data.py:161-196).

    scf: (6, H, W) surface fields (10u, 10v, 2t, sp, msl, tcwv); u100 / v100:
    (H, W); pl: (4 or 5, 13, H, W) pressure-level fields (u, v, z, t[, r]) at
    ascending levels 50..1000; r: (13, H, W) relative humidity when not in pl.
    Returns (H, W, 73) fp32."""
    parts = [scf[:2], u100[None], v100[None], scf[2:]]
    parts.append(pl.reshape(pl.shape[0] * pl.shape[1], *pl.shape[2:]))
    if r is not None:
        parts.append(r)
    stacked = np.vstack(parts)
    if stacked.shape[0] != 73:
        raise ValueError(f"expected 73 channels, got {stacked.shape[0]}")
    return np.ascontiguousarray(np.moveaxis(stacked, 0, -1), dtype=np.float32)


class NpyBackend:
    """A directory of per-step arrays: {root}/era5_{idx:06d}.npy (H, W, 73)
    channels-last states and optionally {root}/sst_{idx:06d}.npy (Hs, Ws)
    SST with NaN over land.  The era5 frames must be numbered 0..n-1 without
    a gap (checked here, not inside a loader worker).

    `era5_batch` / `sst_batch` read many steps with one call of the native
    reader into one fp32 buffer.  A store of another dtype takes the
    per-file `np.load` path and keeps its dtype exactly."""

    def __init__(self, root: str):
        self.root = root
        idcs = frame_indices(root, "era5")
        self.n = len(idcs)
        if self.n == 0:
            raise FileNotFoundError(f"no era5_*.npy files under {root}")
        if idcs != list(range(self.n)):
            missing = sorted(set(range(idcs[-1] + 1)) - set(idcs))
            raise FileNotFoundError(
                f"era5_*.npy must be numbered 0..{self.n - 1} under {root}; "
                f"missing {missing[:5]}{'...' if len(missing) > 5 else ''}")
        self.has_sst = os.path.exists(os.path.join(root, "sst_000000.npy"))
        self._shapes: dict[str, tuple[int, ...] | None] = {}

    def __len__(self):
        return self.n

    def _path(self, kind: str, idx: int) -> str:
        return os.path.join(self.root, f"{kind}_{idx:06d}.npy")

    def era5(self, idx: int) -> np.ndarray:
        return np.load(self._path("era5", idx))

    def sst(self, idx: int) -> np.ndarray | None:
        return np.load(self._path("sst", idx)) if self.has_sst else None

    def _shape(self, kind: str) -> tuple[int, ...] | None:
        """The frame shape of an fp32 store (the bulk path), None for any
        other dtype (the exact per-file path)."""
        if kind not in self._shapes:
            first = self._path(kind, 0)
            shape, word_size = npy_info(first)
            fp32 = np.load(first, mmap_mode="r").dtype == np.float32 and word_size == 4
            self._shapes[kind] = shape if fp32 else None
        return self._shapes[kind]

    @property
    def native(self) -> bool:
        """True when the bulk reads of the era5 frames go through the C++
        reader (an fp32 store and a built reader)."""
        return self._shape("era5") is not None and get_lib() is not None

    def era5_batch(self, idcs) -> np.ndarray:
        shape = self._shape("era5")
        if shape is None:
            return np.stack([self.era5(i) for i in idcs])
        return load_npy_batch([self._path("era5", i) for i in idcs], shape)

    def sst_batch(self, idcs) -> np.ndarray | None:
        if not self.has_sst:
            return None
        shape = self._shape("sst")
        if shape is None:
            return np.stack([self.sst(i) for i in idcs])
        return load_npy_batch([self._path("sst", i) for i in idcs], shape)


class ZarrBackend:
    """The weatherbench2-layout zarr stores (reference data.py:86-104): the
    main ERA5 store, u100 / v100 stores, an optional relative-humidity store
    (its time offset derived from the two time axes) and an optional
    pre-coarsened SST store (else the main store's SST, coarsened by
    `coarse_level`).  Needs xarray and zarr, imported on construction."""

    def __init__(self, path: str, u100_path: str | None = None, v100_path: str | None = None,
                 sst_path: str | None = None, rh_path: str | None = None,
                 coarse_level: int = 4):
        try:
            import xarray as xr
        except ImportError as e:
            raise ImportError("ZarrBackend needs xarray/zarr; use NpyBackend in this image") from e
        open_ = lambda p: xr.open_zarr(p, chunks=None) if p else None  # noqa: E731
        self.ds = xr.open_zarr(path, chunks=None)
        self.ds_u100, self.ds_v100 = open_(u100_path), open_(v100_path)
        self.ds_sst, self.ds_rh = open_(sst_path), open_(rh_path)
        # the CDS rh store starts decades after the WB2 ERA5 store; the
        # reference hard-codes 29220 steps (data.py:176), derived here from
        # the time axes (the same number for those stores)
        self.rh_offset = 0
        if self.ds_rh is not None:
            dt = np.datetime64(self.ds_rh.time.values[0]) - np.datetime64(self.ds.time.values[0])
            self.rh_offset = int(dt / np.timedelta64(6, "h"))
        self.coarse_level = coarse_level
        self.sfc_names = [ERA5_SFC_NAMES[k] for k in ("10u", "10v", "2t", "sp", "msl", "tcwv")]
        self.pl_names = [ERA5_PL_NAMES[k] for k in ("u", "v", "z", "t")]
        self.rh_name = ERA5_PL_NAMES["r"]
        self.levels = zarr_level_order()
        self.n = self.ds.sizes["time"]

    def __len__(self):
        return self.n

    def era5(self, idx: int) -> np.ndarray:
        s = self.ds.isel(time=idx)
        scf = s[self.sfc_names].to_array().to_numpy()
        u100 = self.ds_u100.isel(time=idx)["u100"].to_numpy()
        v100 = self.ds_v100.isel(time=idx)["v100"].to_numpy()
        if self.ds_rh is None:
            pl = s[self.pl_names + [self.rh_name]].sel(level=self.levels).to_array().to_numpy()
            return assemble_channels(scf, u100, v100, pl)
        pl = s[self.pl_names].sel(level=self.levels).to_array().to_numpy()
        ridx = idx - self.rh_offset
        if ridx < 0:
            raise IndexError(f"time index {idx} predates the rh store (offset "
                             f"{self.rh_offset} steps; reference data.py:176)")
        rsel = self.ds_rh.isel(time=ridx)
        if "level" in self.ds_rh.coords:
            # the same ascending levels as pl, or rh's 13 channels would be
            # scrambled against the channel order
            rsel = rsel.sel(level=self.levels)
        name = self.rh_name if self.rh_name in self.ds_rh.data_vars else list(self.ds_rh.data_vars)[0]
        return assemble_channels(scf, u100, v100, pl, rsel[name].to_numpy())

    def sst(self, idx: int) -> np.ndarray:
        src = self.ds_sst if self.ds_sst is not None else self.ds
        sst = src.isel(time=idx)["sea_surface_temperature"].to_numpy()
        return sst if self.ds_sst is not None else coarsen(sst, self.coarse_level)


@dataclasses.dataclass
class ERA5Dataset:
    """Multi-step samples over a backend (reference __getitem__,
    data.py:156-231): sample i is S = multi_step + 2 consecutive states and a
    temporal_step-long SST window per step.

    SST windows follow the reference's get_sst and per-step slice
    (data.py:204-211,227):
    - past_sst=False (the default): step i's window is [base+i, base+i+T);
    - past_sst=True: step i's window is [base+i-T-1, base+i-1), strictly
      past.
    `dataset_start_year` makes the times YYYYMMDDHH ints (else zeros)."""

    backend: object
    multi_step: int = 0
    temporal_step: int = 28
    with_sst: bool = True
    past_sst: bool = False
    start_idx: int = 0
    end_idx: int | None = None
    dataset_start_year: int | None = None

    def __post_init__(self):
        n = len(self.backend)
        s = self.multi_step + 2
        if self._sst_active and self.past_sst:
            self._pad_past, future_needed = self.temporal_step + 1, s
        elif self._sst_active:
            self._pad_past, future_needed = 0, max(s, s - 1 + self.temporal_step)
        else:
            self._pad_past, future_needed = 0, s
        end = n if self.end_idx is None else self.end_idx  # 0 is explicit
        self.end_idx = min(end, n) - (self._pad_past + future_needed)
        if self.end_idx <= self.start_idx:
            raise ValueError("dataset too short for the requested windows")

    @property
    def _sst_active(self) -> bool:
        return self.with_sst and getattr(self.backend, "has_sst", True)

    def __len__(self):
        return self.end_idx - self.start_idx

    def _sst_window_start(self, base: int, i: int) -> int:
        return base + i - (self.temporal_step + 1 if self.past_sst else 0)

    def _times(self, bases: list[int]) -> np.ndarray:
        """(S, len(bases)) int64 times of the samples' steps."""
        s = self.multi_step + 2
        if self.dataset_start_year is None:
            return np.zeros((s, len(bases)), dtype=np.int64)
        return np.asarray([[index_to_yyyymmddhh(self.dataset_start_year, b + j) for b in bases]
                           for j in range(s)], dtype=np.int64)

    def __getitem__(self, idx: int):
        """(era5 (S, H, W, C), sst (S, T, Hs, Ws) or None, times (S,))."""
        base = self.start_idx + idx + self._pad_past
        s = self.multi_step + 2
        era5 = np.stack([self.backend.era5(base + i) for i in range(s)])
        sst = None
        if self._sst_active:
            windows = []
            for i in range(s):
                w0 = self._sst_window_start(base, i)
                w = [self.backend.sst(w0 + t) for t in range(self.temporal_step)]
                if w[0] is None:
                    break
                windows.append(np.stack(w))
            else:
                sst = np.stack(windows)
        return era5, sst, self._times([base])[:, 0]

    def get_batch(self, idcs: Sequence[int]) -> Batch:
        """A whole batch in bulk: one backend read for the B*S states and one
        for the unique SST steps (the windows of adjacent steps overlap
        almost entirely).  era5 (S, B, H, W, C), sst (S, B, T, Hs, Ws)."""
        s = self.multi_step + 2
        bases = [self.start_idx + int(i) + self._pad_past for i in idcs]
        flat = [b + j for b in bases for j in range(s)]  # (B*S) order
        if hasattr(self.backend, "era5_batch"):
            era5_bs = self.backend.era5_batch(flat)
        else:
            era5_bs = np.stack([self.backend.era5(i) for i in flat])
        era5 = np.ascontiguousarray(
            era5_bs.reshape(len(bases), s, *era5_bs.shape[1:]).swapaxes(0, 1))
        sst = None
        if self._sst_active:
            t = self.temporal_step
            start = self._sst_window_start
            needed = sorted({start(b, j) + k for b in bases for j in range(s) for k in range(t)})
            if hasattr(self.backend, "sst_batch"):
                loaded = self.backend.sst_batch(needed)
            else:
                fields = [self.backend.sst(i) for i in needed]
                loaded = np.stack(fields) if fields[0] is not None else None
            if loaded is not None:
                pos = {idx: n for n, idx in enumerate(needed)}
                gather = np.asarray([[[pos[start(b, j) + k] for k in range(t)] for b in bases]
                                     for j in range(s)])
                sst = loaded[gather]  # (S, B, T, Hs, Ws)
        return Batch(era5=era5, sst=sst, times=self._times(bases))


def _default_shard() -> tuple[int, int]:
    """(rank, world size) of an initialized torch.distributed group, else
    (0, 1); never initializes anything."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _cast(x, dtype):
    """A float field in the transfer dtype: a torch tensor for a torch dtype
    (numpy has no bf16), numpy's astype otherwise."""
    if isinstance(dtype, torch.dtype):
        return torch.from_numpy(x).to(dtype)
    return x.astype(dtype)


class PrefetchLoader:
    """Threaded batch loader (in place of the reference's DataLoader worker
    processes, train.py:513-519): `num_workers` threads assemble batches in
    order and keep up to `prefetch` of them ready.

    shard_id / num_shards: each process reads a disjoint, strided subset of
    the same per-epoch order (the reference's DistributedSampler,
    train.py:513-515); by default this process's rank and world size in an
    initialized torch.distributed group, else 0 of 1.

    transfer_dtype: cast era5 / SST in the worker threads, e.g.
    torch.bfloat16 (bf16 tensors; halves the host-to-device bytes, ~0.4%
    relative input error) or a numpy dtype."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 2, prefetch: int = 2, drop_last: bool = True,
                 shard_id: int | None = None, num_shards: int | None = None,
                 transfer_dtype=None):
        self.dataset = dataset
        self.transfer_dtype = transfer_dtype
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = drop_last
        if num_shards is None:
            shard_id, num_shards = _default_shard()
        self.shard_id = shard_id or 0
        self.num_shards = max(num_shards or 1, 1)

    def __len__(self):
        n = len(self.dataset) // self.num_shards
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _order(self, epoch: int) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            # the same permutation on every process (sampler.set_epoch,
            # train.py:303-304), then a strided disjoint subset each
            np.random.default_rng(self.seed + epoch).shuffle(idx)
        if self.num_shards > 1:
            per = len(idx) // self.num_shards
            idx = idx[self.shard_id::self.num_shards][:per]
        return idx

    def _make_batch(self, order: np.ndarray, b: int) -> Batch:
        # the last batch may be partial with drop_last=False
        idcs = [int(i) for i in order[b * self.batch_size:(b + 1) * self.batch_size]]
        if hasattr(self.dataset, "get_batch"):
            batch = self.dataset.get_batch(idcs)
        else:
            items = [self.dataset[i] for i in idcs]
            sst = None
            if items[0][1] is not None:
                sst = np.stack([it[1] for it in items], axis=1)
            batch = Batch(era5=np.stack([it[0] for it in items], axis=1), sst=sst,
                          times=np.stack([it[2] for it in items], axis=1))
        if self.transfer_dtype is not None:
            batch = Batch(era5=_cast(batch.era5, self.transfer_dtype),
                          sst=None if batch.sst is None else _cast(batch.sst, self.transfer_dtype),
                          times=batch.times)
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[Batch]:
        order = self._order(epoch)
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put_or_stop(item) -> bool:
            """A put that gives up once the consumer is gone: a plain put on
            a full queue would block for ever after an abandoned epoch (an
            islice'd validation loader abandons one every pass), keeping a
            thread and a whole batch alive."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(worker_id: int):
            for b in range(worker_id, nb, self.num_workers):
                if stop.is_set():
                    return
                try:
                    batch = self._make_batch(order, b)
                except Exception as e:  # hand it to the consumer, which
                    # would otherwise wait for this batch for ever
                    put_or_stop((-1, e))
                    return
                if not put_or_stop((b, batch)):
                    return

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            pending: dict[int, Batch] = {}
            nxt = received = 0
            while nxt < nb:
                while nxt not in pending and received < nb:
                    b, batch = q.get()
                    if b < 0:
                        raise RuntimeError("PrefetchLoader worker failed") from batch
                    pending[b] = batch
                    received += 1
                yield pending.pop(nxt)
                nxt += 1
        finally:
            stop.set()
            # workers blocked in put_or_stop see `stop` within its timeout;
            # join them, then drain so no batch stays pinned in the queue.
            # An abandoned generator finalized at interpreter exit may find
            # the threading internals torn down: only then are errors
            # swallowed
            try:
                for t in threads:
                    t.join(timeout=5.0)
                while not q.empty():
                    q.get_nowait()
            except Exception:
                if not sys.is_finalizing():
                    raise
