"""The device mesh and its layout rules (port of msfno_tpu/parallel/mesh.py).

Axes, as in the JAX package:

  data    — the batch: each data rank holds its local batch (the
            reference's DDP, train.py:370-380);
  lat     — latitude bands in grid space / longitudinal orders m in
            spectral space; the switch between the two is the sharded
            SHT's all_to_all (parallel/sharded_sht.py);
  channel — embedding channels.

The mesh is a `torch.distributed.device_mesh.DeviceMesh` over these three
axes, one rank per process, ranks laid out row-major over (data, lat,
channel) as the JAX package's `devices.reshape(shape)`.  The JAX package
annotates activations and lets GSPMD insert the collectives; here the
model code calls them itself (parallel/annotate.py), following the layout
rules below:

  grid activations (B, H, W, C):      batch over data, rows over lat,
                                      channels over channel;
  spectral activations (2, B, L, M, C): m over lat, channels over channel;
  the raw input and output (B, H, W, C_in): rows over lat, channels whole;
  parameters: `param_pspec`.

Rows that do not divide by the lat size (721 over 2 or 4) are padded: each
lat rank holds a band of h_pad / P rows, h_pad the row count rounded up to
a multiple of P, and the last band ends in zero rows (`RowBand`).  Every
statistic over rows counts only the band's `n_real` real rows.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

AXES = ("data", "lat", "channel")


def factorize(n: int, data_target: int = 1) -> tuple[int, int, int]:
    """Split n devices into (data, lat, channel) sizes (the JAX package's
    rule): prime factors go to the data axis first, up to data_target, then
    round-robin lat -> channel -> data."""
    factors = []
    m = n
    d = 2
    while m > 1:
        while m % d == 0:
            factors.append(d)
            m //= d
        d += 1 if d == 2 else 2
    sizes = {"lat": 1, "channel": 1, "data": 1}
    rest = []
    for f in sorted(factors, reverse=True):
        if sizes["data"] * f <= data_target:
            sizes["data"] *= f
        else:
            rest.append(f)
    order = ["lat", "channel", "data"]
    for i, f in enumerate(rest):
        sizes[order[i % 3]] *= f
    return (sizes["data"], sizes["lat"], sizes["channel"])


def mesh_sizes(mesh) -> dict[str, int]:
    """{"data": D, "lat": L, "channel": C} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_mesh(n: int):
    """The (n, 1, 1) mesh of the first n ranks; every rank of the default
    group must call it (ranks >= n get a mesh they are not part of)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(), torch.arange(n).reshape(n, 1, 1), mesh_dim_names=AXES)


def make_mesh(n_devices: int | None = None, shape: tuple[int, int, int] | None = None,
              data_target: int = 1):
    """The (data, lat, channel) mesh over the first n ranks of the
    initialised default group (n the world size by default; one rank per
    process), on "cuda" (NCCL) or "cpu" (gloo).  `shape` defaults to
    `factorize(n, data_target)`.  Every rank of the group must call it (it
    creates the axes' groups and the (lat, channel) "model" groups,
    `model_group`); ranks >= n get a mesh they are not part of."""
    from torch.distributed.device_mesh import DeviceMesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or (math.prod(shape) if shape else world)
    shape = tuple(shape or factorize(n, data_target=data_target))
    if len(shape) != 3 or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed group "
                           "(torchrun, or parallel.distributed.initialize_distributed)")
    if n > world:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, one per process; the world "
                         f"size is {world}")
    mesh = DeviceMesh(_device_type(), torch.arange(n).reshape(shape), mesh_dim_names=AXES)
    model_group(mesh)  # collective: every rank creates every model group now
    return mesh


def model_group(mesh):
    """The group of this rank's (lat, channel) sub-mesh: the ranks that
    share one data index and hold one replica of the model between them
    (made once, kept on the mesh)."""
    if "_msfno_model_group" not in mesh.__dict__:
        ranks = mesh.mesh.reshape(mesh.mesh.shape[0], -1)
        mine = None
        for row in ranks.tolist():
            g = dist.new_group(row)  # every rank calls new_group for every row
            if dist.get_rank() in row:
                mine = g
        mesh._msfno_model_group = mine
    return mesh._msfno_model_group


@dataclasses.dataclass(frozen=True)
class RowBand:
    """One lat rank's band of an nlat-row grid: rows [start, start + hb) of
    the grid padded to h_pad rows, of which the first n_real are real."""

    nlat: int
    h_pad: int
    hb: int
    start: int
    n_real: int


def row_band(nlat: int, p: int, rank: int) -> RowBand:
    h_pad = -(-nlat // p) * p
    hb = h_pad // p
    start = rank * hb
    return RowBand(nlat, h_pad, hb, start, max(0, min(hb, nlat - start)))


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """This rank's place in the (lat, channel) sub-mesh of a mesh: the axis
    sizes, its coordinates and the groups the model's collectives run on."""

    lat: int
    chan: int
    lat_rank: int
    chan_rank: int
    lat_group: object
    chan_group: object
    group: object  # the (lat, channel) model group

    @property
    def rank(self) -> int:
        """This rank's index in the model group (row-major lat, channel)."""
        return self.lat_rank * self.chan + self.chan_rank

    def band(self, nlat: int) -> RowBand:
        return row_band(nlat, self.lat, self.lat_rank)

    def channels(self, c: int) -> tuple[int, int]:
        """[start, stop) of this rank's share of c channels."""
        if c % self.chan:
            raise ValueError(f"{c} channels do not divide over the channel axis of "
                             f"size {self.chan}")
        k = c // self.chan
        return self.chan_rank * k, (self.chan_rank + 1) * k


def model_shard(mesh) -> ModelShard | None:
    """The ModelShard of `mesh` (made once, kept on the mesh), or None when
    lat = channel = 1 (the model then runs as on one device, data-parallel
    at most)."""
    if mesh is None:
        return None
    if "_msfno_shard" not in mesh.__dict__:
        sizes = mesh_sizes(mesh)
        lat, chan = sizes["lat"], sizes["channel"]
        mesh._msfno_shard = None if lat * chan == 1 else ModelShard(
            lat=lat, chan=chan, lat_rank=mesh.get_local_rank("lat"),
            chan_rank=mesh.get_local_rank("channel"), lat_group=mesh.get_group("lat"),
            chan_group=mesh.get_group("channel"), group=model_group(mesh))
    return mesh._msfno_shard


# ------------------------------------------------------ partition specs
# A spec names the mesh axis of each dimension (None: whole), in the
# port's layouts.


def param_pspec(name: str, value: torch.Tensor) -> tuple | None:
    """Parameter sharding rules (the JAX package's, in this package's
    layouts): the pos_embed (1, C, H, W), ~1 GB at full size, over (lat,
    channel); the SpectralConvS2 weight `w` (C_out, C_in, K, 2) over its
    output channels; None (replicated) for everything else."""
    if name.endswith("pos_embed"):
        return (None, "channel", "lat", None)
    if name.endswith("filter.w") and value.dim() == 4:
        return ("channel", None, None, None)
    return None


def local_slice(t: torch.Tensor, spec: tuple, shard: ModelShard) -> torch.Tensor:
    """This rank's shard of a whole tensor `t` under `spec` (lat dims as
    padded row bands, channel dims as even chunks); a view where it can be."""
    for dim, axis in enumerate(spec):
        if axis == "lat":
            band = shard.band(t.shape[dim])
            if band.h_pad != t.shape[dim]:
                pad = [0, 0] * (t.dim() - dim - 1) + [0, band.h_pad - t.shape[dim]]
                t = torch.nn.functional.pad(t, pad)
            t = t.narrow(dim, band.start, band.hb)
        elif axis == "channel":
            c0, c1 = shard.channels(t.shape[dim])
            t = t.narrow(dim, c0, c1 - c0)
    return t


def even_put(x, mesh, device, batch_dim: int = 1) -> torch.Tensor:
    """This process's local batch on `device` (the data-axis contract of the
    JAX package's even_put, mesh.py:144-192): each data rank holds its local
    portion, whole over lat and channel (the model takes its band itself),
    and the global batch is local x data size; an empty local batch
    raises."""
    if not isinstance(x, torch.Tensor):
        import numpy as np

        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.shape[batch_dim] == 0:
        raise ValueError(f"even_put: an empty local batch is no shard of the data axis "
                         f"({mesh_sizes(mesh)['data']} ranks)")
    return x.to(device)
