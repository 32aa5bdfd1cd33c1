"""The device mesh, data axis only (port of msfno_tpu/parallel/mesh.py).

Axes, as in the JAX package:

  data    — the batch: one process per card, each holding its local batch
            (the reference's DDP, train.py:370-380);
  lat     — latitude bands / longitudinal orders m;
  channel — embedding channels.

The mesh is a `torch.distributed.device_mesh.DeviceMesh` over these three
axes.  Only the data axis is implemented: a mesh with lat or channel > 1,
or whose data size is not the world size, raises NotImplementedError (the
lat and channel axes are ROADMAP Queue 1 item 7), and every parameter is
replicated.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

AXES = ("data", "lat", "channel")
LATER = ("the lat and channel mesh axes are not ported yet (ROADMAP Queue 1 item 7); "
         "use a data-only mesh D,1,1")


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


def check_data_only(mesh) -> None:
    """Raise NotImplementedError for a mesh with lat or channel > 1."""
    sizes = mesh_sizes(mesh)
    if sizes.get("lat", 1) > 1 or sizes.get("channel", 1) > 1:
        raise NotImplementedError(f"mesh {sizes}: {LATER}")


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def data_mesh(n: int):
    """The (n, 1, 1) mesh of the first n ranks; every rank of the default
    group must call it (ranks >= n get a mesh they are not part of)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(_device_type(), torch.arange(n).reshape(n, 1, 1), mesh_dim_names=AXES)


def make_mesh(n_devices: int | None = None, shape: tuple[int, int, int] | None = None,
              data_target: int = 1):
    """The mesh over the initialised default group's ranks, on "cuda" (NCCL)
    or "cpu" (gloo).  `shape` defaults to `factorize(n, data_target)`.
    NotImplementedError for lat or channel > 1 and for a data size that is
    not the world size."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or (math.prod(shape) if shape else world)
    shape = tuple(shape or factorize(n, data_target=data_target))
    if len(shape) != 3 or math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    if shape[1] > 1 or shape[2] > 1:
        raise NotImplementedError(f"mesh shape {shape}: {LATER}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed group "
                           "(torchrun, or parallel.distributed.initialize_distributed)")
    if shape[0] != world:
        raise NotImplementedError(
            f"mesh shape {shape}: the data axis is one rank per process, so its size must be "
            f"the world size {world}")
    return data_mesh(shape[0])


def even_put(x, mesh, device, batch_dim: int = 1) -> torch.Tensor:
    """This process's local batch on `device` (the data-axis contract of the
    JAX package's even_put, mesh.py:144-192): each process holds its local
    portion and the global batch is local x data size, which the data axis
    splits evenly by construction; an empty local batch raises."""
    if not isinstance(x, torch.Tensor):
        import numpy as np

        x = torch.from_numpy(np.ascontiguousarray(x))
    if x.shape[batch_dim] == 0:
        raise ValueError(f"even_put: an empty local batch is no shard of the data axis "
                         f"({mesh_sizes(mesh)['data']} ranks)")
    return x.to(device)
