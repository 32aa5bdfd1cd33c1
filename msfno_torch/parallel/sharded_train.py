"""Data-parallel training over the mesh's data axis (port of
msfno_tpu/parallel/sharded_train.py; the reference's DDP,
train.py:370-380).

Every rank holds the whole model.  `shard_state` makes the replicas equal
by broadcasting rank 0's tensors; after each rank's backward the trainable
gradients are all-reduced over the data group as one flat fp32 buffer
per dtype (DDP's bucket, without overlap), so the optimizer steps
identically on every rank.  The reduction gives the gradient of the global
batch (local x world samples), as the JAX package's SPMD step takes it: a
sum for a loss that sums over samples, a mean for one that averages
(`losses.sums_over_samples`).  `torch.nn.parallel.DistributedDataParallel`
does not fit: the
Trainer takes gradients with `torch.autograd.grad`, and DDP's reducer
hooks fire only on `.backward()`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from msfno_torch.parallel.mesh import check_data_only, even_put


def data_group(mesh):
    check_data_only(mesh)
    return mesh.get_group("data")


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    return []


def _by_dtype(tensors: list[torch.Tensor]) -> list[list[torch.Tensor]]:
    groups: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return list(groups.values())


@torch.no_grad()
def _flat_collective(tensors: list[torch.Tensor], collective, cast=None) -> None:
    """Run `collective` on one flat buffer per dtype of `tensors` (cast to
    `cast` if given) and copy the result back into them in place."""
    for ts in _by_dtype(tensors):
        buf = torch.cat([t.detach().reshape(-1) for t in ts])
        if cast is not None:
            buf = buf.to(cast)
        collective(buf)
        off = 0
        for t in ts:
            t.copy_(buf[off:off + t.numel()].view(t.shape))
            off += t.numel()


def broadcast_tensors(tensors: list[torch.Tensor], group) -> None:
    """Overwrite `tensors` in place with group rank 0's, bit for bit."""
    src = dist.get_global_rank(group, 0)
    _flat_collective(tensors, lambda buf: dist.broadcast(buf, src=src, group=group))


def shard_state(state, mesh):
    """Make every rank's TrainState tensors rank 0's, bit for bit: the
    trainable and frozen parameters and the optimizer state's moments.  The
    JAX package assumes same-seed replicas (sharded_train.py:21-30); this
    makes them equal.  The counts and the film scale come from the same
    config and checkpoint on every rank.  Returns the state, updated in
    place."""
    tensors = [state.trainable[k] for k in sorted(state.trainable)]
    tensors += [state.frozen[k] for k in sorted(state.frozen)]
    broadcast_tensors(tensors + _tensors(state.opt_state), data_group(mesh))
    return state


def all_reduce(tensors: list[torch.Tensor], group, mean: bool = False) -> None:
    """Sum `tensors` over the group in place, in fp32, or average them with
    `mean`."""
    n = dist.get_world_size(group)

    def reduce(buf):
        dist.all_reduce(buf, group=group)
        if mean:
            buf.div_(n)

    _flat_collective(tensors, reduce, cast=torch.float32)


def make_sharded_train_step(trainer, mesh):
    """(step_fn, place_batch) for callers outside the CLI, the JAX
    package's meaning: place_batch(era5, sst=None) puts this process's
    local batch (S, B_local, ...) on the trainer's device, and
    step_fn(state, era5, sst) is one data-parallel optimizer step over the
    global batch.  The trainer must have been built with this mesh."""
    if trainer.mesh is not mesh:
        raise ValueError("make_sharded_train_step: build the Trainer with mesh=<this mesh>")

    def place_batch(era5, sst=None):
        return (even_put(era5, mesh, trainer.device),
                None if sst is None else even_put(sst, mesh, trainer.device))

    return trainer._train_step, place_batch
