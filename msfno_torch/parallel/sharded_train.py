"""Training over the (data, lat, channel) mesh (port of
msfno_tpu/parallel/sharded_train.py; the reference's DDP,
train.py:370-380).

`shard_state` makes every rank's state rank 0's, bit for bit, and places
each parameter by `mesh.param_pspec`: the pos_embed keeps its (lat,
channel) shard and the SpectralConvS2 weight its output-channel shard, the
optimizer's moments of a parameter the same shard, everything else whole.
A sharded tensor carries its spec (`_mesh_spec`), its whole shape and its
ModelShard, so that `gather_whole` can rebuild it for a checkpoint.

Gradients (`reduce_gradients`).  Each rank of a (lat, channel) model group
computes only its share of the activations, so a replicated parameter's
gradient is partial on each rank and is summed over the model group; a
sharded parameter's gradient is summed over the model axes it is not
sharded on.  Then, over the data group, all gradients are summed for a
loss that sums over samples and averaged for one that averages
(`losses.sums_over_samples`), as the JAX package's SPMD step takes the
global batch's.  Collectives run on one flat fp32 buffer per group (DDP's
bucket, without overlap).  `torch.nn.parallel.DistributedDataParallel`
does not fit: the Trainer takes gradients with `torch.autograd.grad`, and
DDP's reducer hooks fire only on `.backward()`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from msfno_torch.parallel.annotate import gather_list, host_staged
from msfno_torch.parallel.mesh import even_put, local_slice, model_shard, param_pspec

MODEL_AXES = ("lat", "channel")


def data_group(mesh):
    return mesh.get_group("data")


def held_spec(t) -> tuple | None:
    """The spec of a tensor that holds its mesh shard, else None."""
    return getattr(t, "_mesh_spec", None)


def _mark(t: torch.Tensor, spec, whole_shape, shard) -> None:
    t._mesh_spec, t._mesh_whole, t._mesh_shard = spec, tuple(whole_shape), shard


def _unmark(t: torch.Tensor) -> None:
    for a in ("_mesh_spec", "_mesh_whole", "_mesh_shard"):
        t.__dict__.pop(a, None)


@torch.no_grad()
def gather_whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a held shard, on every rank of its model group
    (a collective there); a whole tensor as it is."""
    spec = held_spec(t)
    if spec is None:
        return t.detach()
    shard, whole = t._mesh_shard, t._mesh_whole
    out = t.detach()
    for dim, axis in enumerate(spec):
        if axis in MODEL_AXES:
            group = shard.lat_group if axis == "lat" else shard.chan_group
            out = torch.cat(gather_list(out, group), dim=dim).narrow(dim, 0, whole[dim])
    return out.clone()  # its own storage: a checkpoint stores exactly these bytes


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
def _flat_collective(tensors: list[torch.Tensor], collective, group, cast=None) -> None:
    """Run `collective` on one flat buffer per dtype of `tensors` (cast to
    `cast` if given; a card buffer of a gloo group staged through host
    memory) and copy the result back into them in place."""
    for ts in _by_dtype(tensors):
        buf = torch.cat([t.detach().reshape(-1) for t in ts])
        if cast is not None:
            buf = buf.to(cast)
        host = buf.cpu() if host_staged(buf, group) else buf
        collective(host)
        if host is not buf:
            buf.copy_(host)
        off = 0
        for t in ts:
            t.copy_(buf[off:off + t.numel()].view(t.shape))
            off += t.numel()


def broadcast_tensors(tensors: list[torch.Tensor], group=None) -> None:
    """Overwrite `tensors` in place with group rank 0's, bit for bit."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    _flat_collective(tensors, lambda buf: dist.broadcast(buf, src=src, group=group), group)


def all_reduce(tensors: list[torch.Tensor], group, mean: bool = False) -> None:
    """Sum `tensors` over the group in place, in fp32, or average them with
    `mean`."""
    n = dist.get_world_size(group)

    def reduce(buf):
        dist.all_reduce(buf, group=group)
        if mean:
            buf.div_(n)

    _flat_collective(tensors, reduce, group, cast=torch.float32)


def _moment_dicts(opt_state, names: set) -> list[dict]:
    """The optimizer state's dicts that mirror the trainable parameters
    (adam mu / nu, the momentum trace, the accumulated gradient)."""
    out = []
    if isinstance(opt_state, dict):
        if set(opt_state) == names and names:
            return [opt_state]
        for k in sorted(opt_state):
            out += _moment_dicts(opt_state[k], names)
    return out


def place(t: torch.Tensor, spec, shard) -> torch.Tensor:
    """`t` (whole) as this rank keeps it: its shard (marked) under a spec
    and a model mesh, else itself (unmarked)."""
    if spec is None or shard is None:
        _unmark(t)
        return t
    local = local_slice(t, spec, shard).contiguous().clone()
    _mark(local, spec, t.shape, shard)
    return local


def shard_state(state, mesh):
    """Make every rank's TrainState rank 0's, bit for bit, and keep each
    parameter and its optimizer moments as `param_pspec` places them on
    `mesh` (whole tensors first gathered back from any earlier placement).
    The JAX package assumes same-seed replicas (sharded_train.py:21-30);
    this makes them equal.  The counts and the film scale come from the
    same config and checkpoint on every rank.  Returns the state, updated
    in place (the model's Parameter objects keep their identity)."""
    shard = model_shard(mesh)
    params = {**state.frozen, **state.trainable}
    moments = _moment_dicts(state.opt_state, set(state.trainable))
    entries = [(n, params, n) for n in sorted(params)]
    entries += [(n, d, n) for d in moments for n in sorted(d)]
    wholes = [gather_whole(d[k]) for _, d, k in entries]
    seen = {id(d[k]) for _, d, k in entries}
    rest = [t for t in _tensors(state.opt_state) if id(t) not in seen]
    broadcast_tensors(wholes + rest)
    with torch.no_grad():
        for (name, d, key), whole in zip(entries, wholes):
            kept = place(whole, param_pspec(name, whole), shard)
            if d is params:
                p = params[key]
                p.data = kept
                if held_spec(kept) is not None:
                    _mark(p, kept._mesh_spec, kept._mesh_whole, shard)
                else:
                    _unmark(p)
            else:
                d[key] = kept
    return state


def whole_state(state) -> tuple[dict, dict]:
    """(params, optimizer state) with every held shard gathered whole, on
    every rank (a collective over the model groups): what a checkpoint
    stores, the file an unsharded run writes."""
    params = {n: gather_whole(p) for n, p in sorted(state.params.items())}
    names = set(state.trainable)

    def walk(node):
        if isinstance(node, dict):
            if set(node) == names and names:
                return {k: gather_whole(node[k]) for k in sorted(node)}
            return {k: walk(v) for k, v in node.items()}
        return node

    return params, walk(state.opt_state)


def local_param(p: torch.Tensor, spec: tuple, shard) -> torch.Tensor:
    """This rank's shard of a parameter sharded by `spec`: itself when it
    holds it, else its slice of the whole parameter (a model used under a
    mesh without `shard_state`)."""
    return p if held_spec(p) is not None else local_slice(p, spec, shard)


def local_of(whole: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The part of a whole tensor that `like` holds: its shard, or all."""
    spec = held_spec(like)
    return whole if spec is None else local_slice(whole, spec, like._mesh_shard)


def reslice_moments(state) -> None:
    """Cut the optimizer moments (whole, as a checkpoint holds them) to the
    shards their parameters hold."""
    for d in _moment_dicts(state.opt_state, set(state.trainable)):
        for n, p in state.trainable.items():
            spec = held_spec(p)
            if spec is not None and held_spec(d[n]) is None:
                d[n] = place(d[n], spec, p._mesh_shard)


def _reduce_axes(p) -> tuple[str, ...]:
    spec = held_spec(p) or ()
    return tuple(a for a in MODEL_AXES if a not in spec)


def _axes_group(shard, axes: tuple[str, ...]):
    if axes == MODEL_AXES:
        return shard.group
    if axes == ("lat",):
        return shard.lat_group
    if axes == ("channel",):
        return shard.chan_group
    return None


def reduce_gradients(grads: dict, params: dict, mesh, extra: list[torch.Tensor],
                     mean: bool) -> None:
    """In place: each gradient summed over the model axes its parameter is
    not sharded on, then every gradient and the `extra` tensors (the
    losses, alike on a model group) summed or averaged over the data
    group."""
    shard = model_shard(mesh)
    if shard is not None:
        buckets: dict[tuple, list] = {}
        for n in sorted(grads):
            buckets.setdefault(_reduce_axes(params[n]), []).append(grads[n])
        for axes, gs in sorted(buckets.items()):
            group = _axes_group(shard, axes)
            if group is not None:
                all_reduce(gs, group)
    all_reduce([grads[n] for n in sorted(grads)] + extra, data_group(mesh), mean=mean)


def grad_norm(grads: dict, params: dict, mesh=None) -> torch.Tensor:
    """The global gradient norm: a sharded parameter's squares summed over
    the axes it is sharded on."""
    shard = model_shard(mesh)
    total = sum((g.float() ** 2).sum() for n, g in grads.items()
                if shard is None or held_spec(params[n]) is None)
    if shard is not None:
        for axes in (("lat", "channel"), ("channel",), ("lat",)):
            part = [g for n, g in grads.items() if held_spec(params[n]) is not None
                    and tuple(a for a in MODEL_AXES if a in held_spec(params[n])) == axes]
            if part:
                sq = torch.stack([sum((g.float() ** 2).sum() for g in part)])
                all_reduce([sq], _axes_group(shard, axes))
                total = total + sq[0]
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def make_sharded_train_step(trainer, mesh):
    """(step_fn, place_batch) for callers outside the CLI, the JAX
    package's meaning: place_batch(era5, sst=None) puts this process's
    local batch (S, B_local, ...) on the trainer's device, and
    step_fn(state, era5, sst) is one optimizer step over the global batch.
    The trainer must have been built with this mesh."""
    if trainer.mesh is not mesh:
        raise ValueError("make_sharded_train_step: build the Trainer with mesh=<this mesh>")

    def place_batch(era5, sst=None):
        return (even_put(era5, mesh, trainer.device),
                None if sst is None else even_put(sst, mesh, trainer.device))

    return trainer._train_step, place_batch
