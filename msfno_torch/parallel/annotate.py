"""The active mesh and the model's explicit collectives (port of
msfno_tpu/parallel/annotate.py).

`use_mesh(mesh)` makes a mesh active for the model code inside the scope
(a contextvars.ContextVar, as in the JAX package), so the same modules run
on one device and over a mesh without a mesh threaded through them.  Where
the JAX package annotates layouts and lets GSPMD insert the collectives,
eager PyTorch has none: the functions below are the collectives GSPMD would
insert, each the identity without a mesh or when its axis has size 1, each
with its backward:

  sum_over_lat      all_reduce of spatial statistics; backward all_reduce;
  gather_channels   all_gather of channels; backward reduce-scatter (sum);
  gather_rows       all_gather of row bands, padding cut; backward
                    reduce-scatter (sum) of the padded rows;
  all_to_all        one all_to_all_single; backward the reverse one;
  shard_rows / local_channels  this rank's band / channels of a whole
                    tensor; backward zero-padding.

Gradient convention.  A value that several ranks hold alike (a gathered
tensor, a replicated parameter) carries on each rank the gradient of that
rank's own consumers only: its true gradient is the sum over the ranks
that hold it.  So a gather's backward sums (reduce-scatter), a slice's
backward zero-pads, and a replicated parameter's gradient is summed over
the model group (parallel/sharded_train.py).  A loss that every rank
computes alike is seeded on one rank only (`loss_seed`).

Only all_reduce, all_gather and all_to_all_single are used; they exist
for gloo and NCCL.  A CUDA tensor in a gloo group (several processes on
one card, where NCCL refuses two ranks a device) is staged through host
memory: the staging moves bytes and computes nothing.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist

from msfno_torch.parallel.mesh import ModelShard, local_slice, model_shard

_active_mesh = contextvars.ContextVar("msfno_torch_active_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    token = _active_mesh.set(mesh)
    try:
        yield
    finally:
        _active_mesh.reset(token)


def active_mesh():
    return _active_mesh.get()


def current_shard() -> ModelShard | None:
    """The active mesh's ModelShard, or None when no mesh is active or its
    lat and channel axes have size 1."""
    return model_shard(_active_mesh.get())


def loss_seed(loss: torch.Tensor) -> torch.Tensor:
    """The loss to differentiate on this rank: itself on the model group's
    first rank, times 0 elsewhere (every rank of the group computes the same
    loss from the gathered output; seeding it once counts it once)."""
    shard = current_shard()
    if shard is None:
        return loss
    return loss * (1.0 if shard.rank == 0 else 0.0)


# ------------------------------------------------------ raw collectives


def host_staged(t: torch.Tensor, group) -> bool:
    """True for a card tensor in a gloo group: its collective goes through
    a host copy."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def backend_note(group) -> str:
    """The backend a collective on a card tensor uses in `group`."""
    b = dist.get_backend(group)
    return "gloo (host-staged)" if b == "gloo" else b


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    if host_staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def gather_list(t: torch.Tensor, group) -> list[torch.Tensor]:
    """The group's tensors like `t`, in rank order (no gradient)."""
    n = dist.get_world_size(group)
    src = t.detach().contiguous()
    staged = host_staged(src, group)
    if staged:
        src = src.cpu()
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    return [o.to(t.device) for o in outs] if staged else outs


def _all_to_all(chunks: torch.Tensor, group) -> torch.Tensor:
    """(n, ...) -> (n, ...): chunk j goes to rank j; out[j] came from j."""
    src = chunks.detach().contiguous()
    staged = host_staged(src, group)
    if staged:
        src = src.cpu()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(chunks.device) if staged else out


def _reduce_scatter(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Sum over the group of `g`'s n chunks along `dim`, keeping this rank's
    chunk: an all_to_all and a sum in rank order."""
    n = dist.get_world_size(group)
    parts = _all_to_all(torch.stack(g.chunk(n, dim=dim)), group)
    out = parts[0].clone()
    for j in range(1, n):
        out += parts[j]
    return out


# ---------------------------------------------------- autograd wrappers


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.clone(), ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return torch.cat(gather_list(x, group), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, cat_dim, group):
        ctx.split_dim, ctx.cat_dim, ctx.group = split_dim, cat_dim, group
        return _exchange(x, split_dim, cat_dim, group)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.cat_dim, ctx.split_dim, ctx.group), None, None, None


def _exchange(x, split_dim, cat_dim, group):
    n = dist.get_world_size(group)
    out = _all_to_all(torch.stack(x.chunk(n, dim=split_dim)), group)
    return torch.cat(out.unbind(0), dim=cat_dim)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Sum of x over the group, on every rank; backward the same sum."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllReduce.apply(x, group)


def all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's x concatenated along `dim` in rank order; backward the
    reduce-scatter (sum) of the gradient."""
    if group is None or dist.get_world_size(group) == 1:
        return x
    return _AllGather.apply(x, dim % x.dim(), group)


def all_to_all(x: torch.Tensor, split_dim: int, cat_dim: int, group) -> torch.Tensor:
    """x's n chunks along split_dim go to the group's ranks in order; the
    chunks received are concatenated along cat_dim (jax.lax.all_to_all with
    tiled=True); backward the reverse exchange."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllToAll.apply(x, split_dim % x.dim(), cat_dim % x.dim(), group)


# ------------------------------------------------------ layout helpers


def sum_over_lat(x: torch.Tensor, shard: ModelShard | None = None) -> torch.Tensor:
    """Partial spatial sums of this rank's band, summed over the lat group."""
    shard = shard or current_shard()
    return x if shard is None else all_reduce_sum(x, shard.lat_group)


def gather_channels(x: torch.Tensor, dim: int = -1, shard: ModelShard | None = None):
    """The whole channel axis from this rank's share."""
    shard = shard or current_shard()
    return x if shard is None else all_gather(x, dim, shard.chan_group)


def local_channels(x: torch.Tensor, dim: int = -1, shard: ModelShard | None = None):
    """This rank's share of a whole channel axis (a replicated value's
    slice: its backward zero-pads)."""
    shard = shard or current_shard()
    if shard is None or shard.chan == 1:
        return x
    dim = dim % x.dim()
    c0, c1 = shard.channels(x.shape[dim])
    return x.narrow(dim, c0, c1 - c0)


def shard_rows(x: torch.Tensor, dim: int = -3, shard: ModelShard | None = None):
    """This rank's band of a whole grid (padded with zero rows to h_pad)."""
    shard = shard or current_shard()
    if shard is None or shard.lat == 1:
        return x
    spec = [None] * x.dim()
    spec[dim % x.dim()] = "lat"
    return local_slice(x, tuple(spec), shard)


def gather_rows(x: torch.Tensor, nlat: int, dim: int = -3, shard: ModelShard | None = None):
    """The whole nlat-row grid from this rank's band (padding cut)."""
    shard = shard or current_shard()
    if shard is None or shard.lat == 1:
        return x
    full = all_gather(x, dim, shard.lat_group)
    return full.narrow(dim % x.dim(), 0, nlat)


def real_rows(x: torch.Tensor, nlat: int, dim: int = -3, shard: ModelShard | None = None):
    """The band's real rows (its zero padding cut), for statistics."""
    shard = shard or current_shard()
    if shard is None or shard.lat == 1:
        return x
    return x.narrow(dim % x.dim(), 0, shard.band(nlat).n_real)


def local_view(t: torch.Tensor, row_dim: int | None = None, chan_dim: int | None = None,
               shard: ModelShard | None = None) -> torch.Tensor:
    """This rank's part of a whole tensor drawn alike on every rank (a
    dropout mask): its band along row_dim, its channels along chan_dim."""
    shard = shard or current_shard()
    if shard is None:
        return t
    spec = [None] * t.dim()
    if row_dim is not None:
        spec[row_dim % t.dim()] = "lat"
    if chan_dim is not None:
        spec[chan_dim % t.dim()] = "channel"
    return local_slice(t, tuple(spec), shard)
