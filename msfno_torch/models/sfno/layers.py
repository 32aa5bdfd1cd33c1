"""Spectral and pointwise layers of the SFNO (channels-last).

Port of msfno_tpu/models/sfno/layers.py.  Parameters keep the names and
shapes of the original MSFNO state_dict (what
msfno_tpu.models.convert.export_sfno_state_dict emits): 1x1 convolutions
store (out, in, 1, 1) weights, complex spectral weights are fp32 real pairs
with a trailing 2 (the linear filters' in the reference's (out, in, modes)
order), instance norms have (C,) and layer norms (H, W) weight/bias.  Activations are
(B, H, W, C) on the grid and (2, B, L, M, C) [re, im] in spectral space.

`use_pallas` (the JAX package's name) selects the hand-written kernel of
each layer; on a CPU tensor a kernel wrapper runs its plain version.

Dropout runs only when a forward is given a `torch.Generator` (`rng`, the
JAX package's `deterministic=False` with a "dropout" PRNG): a layer whose
dropout sits inside its kernel then takes its plain path, as the JAX layer
does.

Under a mesh whose lat or channel axis exceeds 1 (`parallel.annotate.
use_mesh`), each layer computes this rank's share: a latitude band of the
grid, an m-shard of the spectrum, a share of the embedding channels.  The
SHTs become the all_to_all sharded pair (`spectral_transforms`), the
statistics of the norms are summed over the lat group (real rows only),
and every channel-mixing product gathers its input channels and computes
its local output channels (column-parallel; the hidden layer of an MLP is
computed whole on each channel rank).  The kernels are off there, as the
JAX package gates them under a mesh; a parameter is used as the shard
`parallel.sharded_train.shard_state` left in it, or sliced from the whole
one.  Dropout draws the whole mask on every rank and keeps its part, so the
masks are those of one device.
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch
from torch import nn

from msfno_torch.ops.activations import complex_relu
from msfno_torch.ops.contractions import (
    compl_contract_dense,
    compl_contract_tril,
    compl_mul,
    contract_tt,
)
from msfno_torch.ops.kernels import grid_encoder_spectral as enc_kernel
from msfno_torch.ops.kernels import spectral_decoder as dec_kernel
from msfno_torch.ops.kernels.grid_mlp import grid_mlp, prepare_weights
from msfno_torch.ops.kernels.spectral_mlp import pack_weights, spectral_mlp
from msfno_torch.ops.sht import RealSHT
from msfno_torch.parallel.annotate import (
    active_mesh,
    current_shard,
    gather_channels,
    gather_rows,
    local_channels,
    local_view,
    real_rows,
    shard_rows,
    sum_over_lat,
)
from msfno_torch.parallel.sharded_train import local_param
from msfno_torch.runtime import DerivedCache, torch_dtype


class SpectralGridIn(typing.NamedTuple):
    """Marker for a block input whose longitude DFT already ran inside the
    fused encoder kernel (`grid_encoder_spectral`): `f` is the (B, H, 2M, C)
    stacked [re | im] mode array; the consuming filter runs the Legendre
    stage only (`RealSHT.legendre_stacked`)."""

    f: torch.Tensor


def trunc_normal_(t: torch.Tensor, gen: torch.Generator, std: float = 0.02):
    """Truncated normal with the reference's absolute cutoffs (+-2.0, i.e.
    +-100 sigma at std 0.02: effectively untruncated)."""
    with torch.no_grad():
        return nn.init.trunc_normal_(t, std=std, a=-2.0, b=2.0, generator=gen)


def new_param(shape, device, gen=None, init: str = "zeros", std: float = 0.02):
    """A parameter of `shape` on `device`: "zeros", "ones", "trunc_normal"
    (std) or "normal" (std times a standard normal)."""
    t = torch.empty(shape, device=device, dtype=torch.float32)
    with torch.no_grad():
        if init == "zeros":
            t.zero_()
        elif init == "ones":
            t.fill_(1.0)
        elif init == "trunc_normal":
            trunc_normal_(t, gen, std)
        elif init == "normal":
            t.normal_(0.0, std, generator=gen)
        else:
            raise ValueError(init)
    return nn.Parameter(t)


def dropout(x: torch.Tensor, rate: float, rng: torch.Generator, shape=None,
            view=None) -> torch.Tensor:
    """Inverted dropout (flax nn.Dropout): keep each element with
    probability 1 - rate, scaled by 1 / (1 - rate).  `shape` is the mask's
    (broadcast against x), by default x's; under a mesh it is the whole
    field's and `view` picks this rank's part of the mask."""
    keep = 1.0 - rate
    mask = torch.rand(x.shape if shape is None else shape, generator=rng,
                      device=x.device) < keep
    if view is not None:
        mask = view(mask)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def drop_path(x: torch.Tensor, rate: float, rng: torch.Generator) -> torch.Tensor:
    """Stochastic depth per sample (reference layers.py:88-118; JAX
    layers.py:455): the whole sample is kept or zeroed."""
    return dropout(x, rate, rng, (x.shape[0],) + (1,) * (x.dim() - 1))


def rows_of(x: torch.Tensor) -> int:
    return math.prod(x.shape[1:-1])


def spatial_stats(y: torch.Tensor):
    """(ssum, ssq, count) over the spatial axes of (B, ..., C), fp32: the
    instance-norm statistics contract (InstanceNorm `stats=`)."""
    y32 = y.float()
    axes = tuple(range(1, y.dim() - 1))
    return y32.sum(axes), (y32 * y32).sum(axes), rows_of(y)


class Conv1x1(nn.Module):
    """Parameters of a 1x1 convolution in the reference layout:
    weight (out, in, 1, 1), bias (out,).  `dense()` is the channels-last
    (in, out) view."""

    def __init__(self, c_in: int, c_out: int, bias: bool = True, device=None,
                 gen=None):
        super().__init__()
        self.weight = new_param((c_out, c_in, 1, 1), device, gen, "trunc_normal")
        if bias:
            self.bias = new_param((c_out,), device)
        else:
            self.register_parameter("bias", None)

    def dense(self) -> torch.Tensor:
        return self.weight[:, :, 0, 0].t()


def dense(x: torch.Tensor, conv: Conv1x1, dtype: torch.dtype, cols=None) -> torch.Tensor:
    """x @ W (+ b) with input, kernel and output in `dtype` (flax Dense with
    dtype=...); with `cols` = (start, stop) the output columns in that range
    only."""
    w, b = conv.dense(), conv.bias
    if cols is not None:
        w = w[:, cols[0]:cols[1]]
        b = None if b is None else b[cols[0]:cols[1]]
    y = x.to(dtype) @ w.to(dtype)
    if b is not None:
        y = y + b.to(dtype)
    return y


def _full_mask_shape(x: torch.Tensor, nlat: int, c: int) -> tuple:
    """The whole field's (B, nlat, W, c) mask shape of a band x."""
    return (x.shape[0], nlat, x.shape[-2], c)


class Mlp(nn.Module):
    """1x1-conv MLP (reference layers.py:145-178) as Dense -> GELU -> Dense
    over the channel axis.  `fwd.0` / `fwd.2` are the reference's names.

    `use_pallas` routes through the grid_mlp kernel: the hidden activation
    stays on chip, `pe` and `residual` ride the output write, and with
    `with_stats` the per-sample instance-norm statistics of the output come
    back as well.  With `spectral_cs` (W, 2M) the output goes straight
    through the forward longitude DFT instead (the grid_encoder_spectral
    kernel) and `(f, (ssum, ssq, H*W))` comes back.

    `drop_rate` drops the hidden and the output activations (before `pe`
    and `residual`) when a forward gets `rng`; the dropout sits between the
    kernel's two products, so that forward takes the plain path (JAX
    layers.py:203-219)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 output_bias: bool = True, dtype="float32", use_pallas: bool = False,
                 mxu_dtype: str = "bfloat16", out_dtype=None, with_stats: bool = False,
                 drop_rate: float = 0.0, nlat: int = 0, shard_out: bool = True,
                 device=None, gen=None):
        super().__init__()
        self.fwd = nn.ModuleDict({
            "0": Conv1x1(in_features, hidden_features, True, device, gen),
            "2": Conv1x1(hidden_features, out_features, output_bias, device, gen),
        })
        self.dtype = torch_dtype(dtype)
        self.out_dtype = torch_dtype(out_dtype) if out_dtype is not None else self.dtype
        self.use_pallas = use_pallas
        self.mxu_dtype = mxu_dtype
        self.with_stats = with_stats
        self.drop_rate = drop_rate
        # under a mesh: the grid's row count (whole dropout masks) and
        # whether the output is channel-sharded (the embedding) or whole
        self.nlat = nlat
        self.shard_out = shard_out
        self._cache = DerivedCache()

    def forward(self, x, pe=None, affine=None, residual=None, spectral_cs=None, rng=None):
        shard = current_shard()
        if shard is not None:
            return self._forward_sharded(x, pe, affine, residual, rng, shard)
        fc1, fc2 = self.fwd["0"], self.fwd["2"]
        dropping = self.drop_rate > 0.0 and rng is not None
        if spectral_cs is not None:
            if self.drop_rate > 0.0:
                raise ValueError("spectral_cs needs drop_rate == 0")
            return self._encode_spectral(x, pe, spectral_cs)
        if dropping and (affine is not None or residual is not None):
            raise ValueError("the folded affine and residual need drop_rate == 0")
        if self.use_pallas and not dropping:
            w1, w2 = fc1.dense(), fc2.dense()
            prepared = None
            if x.is_cuda:
                prepared = self._cache.get(
                    "weights", (fc1.weight, fc2.weight),
                    lambda: prepare_weights(w1, w2, x.shape[-1], self.mxu_dtype),
                )
            aff2d = None
            if affine is not None:
                aff2d = tuple(a.reshape(a.shape[0], a.shape[-1]) for a in affine)
            rows = rows_of(x)
            y = grid_mlp(
                x, w1, fc1.bias, w2, b2=fc2.bias, pe=pe,
                mxu_dtype=self.mxu_dtype, out_dtype=self.out_dtype,
                stats_rows=rows if self.with_stats else None,
                affine=aff2d, residual=residual, prepared=prepared,
            )
            if self.with_stats:
                y, ssum, ssq = y
                return y.to(self.out_dtype), (ssum, ssq, rows)
            return y.to(self.out_dtype)

        if affine is not None:
            a, b = affine
            x = x.float() * a.float() + b.float()
        h = torch.nn.functional.gelu(dense(x, fc1, self.dtype), approximate="none")
        if dropping:
            h = dropout(h, self.drop_rate, rng)
        y = dense(h, fc2, self.dtype)
        if dropping:
            y = dropout(y, self.drop_rate, rng)
        if pe is not None:
            y = y + pe.to(y.dtype)
        if residual is not None:
            y = y + residual.to(y.dtype)
        if self.with_stats:
            return y, spatial_stats(y)
        return y

    def _forward_sharded(self, x, pe, affine, residual, rng, shard):
        """This rank's share under a mesh: x a band of rows with its share
        of the channels (or all of them: the raw input), the input channels
        gathered, the hidden layer whole, this rank's output channels (all
        of them with shard_out False).  With with_stats the statistics are
        left to the norm: (y, None)."""
        fc1, fc2 = self.fwd["0"], self.fwd["2"]
        dropping = self.drop_rate > 0.0 and rng is not None
        if affine is not None:
            a, b = affine
            x = x.float() * a.float() + b.float()
        if x.shape[-1] != fc1.weight.shape[1]:
            x = gather_channels(x, shard=shard)
        h = torch.nn.functional.gelu(dense(x, fc1, self.dtype), approximate="none")
        if dropping:
            h = dropout(h, self.drop_rate, rng, _full_mask_shape(h, self.nlat, h.shape[-1]),
                        lambda m: local_view(m, row_dim=1, shard=shard))
        c_out = fc2.weight.shape[0]
        cols = shard.channels(c_out) if self.shard_out else None
        y = dense(h, fc2, self.dtype, cols)
        if dropping:
            y = dropout(y, self.drop_rate, rng, _full_mask_shape(y, self.nlat, c_out),
                        lambda m: local_view(m, row_dim=1, chan_dim=-1 if self.shard_out
                                             else None, shard=shard))
        if pe is not None:
            y = y + pe.to(y.dtype)
        if residual is not None:
            y = y + residual.to(y.dtype)
        return (y, None) if self.with_stats else y

    def _encode_spectral(self, x, pe, cs):
        """The fused encoder -> spectral head (JAX Mlp with spectral_cs):
        f (B, H, 2M, C) in the compute dtype and the statistics of the
        grid-space output, counted over its H*W rows."""
        fc1, fc2 = self.fwd["0"], self.fwd["2"]
        if not (self.use_pallas and self.with_stats and fc2.bias is None):
            raise ValueError("spectral_cs needs the kernel path, with_stats and no "
                             "output bias")
        w1, w2 = fc1.dense(), fc2.dense()
        prepared = None
        if x.is_cuda:
            prepared = self._cache.get(
                "spectral", (fc1.weight, fc2.weight, cs),
                lambda: enc_kernel.prepare(w1, w2, cs, self.mxu_dtype),
            )
        f, ssum, ssq = enc_kernel.grid_encoder_spectral(
            x, w1, fc1.bias, w2, pe, cs, mxu_dtype=self.mxu_dtype,
            out_dtype=self.dtype, prepared=prepared,
        )
        return f, (ssum, ssq, rows_of(x))


class BigSkipMlp(nn.Module):
    """Decoder MLP over concat(x, residual) without materializing the concat
    (the reference concatenates the input onto the features, big_skip,
    sfnonet.py:679-684).  `fwd.0.weight` is (hidden, in_main + skip, 1, 1):
    the same parameters as the reference's decoder on the concatenation.

    Given the tuple `(hm, a, b, mt)` of the last block's deferred inverse DFT
    (`FourierNeuralOperatorBlock` with `fuse_tail`), the inverse DFT, the
    norm + FiLM affine and both decoder layers run as the spectral_decoder
    kernel."""

    def __init__(self, hidden_features: int, out_features: int, in_main: int,
                 skip_features: int, output_bias: bool = False, dtype="float32",
                 use_pallas: bool = False, mxu_dtype: str = "bfloat16",
                 out_dtype=None, device=None, gen=None):
        super().__init__()
        self.fwd = nn.ModuleDict({
            "0": Conv1x1(in_main + skip_features, hidden_features, True, device, gen),
            "2": Conv1x1(hidden_features, out_features, output_bias, device, gen),
        })
        self.in_main = in_main
        self.dtype = torch_dtype(dtype)
        self.out_dtype = torch_dtype(out_dtype) if out_dtype is not None else self.dtype
        self.use_pallas = use_pallas
        self.mxu_dtype = mxu_dtype
        self._cache = DerivedCache()

    def forward(self, x, residual):
        fc1, fc2 = self.fwd["0"], self.fwd["2"]
        shard = current_shard()
        if shard is not None:
            # under a mesh: the channels gathered, the whole output on this
            # rank's band (the plain path below)
            x = gather_channels(x, shard=shard)
        elif isinstance(x, tuple):
            hm, a, b, mt = x
            w1, w2 = fc1.dense(), fc2.dense()
            prepared = None
            if hm.is_cuda:
                prepared = self._cache.get(
                    "spectral", (fc1.weight, fc2.weight, mt),
                    lambda: dec_kernel.prepare(w1, w2, mt, self.in_main, self.mxu_dtype),
                )
            return dec_kernel.spectral_decoder(
                hm, residual, mt, a, b, w1, fc1.bias, w2, fc2.bias,
                mxu_dtype=self.mxu_dtype, out_dtype=self.out_dtype, prepared=prepared,
            )
        if self.use_pallas and shard is None:
            w1, w2 = fc1.dense(), fc2.dense()
            prepared = None
            if x.is_cuda:
                prepared = self._cache.get(
                    "weights", (fc1.weight, fc2.weight),
                    lambda: prepare_weights(w1, w2, self.in_main, self.mxu_dtype),
                )
            y = grid_mlp(x, w1, fc1.bias, w2, b2=fc2.bias, skip=residual,
                         mxu_dtype=self.mxu_dtype, out_dtype=self.out_dtype,
                         prepared=prepared)
            return y.to(self.out_dtype)
        k = fc1.dense().to(self.dtype)
        h = (x.to(self.dtype) @ k[: self.in_main]
             + residual.to(self.dtype) @ k[self.in_main:]
             + fc1.bias.to(self.dtype))
        h = torch.nn.functional.gelu(h, approximate="none")
        return dense(h, fc2, self.dtype)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over the spatial axes
    (nn.InstanceNorm2d(affine=True), sfnonet.py:492-498), always in fp32.

    `return_affine=True` returns norm(x) = a*x + b as per-(B, C) (a, b), for
    folding into a downstream linear op.  `stats=(ssum, ssq, count)` takes
    precomputed spatial sums instead of reading x."""

    def __init__(self, c: int, eps: float = 1e-6, nlat: int = 0, device=None):
        super().__init__()
        self.weight = new_param((c,), device, init="ones")
        self.bias = new_param((c,), device)
        self.eps = eps
        self.nlat = nlat  # the grid's rows: under a mesh, x is a band of them

    def forward(self, x, return_affine: bool = False, stats=None):
        in_dtype = x.dtype
        c = x.shape[-1]
        shard = current_shard()
        if shard is not None and stats is None:
            # this band's real rows, summed over the lat group
            dims = (-3, -2)
            xr = real_rows(x, self.nlat, shard=shard)
            sums = torch.stack([xr.sum(dim=dims, keepdim=True, dtype=torch.float32),
                                (xr.float() * xr.float()).sum(dim=dims, keepdim=True)])
            sums = sum_over_lat(sums, shard) / (self.nlat * x.shape[-2])
            mean, mean_sq = sums[0], sums[1]
        elif stats is not None:
            ssum, ssq, count = stats
            shape = (x.shape[0],) + (1,) * (x.dim() - 2) + (c,)
            mean = (ssum.float() / count).reshape(shape)
            mean_sq = (ssq.float() / count).reshape(shape)
        else:
            # E[x^2] - E[x]^2, both sums accumulated in fp32 straight from x
            # (no fp32 copy of a full-resolution activation)
            dims = (-3, -2)
            count = x.shape[-3] * x.shape[-2]
            mean = x.mean(dim=dims, keepdim=True, dtype=torch.float32)
            norm = torch.linalg.vector_norm(x, 2, dim=dims, keepdim=True,
                                            dtype=torch.float32)
            mean_sq = norm * norm / count
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        inv = torch.rsqrt(var + self.eps)
        scale, bias = self.weight.float(), self.bias.float()
        if shard is not None:
            scale, bias = local_channels(scale, shard=shard), local_channels(bias, shard=shard)
        a, b = inv * scale, bias - mean * inv * scale
        if return_affine:
            return a, b
        # norm(x) = a*x + b per (sample, channel), in one pass over x
        return torch.addcmul(b, x, a).to(in_dtype)


class SpatialLayerNorm(nn.Module):
    """LayerNorm over the (H, W) axes per (sample, channel) with per-pixel
    affine parameters (nn.LayerNorm(normalized_shape=(H, W)),
    sfnonet.py:484-491), in fp32."""

    def __init__(self, spatial_shape, eps: float = 1e-6, device=None):
        super().__init__()
        self.weight = new_param(tuple(spatial_shape), device, init="ones")
        self.bias = new_param(tuple(spatial_shape), device)
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        shard = current_shard()
        weight, bias = self.weight, self.bias
        if shard is None:
            mean = x32.mean(dim=(-3, -2), keepdim=True)
            mean_sq = (x32 * x32).mean(dim=(-3, -2), keepdim=True)
        else:
            # this band's real rows, summed over the lat group; the affine's
            # rows are the band's
            h, w = weight.shape
            xr = real_rows(x32, h, shard=shard)
            sums = torch.stack([xr.sum(dim=(-3, -2), keepdim=True),
                                (xr * xr).sum(dim=(-3, -2), keepdim=True)])
            sums = sum_over_lat(sums, shard) / (h * w)
            mean, mean_sq = sums[0], sums[1]
            weight, bias = shard_rows(weight, 0, shard), shard_rows(bias, 0, shard)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        y = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (y * weight[..., None] + bias[..., None]).to(x.dtype)


class ComplexReLUBias(nn.Module):
    """Holder of the trained ComplexReLU bias of the modulus and halfplane
    modes, at the reference's `filter.activation.bias` (hidden, 1, 1)."""

    def __init__(self, hidden: int, device=None):
        super().__init__()
        self.bias = new_param((hidden, 1, 1), device)


class _GatheredRows:
    """A planar FFT under a lat axis > 1 (the JAX package has no sharded
    FFT): the band's rows gathered over the lat group, the plain forward
    transform on the whole grid, its whole spectrum on every lat rank."""

    def __init__(self, fwd, shard):
        self.t, self.shard = fwd, shard
        self.lmax, self.mmax = fwd.lmax, fwd.mmax

    def __call__(self, x):
        return self.t(gather_rows(x, self.t.nlat, shard=self.shard))


class _ScatteredRows:
    """The inverse of `_GatheredRows`: the plain inverse transform on the
    whole grid, then this rank's band of it."""

    def __init__(self, inv, shard):
        self.t, self.shard = inv, shard

    def __call__(self, y, out_dtype=torch.float32):
        return shard_rows(self.t(y, out_dtype=out_dtype), shard=self.shard)


def spectral_transforms(fwd, inv):
    """The transforms of a spectral filter under the active mesh (JAX
    layers.py:76-95): the SHTs become the all_to_all sharded pair under any
    mesh with lat or channel > 1 (with lat = 1 the exchange is the
    identity), planar FFTs gather their rows under lat > 1; without such a
    mesh the plain pair.  Built once per mesh."""
    shard = current_shard()
    if shard is None or (shard.lat == 1 and not isinstance(fwd, RealSHT)):
        return fwd, inv
    mesh = active_mesh()
    cache = mesh.__dict__.setdefault("_msfno_transforms", {})
    key = (id(fwd), id(inv))
    if key not in cache:
        if isinstance(fwd, RealSHT):
            from msfno_torch.parallel.sharded_sht import make_sharded_transforms

            cache[key] = make_sharded_transforms(fwd, inv, mesh, "lat")
        else:
            cache[key] = (_GatheredRows(fwd, shard), _ScatteredRows(inv, shard))
    return cache[key]


def local_orders(fwd) -> np.ndarray:
    """The orders m of a forward transform's mode positions on this rank
    (an m-shard's, in its layout; values >= mmax are padding)."""
    orders = getattr(fwd, "local_orders", None)
    return np.arange(fwd.mmax) if orders is None else orders


def _mode_mask_view(orders: np.ndarray, mmax: int):
    """A whole (B, L, mmax, C) spectral dropout mask -> this rank's mode
    positions (padded positions take any row: their modes are discarded)."""
    idx = torch.as_tensor(np.minimum(orders, mmax - 1))
    return lambda m: m.index_select(-2, idx.to(m.device))


class SpectralAttentionS2(nn.Module):
    """Non-linear spectral filter: complex MLP over the retained (l, m) modes
    (reference SpectralAttentionS2, layers.py:536-641; on the planar FFT too,
    as the JAX package builds it for spectral_transform="fft").
    `spectral_layers` complex layers C -> hidden, each followed by
    ComplexReLU(`complex_activation`), then the `wout` projection back to C;
    weights (in, out, 2) shared across modes.  The transforms and the MLP run
    in fp32 (operands rounded per `mxu_dtype`).  The spectral_mlp kernel runs
    under the JAX package's own gate: `use_pallas`, the "real" activation
    and no dropout in this forward (`drop_rate` drops the complex activation
    after each spectral layer, the same mask on re and im, reference
    layers.py:491,506; JAX layers.py:550)."""

    def __init__(self, forward_transform, inverse_transform, embed_dim: int,
                 hidden_size_factor: float = 2.0, complex_activation: str = "real",
                 spectral_layers: int = 1, scale: float = 0.02,
                 use_pallas: bool = False, mxu_dtype: str = "float32",
                 drop_rate: float = 0.0, device=None, gen=None):
        super().__init__()
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        hidden = int(hidden_size_factor * embed_dim)
        dims = [embed_dim] + [hidden] * spectral_layers
        self.w = nn.ParameterList([
            new_param((dims[i], dims[i + 1], 2), device, gen, "normal", scale)
            for i in range(spectral_layers)
        ])
        self.wout = new_param((hidden, embed_dim, 2), device, gen, "normal", scale)
        self.complex_activation = complex_activation
        # a trained bias in the modulus and halfplane modes only
        self.activation = (ComplexReLUBias(hidden, device)
                           if complex_activation in ("modulus", "halfplane") else None)
        self.use_kernel = use_pallas and complex_activation == "real"
        self.mxu_dtype = mxu_dtype
        self.drop_rate = drop_rate
        self._cache = DerivedCache()

    def weights(self) -> list[torch.Tensor]:
        return [*self.w, self.wout]

    def _mlp(self, z, rng=None, cols=None, mask=None):
        """The complex MLP without the kernel (the JAX package's compl_mul +
        complex_relu chain), with dropout when given `rng`.  Under a mesh:
        `cols` the output channels to compute and `mask` = (the whole mode
        count, the view of this rank's modes) of the dropout mask."""
        bias = None if self.activation is None else self.activation.bias.reshape(-1)
        for w in self.w:
            z = complex_relu(compl_mul(z, w, self.mxu_dtype), self.complex_activation,
                             bias=bias)
            if rng is not None:
                if mask is None:
                    z = dropout(z, self.drop_rate, rng, z.shape[1:])
                else:
                    shape = z.shape[1:-2] + (mask[0], z.shape[-1])
                    z = dropout(z, self.drop_rate, rng, shape, mask[1])
        wout = self.wout if cols is None else self.wout[:, cols[0]:cols[1]]
        return compl_mul(z, wout, self.mxu_dtype)

    def _forward_sharded(self, x, norm_affine, rng, shard):
        """This rank's share under a mesh: its band in, its m-shard of the
        spectrum (`spectral_transforms`), the channels gathered for the
        complex MLP, its output channels, its band out."""
        fwd, inv = spectral_transforms(self.forward_transform, self.inverse_transform)
        in_dtype = x.dtype
        z = fwd(x)
        orders = local_orders(fwd)
        if norm_affine is not None:
            a, b = norm_affine  # (B, 1, 1, C_local) fp32 each
            bsz, c = a.shape[0], a.shape[-1]
            z = z * a.reshape(1, bsz, 1, 1, c).float()
            if orders[0] == 0:  # only the rank holding m = 0 adds b * SHT(1)
                s0 = self.forward_transform._const("s0", z.device)
                z[0, :, :, 0, :] += b.reshape(bsz, 1, c).float() * s0.reshape(1, -1, 1)
        z = gather_channels(z, shard=shard)
        dropping = self.drop_rate > 0.0 and rng is not None
        mask = (fwd.mmax, _mode_mask_view(orders, fwd.mmax))
        z = self._mlp(z, rng if dropping else None, shard.channels(self.wout.shape[1]), mask)
        return inv(z, out_dtype=in_dtype)

    def forward(self, x, norm_affine=None, defer_inverse: bool = False, rng=None):
        shard = current_shard()
        if shard is not None:
            if defer_inverse or isinstance(x, SpectralGridIn):
                raise ValueError("the fused head and tail do not run under a mesh")
            return self._forward_sharded(x, norm_affine, rng, shard)
        if isinstance(x, SpectralGridIn):
            # the longitude DFT already ran inside the fused encoder kernel
            in_dtype = x.f.dtype
            z = self.forward_transform.legendre_stacked(x.f)
        else:
            in_dtype = x.dtype
            # the transform casts its matmul operands per its knob: no fp32 copy
            z = self.forward_transform(x)
        if norm_affine is not None:
            # SHT(a*x + b) = a*SHT(x) + b*SHT(1); the constant field only
            # excites the real m = 0 column, with profile s0 (lmax,)
            a, b = norm_affine  # (B, 1, 1, C) fp32 each
            bsz, c = a.shape[0], a.shape[-1]
            s0 = self.forward_transform._const("s0", z.device)
            z = z * a.reshape(1, bsz, 1, 1, c).float()
            z[0, :, :, 0, :] += b.reshape(bsz, 1, c).float() * s0.reshape(1, -1, 1)
        dropping = self.drop_rate > 0.0 and rng is not None
        if self.use_kernel and not dropping:
            ws = self.weights()
            packed = None
            if z.is_cuda:
                packed = self._cache.get("packed", ws,
                                         lambda: pack_weights(ws, self.mxu_dtype))
            z = spectral_mlp(z, ws, 0.0, self.mxu_dtype, packed=packed)
        else:
            z = self._mlp(z, rng if dropping else None)
        if defer_inverse:
            # fused tail: the fp32 Legendre-synthesis intermediate; the
            # spectral_decoder kernel runs the inverse DFT
            return self.inverse_transform.synthesis_hm(z)
        return self.inverse_transform(z, out_dtype=in_dtype)


class SpectralConvS2(nn.Module):
    """Linear spectral filter: per-mode channel mixing over the triangular
    l >= m modes (reference SpectralConvS2, layers.py:336-427), dense or
    tensor-train compressed (`compression="tt"`, rank `rank`).  Dense weight
    `w` (out, in, K, 2) in the reference's layout; tt factors `w.0` (C, R,
    2), `w.1` (R, C, R, 2), `w.2` (R, K, 2).  Modes with l < m stay zero."""

    def __init__(self, forward_transform, inverse_transform, embed_dim: int,
                 compression=None, rank: int = 128, scale: float = 0.02,
                 device=None, gen=None):
        super().__init__()
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        ii, jj = np.tril_indices(forward_transform.lmax, m=forward_transform.mmax)
        # the (l, m) index pairs of the modes, kept out of the state_dict
        self.register_buffer("tril_l", torch.as_tensor(ii, device=device), persistent=False)
        self.register_buffer("tril_m", torch.as_tensor(jj, device=device), persistent=False)
        k = len(ii)
        if compression == "tt":
            shapes = [(embed_dim, rank, 2), (rank, embed_dim, rank, 2), (rank, k, 2)]
            self.w = nn.ParameterList([new_param(s, device, gen, "normal", scale)
                                       for s in shapes])
        elif compression is None:
            self.w = new_param((embed_dim, embed_dim, k, 2), device, gen, "normal", scale)
        else:
            raise ValueError(f"unknown compression {compression!r}")
        self.compression = compression

    def forward(self, x):
        shard = current_shard()
        if shard is not None:
            return self._forward_sharded(x, shard)
        in_dtype = x.dtype
        z = self.forward_transform(x)  # (2, B, L, M, C)
        ii, jj = self.tril_l, self.tril_m
        zk = z[:, :, ii, jj, :]  # (2, B, K, C)
        if self.compression == "tt":
            yk = contract_tt(zk, *self.w)
        else:
            yk = compl_contract_tril(zk, self.w.permute(2, 1, 0, 3))  # (K, in, out, 2)
        y = z.new_zeros(z.shape[:-1] + (yk.shape[-1],))
        y[:, :, ii, jj, :] = yk
        return self.inverse_transform(y, out_dtype=in_dtype)

    def _forward_sharded(self, x, shard):
        """This rank's share under a mesh (JAX layers.py:606-620): the
        triangular modes of its m-shard, found through the shard's layout
        (`mode_inv`), the channels gathered, its output channels of the
        per-mode product (`w` sharded over them)."""
        fwd, inv = spectral_transforms(self.forward_transform, self.inverse_transform)
        z = gather_channels(fwd(x), shard=shard)  # (2, B, L, q, C)
        orders = local_orders(fwd)
        mmax = self.forward_transform.mmax
        pos_of = np.full(mmax, -1)
        real = orders < mmax
        pos_of[orders[real]] = np.nonzero(real)[0]
        ii, jj = self.tril_l.cpu().numpy(), self.tril_m.cpu().numpy()
        ks = np.nonzero(pos_of[jj] >= 0)[0]
        dev = z.device
        li = torch.as_tensor(ii[ks], device=dev)
        pj = torch.as_tensor(pos_of[jj[ks]], device=dev)
        kt = torch.as_tensor(ks, device=dev)
        zk = z[:, :, li, pj, :]  # (2, B, K_local, C)
        c0, c1 = shard.channels(z.shape[-1])
        if self.compression == "tt":
            g1, g2, g3 = self.w
            yk = contract_tt(zk, g1[c0:c1], g2, g3.index_select(1, kt))
        else:
            w = local_param(self.w, ("channel", None, None, None), shard)
            yk = compl_contract_tril(zk, w.permute(2, 1, 0, 3).index_select(0, kt))
        y = z.new_zeros(z.shape[:-1] + (c1 - c0,))
        y[:, :, li, pj, :] = yk
        return inv(y, out_dtype=x.dtype)


class SpectralConv2d(nn.Module):
    """Linear spectral filter on the planar FFT: per-mode dense mixing over
    the full (lmax, mmax) rectangle (reference SpectralConv2d,
    layers.py:253-333).  Weight `w` (out, in, L, M, 2), the reference's
    layout."""

    def __init__(self, forward_transform, inverse_transform, embed_dim: int,
                 scale=None, device=None, gen=None):
        super().__init__()
        self.forward_transform = forward_transform
        self.inverse_transform = inverse_transform
        scale = scale if scale is not None else 1.0 / embed_dim ** 2
        self.w = new_param((embed_dim, embed_dim, forward_transform.lmax,
                            forward_transform.mmax, 2), device, gen, "normal", scale)

    def forward(self, x):
        shard = current_shard()
        if shard is not None:
            # the whole spectrum on every lat rank (`spectral_transforms`),
            # the channels gathered, this rank's output channels
            fwd, inv = spectral_transforms(self.forward_transform, self.inverse_transform)
            z = gather_channels(fwd(x), shard=shard)
            w = local_channels(self.w, 0, shard)
            return inv(compl_contract_dense(z, w.permute(2, 3, 1, 0, 4)), out_dtype=x.dtype)
        z = self.forward_transform(x)
        y = compl_contract_dense(z, self.w.permute(2, 3, 1, 0, 4))  # (L, M, in, out, 2)
        return self.inverse_transform(y, out_dtype=x.dtype)


class SpectralFilterLayer(nn.Module):
    """Holder that gives the filter the reference's `filter_layer.filter`
    parameter path."""

    def __init__(self, filt: nn.Module):
        super().__init__()
        self.filter = filt

    def forward(self, x, **kw):
        return self.filter(x, **kw)
