"""SFNO blocks and FiLM modulation (port of msfno_tpu/models/sfno/blocks.py).

Block wiring (reference sfnonet.py:573-614):
  - block 0:       no skips, transforms change resolution down
  - blocks 1..N-2: inner_skip = 1x1 linear, outer_skip = identity
  - block N-1:     no skips, no channel MLP, resolution back up
  - filter "linear": GELU after the inner skip
  - norms: norm0 at the block's input resolution, norm1 at its output
Filmed block (sfnonet.py:254-393): FiLM between norm1 and the channel MLP.
Fused head and tail: block 0 may take a `SpectralGridIn` (the encoder kernel
already ran the longitude DFT), and with `fuse_tail` the last block stops
before its inverse DFT and hands (hm, a, b) to the spectral_decoder kernel.
Under a mesh with lat or channel > 1 (`parallel.annotate.use_mesh`) a block
computes this rank's band and channels: FiLM's gamma / beta and the norms'
affines are sliced to its channels, the inner skip gathers the channels,
and the fused tail is off (its operands would be shards).
"""

from __future__ import annotations

import torch
from torch import nn

from msfno_torch.models.sfno.layers import (
    Conv1x1,
    InstanceNorm,
    Mlp,
    SpatialLayerNorm,
    SpectralAttentionS2,
    SpectralConv2d,
    SpectralConvS2,
    SpectralFilterLayer,
    SpectralGridIn,
    dense,
    drop_path,
)
from msfno_torch.ops.kernels.spectral_decoder import spectral_grid_stats
from msfno_torch.parallel.annotate import current_shard, gather_channels, local_channels
from msfno_torch.runtime import torch_dtype


def film_modulation(x, gamma, beta, scale):
    """FiLM: ((1 + gamma*scale) * x) + beta*scale (reference FiLM module,
    sfnonet.py:689-697).  gamma/beta are (B, C); x is (B, H, W, C)."""
    g = gamma[:, None, None, :].to(x.dtype)
    b = beta[:, None, None, :].to(x.dtype)
    return (1.0 + g * scale) * x + b * scale


def make_norm(kind: str, c: int, spatial_shape, device=None):
    if kind == "instance_norm":
        return InstanceNorm(c, nlat=spatial_shape[0], device=device)
    if kind == "layer_norm":
        return SpatialLayerNorm(spatial_shape, device=device)
    raise NotImplementedError(f"normalization {kind!r} not implemented")


def make_filter(filter_type: str, spectral_transform: str, forward_transform,
                inverse_transform, embed_dim: int, mlp_ratio: float,
                complex_activation: str, spectral_layers: int, compression=None,
                rank: int = 128, use_pallas: bool = False, mxu_dtype: str = "float32",
                drop_rate: float = 0.0, device=None, gen=None):
    """SpectralFilterLayer mux (reference sfnonet.py:60-133): the spectral
    MLP on the SHT or, without the kernel as in the JAX package, on the
    planar FFT; the linear filter on either."""
    if filter_type == "non-linear" and spectral_transform in ("sht", "fft"):
        return SpectralAttentionS2(
            forward_transform, inverse_transform, embed_dim,
            hidden_size_factor=mlp_ratio, complex_activation=complex_activation,
            spectral_layers=spectral_layers,
            use_pallas=use_pallas and spectral_transform == "sht",
            mxu_dtype=mxu_dtype, drop_rate=drop_rate, device=device, gen=gen,
        )
    if filter_type == "linear" and spectral_transform == "sht":
        return SpectralConvS2(forward_transform, inverse_transform, embed_dim,
                              compression=compression, rank=rank, device=device, gen=gen)
    if filter_type == "linear" and spectral_transform == "fft":
        return SpectralConv2d(forward_transform, inverse_transform, embed_dim,
                              device=device, gen=gen)
    raise NotImplementedError(f"filter {filter_type}/{spectral_transform}")


class FourierNeuralOperatorBlock(nn.Module):
    """One SFNO block, optionally FiLM-modulated (`filmed`: forward takes
    gamma, beta and scale; reference FourierNeuralOperatorBlock_Filmed,
    sfnonet.py:357-393).  `input_shape` / `output_shape` are the (H, W) of
    norm0 / norm1 (the layer norm's parameter shapes).

    `fuse_tail` (the last block only, set by the net): return (hm, a, b),
    the Legendre-synthesis intermediate and the norm1 + FiLM affine folded
    per (sample, channel), for the fused decoder.  The net guarantees the
    non-linear SHT filter, instance norm, no skips and no channel MLP.

    `drop_rate` is the filter's and the channel MLP's dropout,
    `drop_path_rate` the block's stochastic depth; both act only in a
    forward given `rng` (training).  With either set, the norm1 affine is
    not folded into the MLP kernel (the JAX gate, blocks.py:248)."""

    def __init__(self, forward_transform, inverse_transform, embed_dim: int,
                 filter_type: str = "non-linear", spectral_transform: str = "sht",
                 mlp_ratio: float = 2.0, drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, norm_kind: str = "instance_norm",
                 input_shape=(0, 0), output_shape=(0, 0),
                 inner_skip=None, outer_skip=None, use_mlp: bool = True,
                 complex_activation: str = "real", spectral_layers: int = 1,
                 compression=None, rank: int = 128, use_pallas: bool = False,
                 mxu_dtype: str = "float32", pallas_grid_mlp: bool = False,
                 grid_mlp_mxu_dtype: str = "bfloat16", fuse_norm: bool = True,
                 fuse_mlp_affine: bool = False, filmed: bool = False,
                 fuse_tail: bool = False, dtype="float32", device=None, gen=None):
        super().__init__()
        if outer_skip not in (None, "identity") or inner_skip not in (None, "linear"):
            raise NotImplementedError(
                f"skips inner={inner_skip!r} outer={outer_skip!r} are not ported"
            )
        self.norm0 = make_norm(norm_kind, embed_dim, input_shape, device)
        self.filter_layer = SpectralFilterLayer(make_filter(
            filter_type, spectral_transform, forward_transform, inverse_transform,
            embed_dim, mlp_ratio, complex_activation, spectral_layers,
            compression, rank, use_pallas, mxu_dtype, drop_rate, device, gen,
        ))
        self.inner_skip = (
            Conv1x1(embed_dim, embed_dim, True, device, gen)
            if inner_skip == "linear" else None
        )
        self.norm1 = make_norm(norm_kind, embed_dim, output_shape, device)
        self.mlp = (
            Mlp(embed_dim, int(embed_dim * mlp_ratio), embed_dim, dtype=dtype,
                use_pallas=pallas_grid_mlp, mxu_dtype=grid_mlp_mxu_dtype,
                drop_rate=drop_rate, nlat=output_shape[0], device=device, gen=gen)
            if use_mlp else None
        )
        self.outer_skip = outer_skip
        self.instance_norm = norm_kind == "instance_norm"
        # the JAX package's gates: norm0 folds into the non-linear filter's
        # forward SHT, norm1 (+ FiLM) into the channel-MLP kernel, only with
        # instance norm
        self.fuse_norm = (fuse_norm and self.instance_norm and filter_type == "non-linear"
                          and spectral_transform == "sht")
        self.fuse_mlp_affine = (fuse_mlp_affine and self.instance_norm and drop_rate == 0.0
                                and drop_path_rate == 0.0)
        self.drop_path_rate = drop_path_rate
        self.linear_filter = filter_type == "linear"
        self.filmed = filmed
        self.dtype = torch_dtype(dtype)
        if fuse_tail and (inner_skip or outer_skip or use_mlp or not self.fuse_norm
                          or drop_path_rate != 0.0):
            raise ValueError("fuse_tail set on an incompatible block configuration")
        self.fuse_tail = fuse_tail

    def forward(self, x, gamma=None, beta=None, scale=1.0, norm0_stats=None, rng=None):
        shard = current_shard()
        if self.fuse_tail and shard is None:
            return self._fused_tail(x, gamma, beta, scale, norm0_stats, rng)
        if shard is not None and self.filmed:
            gamma, beta = local_channels(gamma, shard=shard), local_channels(beta, shard=shard)
        residual = x
        spectral_in = isinstance(x, SpectralGridIn)
        if spectral_in and not (self.fuse_norm and norm0_stats is not None
                                and self.inner_skip is None and self.outer_skip is None):
            raise ValueError("SpectralGridIn on an incompatible block configuration")
        # only the non-linear filter has dropout
        drop_kw = {} if self.linear_filter else {"rng": rng}
        if self.fuse_norm:
            # fold norm0 into the filter's forward SHT: the normalized field
            # is never materialized; with a SpectralGridIn the statistics
            # come from the encoder kernel
            a, b = self.norm0(x.f if spectral_in else x, True, norm0_stats)
            x = self.filter_layer(x, norm_affine=(a, b), **drop_kw)
        elif self.instance_norm:
            x = self.filter_layer(self.norm0(x, stats=norm0_stats), **drop_kw)
        else:
            x = self.filter_layer(self.norm0(x), **drop_kw)

        if self.inner_skip is not None:
            if shard is None:
                x = x + dense(residual, self.inner_skip, self.dtype)
            else:
                skip_in = gather_channels(residual, shard=shard)
                x = x + dense(skip_in, self.inner_skip, self.dtype,
                              shard.channels(skip_in.shape[-1]))
        if self.linear_filter:
            x = torch.nn.functional.gelu(x, approximate="none")

        if self.fuse_mlp_affine and self.mlp is not None:
            # norm1(x) == a*x + b per (B, C); FiLM folds in on top, and the
            # affine and the outer skip run inside the grid_mlp kernel
            a, b = self.norm1(x, True)
            if self.filmed:
                g = 1.0 + gamma[:, None, None, :].to(a.dtype) * scale
                a, b = g * a, g * b + beta[:, None, None, :].to(a.dtype) * scale
            return self.mlp(
                x, affine=(a, b),
                residual=residual if self.outer_skip == "identity" else None,
            )

        x = self.norm1(x)
        if self.filmed:
            x = film_modulation(x, gamma, beta, scale)
        if self.mlp is not None:
            x = self.mlp(x, rng=rng)
        if self.drop_path_rate > 0.0 and rng is not None:
            x = drop_path(x, self.drop_path_rate, rng)
        if self.outer_skip == "identity":
            x = x + residual
        return x

    def _fused_tail(self, x, gamma, beta, scale, norm0_stats, rng=None):
        """Last-block body for the fused decoder tail: the standard path up to
        and including the norm1 + FiLM affine, with the inverse DFT deferred
        and the affine returned folded, (hm, a, b) with a, b (B, C) fp32."""
        a0, b0 = self.norm0(x, True, norm0_stats)
        hm = self.filter_layer(x, norm_affine=(a0, b0), defer_inverse=True, rng=rng)
        itrans = self.filter_layer.filter.inverse_transform
        mean, mean_sq = spectral_grid_stats(hm, itrans._const("omega", hm.device))
        # the spectral identities yield means: the stats contract's count is 1
        a1, b1 = self.norm1(hm, True, (mean, mean_sq, 1.0))
        a1, b1 = a1[:, 0, 0, :], b1[:, 0, 0, :]
        if self.filmed:
            # film_modulation(norm(x)) = (1 + gamma*s) * (a1*x + b1) + beta*s
            g = 1.0 + gamma.float() * scale
            return hm, a1 * g, b1 * g + beta.float() * scale
        return hm, a1, b1
