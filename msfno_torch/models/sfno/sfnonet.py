"""Full SFNO networks (port of msfno_tpu/models/sfno/sfnonet.py; reference
MSFNO/Models/sfno/sfnonet.py:406-912).

FourierNeuralOperatorNet: encoder MLP -> +pos_embed -> num_layers spectral
blocks (resolution drops `scale_factor`-fold inside block 0 and returns in the
last block) -> big-skip decoder MLP.  FourierNeuralOperatorNetFilmed adds a
FiLM generator over SST history whose (gamma, beta) modulate the trailing
`film_layers` blocks.

On the kernel path with `fuse_encoder_dft` the encoder emits block 0's
longitude modes directly (grid_encoder_spectral kernel, `SpectralGridIn`),
and with `fuse_decoder_tail` the last block's inverse DFT, its norm1 + FiLM
and the decoder run as one kernel (spectral_decoder): neither full-width
grid field of the head or the tail is stored.

Every spectral configuration of the JAX package's SFNOConfig runs: the SHT
or the planar FFT, the non-linear filter (any ComplexReLU mode) or the
linear one (dense, or tensor-train on the SHT), instance or layer norm.

Layout: channels-last (B, H, W, C) on the grid.  Parameter names and shapes
are the original MSFNO state_dict's.  The nets run on CUDA unless built with
`device="cpu"`; weights are random, drawn from a `torch.Generator` seeded
with `seed` (load real ones with `load_state_dict`).  A forward given a
`torch.Generator` as `rng` trains: dropout (`drop_rate`) and drop-path
(`drop_path_rate`, rising linearly over the blocks from 0) act, and the
kernels that JAX bypasses under dropout take their plain paths.

Under a mesh with lat or channel > 1 (`parallel.annotate.use_mesh`) a
forward still takes and returns whole fields: each rank takes its band of
the input's rows, computes its band and channels through the blocks (the
pos_embed as its (lat, channel) shard, the encoder writing its channels,
the decoder gathering them for its 256 -> 73 product on its band, the big
skip from its band of the input) and the output's bands are gathered over
the lat group.  The block kernels and the fused head and tail are off
there, as the JAX package gates them under a mesh; the FiLM generator sees
the same SST on every rank and keeps its gcn_layer kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from msfno_torch.config import SFNOConfig
from msfno_torch.models.sfno.blocks import FourierNeuralOperatorBlock
from msfno_torch.models.sfno.layers import BigSkipMlp, Mlp, SpectralGridIn, new_param
from msfno_torch.ops.fft import InverseRealFFT2, RealFFT2
from msfno_torch.ops.sht import InverseRealSHT, RealSHT
from msfno_torch.parallel.annotate import current_shard, gather_rows, shard_rows
from msfno_torch.parallel.mesh import param_pspec
from msfno_torch.parallel.sharded_train import local_param
from msfno_torch.runtime import DerivedCache, resolve_device, torch_dtype
from msfno_torch.utils.observability import span


def build_transforms(cfg: SFNOConfig):
    """(trans_down, itrans_up, trans, itrans) (sfnonet.py:532-569): full grid
    -> spectral, spectral -> full grid, and the internal grid pair; SHTs on
    the equiangular / Gauss grids, or planar FFTs."""
    nlat, nlon = cfg.img_size
    lmax, mmax = cfg.modes_lat, cfg.modes_lon
    if cfg.spectral_transform == "sht":
        kw = dict(lmax=lmax, mmax=mmax, spectral_rescale=cfg.spectral_rescale,
                  mxu_dtype=cfg.sht_mxu_dtype)
        return (
            RealSHT(nlat, nlon, grid="equiangular", **kw),
            InverseRealSHT(nlat, nlon, grid="equiangular", **kw),
            RealSHT(cfg.h, cfg.w, grid="legendre-gauss", **kw),
            InverseRealSHT(cfg.h, cfg.w, grid="legendre-gauss", **kw),
        )
    if cfg.spectral_transform == "fft":
        return (
            RealFFT2(nlat, nlon, lmax=lmax, mmax=mmax),
            InverseRealFFT2(nlat, nlon, lmax=lmax, mmax=mmax),
            RealFFT2(cfg.h, cfg.w, lmax=lmax, mmax=mmax),
            InverseRealFFT2(cfg.h, cfg.w, lmax=lmax, mmax=mmax),
        )
    raise ValueError(f"unknown spectral transform {cfg.spectral_transform!r}")


def _block_kwargs(cfg: SFNOConfig, i: int, transforms) -> dict:
    """Per-block wiring truth table (sfnonet.py:573-614)."""
    trans_down, itrans_up, trans, itrans = transforms
    first, last = i == 0, i == cfg.num_layers - 1
    inner = 0 < i < cfg.num_layers - 1
    dpr = np.linspace(0, cfg.drop_path_rate, cfg.num_layers)
    return dict(
        forward_transform=trans_down if first else trans,
        inverse_transform=itrans_up if last else itrans,
        embed_dim=cfg.embed_dim,
        filter_type=cfg.filter_type,
        spectral_transform=cfg.spectral_transform,
        mlp_ratio=cfg.mlp_ratio,
        drop_rate=cfg.drop_rate,
        drop_path_rate=float(dpr[i]),
        norm_kind=cfg.normalization_layer,
        input_shape=cfg.img_size if first else (cfg.h, cfg.w),
        output_shape=cfg.img_size if last else (cfg.h, cfg.w),
        inner_skip="linear" if inner else None,
        outer_skip="identity" if inner else None,
        use_mlp=not last,
        complex_activation=cfg.complex_activation,
        spectral_layers=cfg.spectral_layers,
        compression=cfg.compression,
        rank=cfg.rank,
        use_pallas=cfg.use_pallas,
        mxu_dtype=cfg.spectral_mxu_dtype,
        pallas_grid_mlp=cfg.pallas_grid_mlp,
        grid_mlp_mxu_dtype=cfg.grid_mlp_mxu_dtype,
        fuse_norm=cfg.fuse_norm_sht,
        fuse_mlp_affine=cfg.fuse_inner_mlp and not cfg.checkpointing_mlp,
        dtype=cfg.compute_dtype,
    )


def _encoder_fusible(cfg: SFNOConfig) -> bool:
    """The JAX gate of the fused encoder->spectral kernel
    (grid_encoder_spectral); its `active_mesh() is None` term is read at
    each forward."""
    return (cfg.fuse_encoder_dft and cfg.pallas_grid_mlp
            and cfg.filter_type == "non-linear" and cfg.spectral_transform == "sht"
            and cfg.normalization_layer == "instance_norm" and cfg.fuse_norm_sht
            and not cfg.checkpointing_encoder)


def _tail_fusible(cfg: SFNOConfig) -> bool:
    """The JAX gate of the fused spectral->output decoder tail
    (spectral_decoder); its `active_mesh() is None` term is read at each
    forward."""
    return (cfg.fuse_decoder_tail and cfg.pallas_grid_mlp and cfg.big_skip
            and cfg.filter_type == "non-linear" and cfg.spectral_transform == "sht"
            and cfg.normalization_layer == "instance_norm" and cfg.fuse_norm_sht
            and cfg.drop_path_rate == 0.0)


def _want_stats(cfg: SFNOConfig) -> bool:
    """The JAX gate of the encoder's instance-norm statistics: block 0's
    norm0 folds into the non-linear filter's forward SHT."""
    return (cfg.fuse_norm_sht and cfg.normalization_layer == "instance_norm"
            and cfg.filter_type == "non-linear" and cfg.spectral_transform == "sht")


class FourierNeuralOperatorNet(nn.Module):
    """SFNO (reference FourierNeuralOperatorNet, sfnonet.py:406-686)."""

    filmed = False

    def __init__(self, cfg: SFNOConfig, device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.device = device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        self._build(cfg, device, gen)

    def _build(self, cfg: SFNOConfig, device, gen) -> None:
        self.transforms = build_transforms(cfg)
        dtype = torch_dtype(cfg.compute_dtype)
        self.dtype = dtype
        self.out_dtype = torch_dtype(cfg.output_dtype)
        self.want_stats = _want_stats(cfg)
        self.encoder = Mlp(
            cfg.in_chans, cfg.embed_dim, cfg.embed_dim, output_bias=False,
            dtype=dtype, use_pallas=cfg.pallas_grid_mlp,
            mxu_dtype=cfg.grid_mlp_mxu_dtype, with_stats=self.want_stats,
            nlat=cfg.img_size[0], device=device, gen=gen,
        )
        if cfg.pos_embed:
            h, w = cfg.img_size
            self.pos_embed = new_param((1, cfg.embed_dim, h, w), device, gen,
                                       "trunc_normal")
        else:
            self.register_parameter("pos_embed", None)
        n_film = cfg.film.film_layers if self.filmed else 0
        repeat = self.filmed and cfg.film.repeat_film
        trans_down = self.transforms[0]
        self.fuse_dft = (_encoder_fusible(cfg) and isinstance(trans_down, RealSHT)
                         and trans_down.lon_dft == "matmul"
                         and trans_down.mmax <= trans_down.nlon // 2 + 1)
        fuse_tail = _tail_fusible(cfg)
        self.blocks = nn.ModuleList([
            FourierNeuralOperatorBlock(
                **_block_kwargs(cfg, i, self.transforms),
                filmed=bool(n_film) and (repeat or i >= cfg.num_layers - n_film),
                fuse_tail=fuse_tail and i == cfg.num_layers - 1,
                device=device, gen=gen,
            )
            for i in range(cfg.num_layers)
        ])
        if cfg.big_skip:
            self.decoder = BigSkipMlp(
                cfg.embed_dim, cfg.out_chans, cfg.embed_dim, cfg.in_chans,
                dtype=dtype, use_pallas=cfg.pallas_grid_mlp,
                mxu_dtype=cfg.grid_mlp_mxu_dtype, out_dtype=self.out_dtype,
                device=device, gen=gen,
            )
        else:
            self.decoder = Mlp(
                cfg.embed_dim, cfg.embed_dim, cfg.out_chans, output_bias=False,
                dtype=dtype, use_pallas=cfg.pallas_grid_mlp,
                mxu_dtype=cfg.grid_mlp_mxu_dtype, out_dtype=self.out_dtype,
                nlat=cfg.img_size[0], shard_out=False, device=device, gen=gen,
            )
        self._cache = DerivedCache()

    def _pos_embed(self, x):
        """pos_embed channels-last (H, W, C) in the compute dtype; cached for
        the kernel path (1.06 GB in fp32 at full resolution) unless it is
        being trained."""
        if self.pos_embed is None:
            return None
        shard = current_shard()
        if shard is not None:  # this rank's (lat, channel) shard
            pe = local_param(self.pos_embed, param_pspec("pos_embed", self.pos_embed), shard)
            return pe[0].permute(1, 2, 0).to(self.dtype)
        build = lambda: self.pos_embed[0].permute(1, 2, 0).to(self.dtype).contiguous()
        trained = torch.is_grad_enabled() and self.pos_embed.requires_grad
        if x.is_cuda and self.cfg.pallas_grid_mlp and not trained:
            return self._cache.get("pe", (self.pos_embed,), build)
        return self.pos_embed[0].permute(1, 2, 0).to(self.dtype)

    def _encode(self, x):
        """(block 0's input, its norm0 statistics or None): a SpectralGridIn
        of the longitude modes when the fused head engages."""
        if self.fuse_dft and current_shard() is None:
            cs = self.transforms[0]._const("merged", x.device)
            f, stats = self.encoder(x, pe=self._pos_embed(x), spectral_cs=cs)
            return SpectralGridIn(f), stats
        out = self.encoder(x, pe=self._pos_embed(x))
        return out if self.want_stats else (out, None)

    def _decode(self, x, residual):
        """The decoder; `x` is (hm, a, b) when the last block ran its fused
        tail, and the whole tail then runs as one kernel."""
        if isinstance(x, tuple):
            hm, a, b = x
            x = (hm, a, b, self.transforms[1]._const("merged_t", hm.device))
        if self.cfg.big_skip:
            y = self.decoder(x, residual)
        else:
            y = self.decoder(x)
        return y.to(self.out_dtype)

    def _run_blocks(self, x, stats, gamma=None, beta=None, scale=1.0, rng=None, device=None):
        """The blocks, each in a `net.block` span on `device` (a tensor on
        the net's device)."""
        cfg = self.cfg
        n_film = cfg.film.film_layers if self.filmed else 0
        for i, blk in enumerate(self.blocks):
            s_i = stats if i == 0 else None
            with span("net.block", device, i):
                if blk.filmed:
                    idx = (min(i, n_film - 1) if cfg.film.repeat_film
                           else i - (cfg.num_layers - n_film))
                    x = blk(x, gamma[:, idx], beta[:, idx], scale, s_i, rng=rng)
                else:
                    x = blk(x, None, None, 1.0, s_i, rng=rng)
        return x

    def _forward(self, x, gamma=None, beta=None, scale=1.0, rng=None):
        shard = current_shard()
        nlat = x.shape[-3]
        if shard is not None:
            x = shard_rows(x, shard=shard)
        residual = x
        with span("net.encoder", residual):
            x, stats = self._encode(x)
        x = self._run_blocks(x, stats, gamma, beta, scale, rng, device=residual)
        with span("net.decoder", residual):
            y = self._decode(x, residual)
        return y if shard is None else gather_rows(y, nlat, shard=shard)

    def forward(self, x, rng=None):
        return self._forward(x, rng=rng)


class FourierNeuralOperatorNetFilmed(FourierNeuralOperatorNet):
    """MSFNO: SFNO with FiLM conditioning on SST history (reference
    FourierNeuralOperatorNet_Filmed, sfnonet.py:699-860)."""

    filmed = True

    def _build(self, cfg: SFNOConfig, device, gen) -> None:
        from msfno_torch.models.film.wrapper import FilmWrapper

        if cfg.film is None:
            raise ValueError("SFNOConfig.film must be set for the filmed net")
        self.film_gen = FilmWrapper(cfg.film, device=device, gen=gen)
        super()._build(cfg, device, gen)

    def forward(self, x, sst, scale=1.0, rng=None):
        film_mod = self.film_gen(sst, rng=rng)  # (B, 2, film_layers, C)
        return self._forward(x, film_mod[:, 0], film_mod[:, 1], scale, rng)
