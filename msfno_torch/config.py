"""Typed configuration, field for field the JAX package's
(msfno_tpu/utils/config.py): same dataclasses, defaults and JSON form, so one
JSON string drives both packages.  Frozen dataclasses; `to_json` /
`from_json` round-trip checkpoint metadata (reference main.py:179-246).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


def _asdict(cfg) -> dict[str, Any]:
    d = dataclasses.asdict(cfg)
    d["__config__"] = type(cfg).__name__
    return d


_REGISTRY: dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.__name__] = cls
    return cls


def to_json(cfg) -> str:
    return json.dumps(_asdict(cfg), sort_keys=True)


def from_json(s: str):
    d = json.loads(s)
    name = d.pop("__config__")
    cls = _REGISTRY[name]
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for k, v in d.items():
        if k not in field_names:
            continue
        # nested configs lose their __config__ tag in dataclasses.asdict, so
        # the film field is rehydrated by name
        if isinstance(v, dict) and "__config__" in v:
            v = from_json(json.dumps(v))
        elif isinstance(v, dict) and k == "film":
            v = from_json(json.dumps({**v, "__config__": "FilmConfig"}))
        elif isinstance(v, list):
            v = tuple(v)
        kwargs[k] = v
    return cls(**kwargs)


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@register
@dataclasses.dataclass(frozen=True)
class FilmConfig:
    """FiLM generator configuration (reference "Architecture Film Gen" argparse
    group, main.py:1053-1137; Film_wrapper, sfnonet.py:863-912)."""

    film_gen_type: str = "gcn_custom"  # gcn | gcn_custom | transformer | mae | none
    film_layers: int = 1  # number of trailing filmed SFNO blocks
    repeat_film: bool = False  # film every block with shared (gamma, beta)
    model_depth: int = 6  # generator depth (gcn residual stack / vit blocks)
    embed_dim: int = 512  # generator hidden width
    mlp_dim: int = 512
    temporal_step: int = 28  # SST history length (days)
    coarse_level: int = 4  # SST coarsening factor: 721x1440 -> 180x360
    sst_shape: tuple[int, int] = (180, 360)
    patch_size: tuple[int, int, int] = (28, 9, 9)  # (t, h, w) for vit/mae
    nan_mask_threshold: float = 0.5
    dropout: float = 0.0
    num_film_features: int = 256  # = embed_dim_sfno of the backbone
    scale_weight: float = 1.0  # mae film-head init scaling
    compute_dtype: str = "float32"  # generator compute dtype (head stays fp32)
    # hand-written gcn_layer kernel for the gcn/gcn_custom generators
    # (ops/kernels/gcn_layer.py)
    pallas_gcn: bool = True
    # mae generator: feed precomputed encoder cls tokens (B, embed_dim)
    # directly to the film head
    cls_input: bool = False


@register
@dataclasses.dataclass(frozen=True)
class SFNOConfig:
    """SFNO architecture config (reference FourierNeuralOperatorNet defaults,
    MSFNO/Models/sfno/sfnonet.py:406-441).  The kernel switches keep the JAX
    package's names (use_pallas, pallas_grid_mlp, pallas_gcn) so one JSON
    string drives both packages; in this package they select the
    hand-written CUDA kernels."""

    img_size: tuple[int, int] = (721, 1440)
    scale_factor: int = 6
    in_chans: int = 73
    out_chans: int = 73
    embed_dim: int = 256
    num_layers: int = 12
    spectral_transform: str = "sht"  # sht | fft
    filter_type: str = "non-linear"  # non-linear | linear
    mlp_ratio: float = 2.0
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    normalization_layer: str = "instance_norm"  # instance_norm | layer_norm
    hard_thresholding_fraction: float = 1.0
    big_skip: bool = True
    compression: str | None = None  # None | "tt"
    rank: int = 128
    complex_activation: str = "real"
    spectral_layers: int = 3
    pos_embed: bool = True
    spectral_rescale: float = 1e5  # sfnonet.py:550-555 gradient-conditioning trick
    checkpointing_mlp: bool = False
    # fold each block's instance-norm into its forward SHT (exact linear
    # rewrite; skips materializing the normalized field at full resolution)
    fuse_norm_sht: bool = True
    checkpointing_block: bool = False
    checkpointing_encoder: bool = False
    checkpointing_decoder: bool = False
    # compute dtype for grid-space MLPs; SHT + spectral MLP stay fp32
    compute_dtype: str = "float32"  # "float32" | "bfloat16"
    use_pallas: bool = False  # spectral_mlp kernel
    pallas_grid_mlp: bool = False  # grid_mlp kernel for encoder/decoder/inner MLPs
    # matmul operand dtype inside the grid-MLP kernel (fp32 accumulation)
    grid_mlp_mxu_dtype: str = "bfloat16"
    # fused spectral->output decoder tail (spectral_decoder kernel; engages
    # with pallas_grid_mlp)
    fuse_decoder_tail: bool = True
    # fused encoder->spectral head (grid_encoder_spectral kernel; same gate)
    fuse_encoder_dft: bool = True
    # fold each inner block's norm1 + FiLM into the channel-MLP kernel as a
    # per-sample channel affine, and the outer identity skip into its output
    fuse_inner_mlp: bool = False
    # dtype of the model OUTPUT field (and the autoregressive carry)
    output_dtype: str = "float32"
    # matmul operand dtype inside the spectral-MLP kernel (fp32 accumulation)
    spectral_mxu_dtype: str = "float32"
    # matmul operand dtype for the SHT's DFT/Legendre matmuls
    sht_mxu_dtype: str = "float32"
    film: FilmConfig | None = None

    @property
    def h(self) -> int:
        return self.img_size[0] // self.scale_factor

    @property
    def w(self) -> int:
        return self.img_size[1] // self.scale_factor

    @property
    def modes_lat(self) -> int:
        return int(self.h * self.hard_thresholding_fraction)

    @property
    def modes_lon(self) -> int:
        return int((self.w // 2 + 1) * self.hard_thresholding_fraction)


@register
@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training configuration (reference "Training" argparse group,
    main.py:640-944; Trainer, MSFNO/Models/train.py:35-1337), field for field
    the JAX package's."""

    batch_size: int = 1
    learning_rate: float = 5e-4
    optimizer: str = "adam"  # adam | adamw | sgd
    weight_decay: float = 0.0
    scheduler: str = "none"  # none | cosine | step
    scheduler_horizon: int = 2000
    loss_fn: str = "L2Sphere_noSine"  # default per main.py:874
    multi_step_training: int = 0  # extra autoregressive steps in the loss
    training_step_skip: int = 0  # skip factor between supervised steps
    discount_factor: float = 1.0  # per-step loss discount
    accumulation_steps: int = 0  # gradient accumulation (mean over acc + 1)
    validation_interval: int = 100
    validation_step_skip: int = 0
    multi_step_validation: int = 0
    save_checkpoint_interval: int = 1
    training_epochs: int = 1
    film_scale_start: float = 0.0  # FiLM scale ramp: +0.002 per validation
    film_scale_step: float = 0.002  # (train.py:638-641)
    retrain_film: bool = False  # unfreeze decoder + last blocks too
    seed: int = 42
    time_limit_s: float | None = None  # graceful stop (train.py:821-828)
    # optimizer steps per chunk of `Trainer.train_steps`; the host loop's
    # cadence (validation, checkpoints, logs) is the same for every value
    scan_steps: int = 1
    # "npz" or "orbax" in the JAX package; this package writes its own
    # torch.save format whatever the value (orbax directories raise)
    checkpoint_backend: str = "npz"
    async_checkpoint: bool = False
    advanced_logging: bool = False
    # store the frozen backbone in bf16 (serving tier only); trainable
    # (film) parameters stay fp32
    bf16_frozen_params: bool = False


def tiny_sfno(film: bool = False) -> SFNOConfig:
    """Small config for tests (2 blocks, embed 64, 128x256 Gaussian grid).

    Kept identical to the JAX package's, including its film config's
    num_film_features=256 default, which does not match embed_dim=64: a
    filmed net needs an explicit FilmConfig(num_film_features=embed_dim)."""
    return SFNOConfig(
        img_size=(128, 256),
        scale_factor=2,
        in_chans=8,
        out_chans=8,
        embed_dim=64,
        num_layers=2,
        spectral_layers=2,
        film=FilmConfig(model_depth=2, embed_dim=64, mlp_dim=64, sst_shape=(32, 64))
        if film
        else None,
    )


def serving_config(**overrides) -> SFNOConfig:
    """The serving tier this package runs through its kernels: the JAX
    package's fast tier (`__graft_entry__._flagship_cfg(fast=True)`) with
    `checkpointing_block=False` (a training-only rematerialization switch):
    the full 721x1440x73 filmed net, bf16 activations and matmul operands,
    the spectral_mlp / grid_mlp / gcn_layer kernels and the fused head and
    tail (grid_encoder_spectral, spectral_decoder).
    `serving_config(fuse_encoder_dft=False, fuse_decoder_tail=False)` is the
    same tier with the head and tail unfused."""
    cfg = SFNOConfig(
        film=FilmConfig(film_gen_type="gcn_custom", compute_dtype="bfloat16"),
        compute_dtype="bfloat16",
        use_pallas=True,
        pallas_grid_mlp=True,
        spectral_mxu_dtype="bfloat16",
        sht_mxu_dtype="bfloat16",
    )
    return dataclasses.replace(cfg, **overrides)


def balanced_config(**overrides) -> SFNOConfig:
    """The JAX package's balanced tier (`__graft_entry__._flagship_cfg(
    balanced=True)`) with `checkpointing_block=False`, as in
    `serving_config`: fp32 activations, one-pass bf16 matmuls in the
    spectral filter and the SHT, no spectral or grid-MLP kernel, and the
    FiLM generator at its defaults (`pallas_gcn=True` on fp32 operands: the
    gcn_layer kernel's fp32 path).  The JAX exact tier is
    `SFNOConfig(film=FilmConfig(film_gen_type="gcn_custom"))` at its
    defaults."""
    cfg = SFNOConfig(
        film=FilmConfig(film_gen_type="gcn_custom"),
        compute_dtype="float32",
        spectral_mxu_dtype="bfloat16",
        sht_mxu_dtype="bfloat16",
    )
    return dataclasses.replace(cfg, **overrides)


def fp32_kernel_config(**overrides) -> SFNOConfig:
    """The JAX exact tier (`SFNOConfig(film=FilmConfig(film_gen_type=
    "gcn_custom"))`) with every kernel on, as the JAX CLI's `--use-pallas
    --pallas-grid-mlp --grid-mlp-mxu-dtype float32` runs it: fp32
    activations, the SHT on fp32, and the spectral_mlp, grid_mlp,
    gcn_layer kernels and the fused head and tail on fp32 operands
    (fp32-class products: three TF32 tensor-core passes over hi / lo
    splits in every one of these kernels and the backward kernels, grid_mlp
    included).
    `fp32_kernel_config(fuse_encoder_dft=False,
    fuse_decoder_tail=False)` is the same tier with the head and tail
    unfused."""
    cfg = SFNOConfig(film=FilmConfig(film_gen_type="gcn_custom"), use_pallas=True,
                     pallas_grid_mlp=True, grid_mlp_mxu_dtype="float32")
    return dataclasses.replace(cfg, **overrides)


def exact_config(cfg: SFNOConfig) -> SFNOConfig:
    """`cfg` with every knob at fp32 and every kernel off: the plain fp32
    path the kernel path is held against."""
    film = cfg.film
    if film is not None:
        film = dataclasses.replace(film, compute_dtype="float32", pallas_gcn=False)
    return dataclasses.replace(
        cfg,
        compute_dtype="float32",
        use_pallas=False,
        pallas_grid_mlp=False,
        grid_mlp_mxu_dtype="float32",
        spectral_mxu_dtype="float32",
        sht_mxu_dtype="float32",
        output_dtype="float32",
        film=film,
    )


def finetune_config(**overrides) -> SFNOConfig:
    """The model of the FiLM fine-tune step the JAX bench times
    (bench.py:287-301): `serving_config()`, the fast tier with both fusions,
    at fp32 output."""
    return serving_config(**{"output_dtype": "float32", **overrides})


def finetune_train_config(**overrides) -> TrainConfig:
    """The bench's fine-tune TrainConfig (bench.py:287-301): batch 1, the
    FiLM scale at 1 and the frozen backbone in bf16; everything else at its
    default (L2Sphere_noSine, Adam at 5e-4, multi_step_training=0,
    film-only)."""
    return TrainConfig(**{"batch_size": 1, "film_scale_start": 1.0,
                          "bf16_frozen_params": True, **overrides})
