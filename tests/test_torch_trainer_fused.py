"""The port's Trainer against the JAX package's on the serving tier's kernel
knobs at a small size: the spectral_mlp, grid_mlp and gcn_layer kernels, the
fused head and tail, bf16 activations and operands and a bf16 frozen
backbone, with a two-step rollout loss so that the gradient crosses every
kernel's backward (JAX: Pallas in interpret mode; the port: the kernels'
plain versions on the CPU).  The same on the fp32-kernel tier's knobs
(`fp32_kernel_config()`: every kernel on fp32 operands, fp32 activations
and frozen weights)."""

import dataclasses

import jax.numpy as jnp
import torch

from msfno_tpu.data.synthetic import gen_batch
from msfno_tpu.utils.config import FilmConfig, SFNOConfig, TrainConfig
from tests.test_torch_trainer import jax_loss_and_grads, pair, report, tree_rel

torch.set_num_threads(2)

FUSED = SFNOConfig(
    img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3, embed_dim=16, num_layers=2,
    spectral_layers=1, compute_dtype="bfloat16", use_pallas=True, pallas_grid_mlp=True,
    spectral_mxu_dtype="bfloat16", sht_mxu_dtype="bfloat16",
    film=FilmConfig(film_gen_type="gcn_custom", model_depth=1, embed_dim=16, mlp_dim=16,
                    num_film_features=16, sst_shape=(8, 16), temporal_step=2,
                    compute_dtype="bfloat16"),
)


def test_fused_kernel_knobs_match_jax():
    tcfg = TrainConfig(multi_step_training=1, film_scale_start=1.0, bf16_frozen_params=True)
    jt, js, pt, ps = pair(FUSED, tcfg)
    assert pt.model.fuse_dft and pt.model.blocks[-1].fuse_tail
    batch = gen_batch(FUSED, 1, 1, seed=60)
    era5, sst = jnp.asarray(batch.era5), jnp.asarray(batch.sst)
    jl, jg = jax_loss_and_grads(jt, js, era5, sst)
    pl, _, pg = pt.loss_and_grads(ps, *pt._device_batch(batch))
    # bf16 rounding at different points (torch's bf16 GEMM rounds its output,
    # JAX's "bfloat16" SHT knob is fp32 on the CPU): the bf16 class of the
    # JAX fast-vs-exact drift (1.73e-2)
    assert report("trainer fused knobs loss", abs(float(pl) - float(jl)) / float(jl)) <= 3e-2
    assert report("trainer fused knobs film grad", tree_rel(pg, jg)) <= 3e-2
    js, _ = jt._train_step(js, era5, sst)
    ps, _ = pt._train_step(ps, *pt._device_batch(batch))
    assert report("trainer fused knobs trainable", tree_rel(ps.trainable, js.trainable)) <= 3e-2


# the fp32-kernel tier's knobs on FUSED's shapes: JAX's `--use-pallas
# --pallas-grid-mlp --grid-mlp-mxu-dtype float32`, the generator in fp32
FP32_KERNELS = dataclasses.replace(
    FUSED, compute_dtype="float32", grid_mlp_mxu_dtype="float32", spectral_mxu_dtype="float32",
    sht_mxu_dtype="float32", film=dataclasses.replace(FUSED.film, compute_dtype="float32"))


def test_fp32_kernel_knobs_match_jax():
    """fp32 throughout, so the fine-tune step's limits (test_torch_trainer):
    the gradient crosses the fp32 tail's backward (JAX: its Pallas backward
    kernel), the blocks and the generator's fp32 layers twice."""
    tcfg = TrainConfig(multi_step_training=1, film_scale_start=1.0, bf16_frozen_params=False)
    jt, js, pt, ps = pair(FP32_KERNELS, tcfg)
    assert pt.model.fuse_dft and pt.model.blocks[-1].fuse_tail
    batch = gen_batch(FP32_KERNELS, 1, 1, seed=61)
    era5, sst = jnp.asarray(batch.era5), jnp.asarray(batch.sst)
    jl, jg = jax_loss_and_grads(jt, js, era5, sst)
    pl, _, pg = pt.loss_and_grads(ps, *pt._device_batch(batch))
    assert report("trainer fp32 kernel knobs loss",
                  abs(float(pl) - float(jl)) / float(jl)) <= 1e-5
    assert report("trainer fp32 kernel knobs film grad", tree_rel(pg, jg)) <= 1e-4
    js, _ = jt._train_step(js, era5, sst)
    ps, _ = pt._train_step(ps, *pt._device_batch(batch))
    assert report("trainer fp32 kernel knobs trainable",
                  tree_rel(ps.trainable, js.trainable)) <= 1e-4
