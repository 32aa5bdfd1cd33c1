"""Config, package boundary and entry-point rules of the PyTorch port: one
JSON string drives both packages, importing the port pulls in no JAX, the
entry points refuse to fall back to the CPU, and the MAE FiLM generator
builds."""

import dataclasses
import subprocess
import sys

import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.models import FourierNeuralOperatorNetFilmed

SMALL = dict(img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3,
             embed_dim=16, num_layers=3, spectral_layers=1,
             film=tcfg.FilmConfig(model_depth=1, embed_dim=16, num_film_features=16,
                                  sst_shape=(8, 16), temporal_step=2))


@pytest.mark.parametrize("make", [
    lambda m: m.SFNOConfig(),
    lambda m: m.tiny_sfno(film=True),
    lambda m: m.SFNOConfig(img_size=(33, 64), compression="tt",
                           film=m.FilmConfig(patch_size=(2, 3, 4), compute_dtype="bfloat16")),
    lambda m: m.TrainConfig(),
    lambda m: m.TrainConfig(multi_step_training=1, time_limit_s=60.0, retrain_film=True,
                            scheduler="cosine", bf16_frozen_params=True),
])
def test_one_json_drives_both_packages(make):
    pytest.importorskip("jax")
    from msfno_tpu.utils import config as jcfg

    j, t = make(jcfg), make(tcfg)
    assert tcfg.to_json(t) == jcfg.to_json(j)
    assert tcfg.from_json(jcfg.to_json(j)) == t
    assert jcfg.from_json(tcfg.to_json(t)) == j
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]


def test_serving_config_is_the_jax_fast_tier():
    pytest.importorskip("jax")
    import __graft_entry__
    from msfno_tpu.utils import config as jcfg

    fast = __graft_entry__._flagship_cfg(fast=True)
    # checkpointing_block is a training-only rematerialization switch
    want = dataclasses.replace(fast, checkpointing_block=False)
    assert jcfg.from_json(tcfg.to_json(tcfg.serving_config())) == want
    unfused = tcfg.serving_config(fuse_encoder_dft=False, fuse_decoder_tail=False)
    assert jcfg.from_json(tcfg.to_json(unfused)) == dataclasses.replace(
        want, fuse_encoder_dft=False, fuse_decoder_tail=False)


def test_finetune_config_is_the_jax_bench_configuration():
    """finetune_config()/finetune_train_config() are bench.py:287-301's."""
    pytest.importorskip("jax")
    import __graft_entry__
    from msfno_tpu.utils import config as jcfg

    want = dataclasses.replace(__graft_entry__._flagship_cfg(fast=True),
                               checkpointing_block=False, output_dtype="float32")
    assert jcfg.from_json(tcfg.to_json(tcfg.finetune_config())) == want
    want_t = jcfg.TrainConfig(batch_size=1, film_scale_start=1.0, bf16_frozen_params=True)
    assert jcfg.from_json(tcfg.to_json(tcfg.finetune_train_config())) == want_t
    assert tcfg.finetune_train_config(multi_step_training=1).multi_step_training == 1


def test_balanced_config_is_the_jax_balanced_tier():
    """balanced_config() is _flagship_cfg(balanced=True) field for field but
    for checkpointing_block; the default SFNOConfig with the gcn_custom
    generator is the exact tier, _flagship_cfg() (compared by JSON), again
    but for checkpointing_block."""
    pytest.importorskip("jax")
    import __graft_entry__
    from msfno_tpu.utils import config as jcfg

    want = dataclasses.replace(__graft_entry__._flagship_cfg(balanced=True),
                               checkpointing_block=False)
    assert jcfg.from_json(tcfg.to_json(tcfg.balanced_config())) == want
    assert tcfg.balanced_config().film.pallas_gcn
    assert tcfg.balanced_config().film.compute_dtype == "float32"
    exact = tcfg.SFNOConfig(film=tcfg.FilmConfig(film_gen_type="gcn_custom"))
    want = dataclasses.replace(__graft_entry__._flagship_cfg(tiny=False),
                               checkpointing_block=False)
    assert tcfg.to_json(exact) == jcfg.to_json(want)
    # exact_config stays the plain path the kernels are held against
    assert not tcfg.exact_config(tcfg.balanced_config()).film.pallas_gcn


def test_fp32_kernel_config_is_the_jax_exact_tier_with_every_kernel():
    """fp32_kernel_config() is the exact tier, _flagship_cfg(), with the JAX
    CLI's `--use-pallas --pallas-grid-mlp --grid-mlp-mxu-dtype float32`
    (every kernel on fp32 operands), compared by JSON, but for
    checkpointing_block."""
    pytest.importorskip("jax")
    import __graft_entry__
    from msfno_tpu.utils import config as jcfg

    want = dataclasses.replace(__graft_entry__._flagship_cfg(tiny=False),
                               checkpointing_block=False, use_pallas=True,
                               pallas_grid_mlp=True, grid_mlp_mxu_dtype="float32")
    assert tcfg.to_json(tcfg.fp32_kernel_config()) == jcfg.to_json(want)
    cfg = tcfg.fp32_kernel_config()
    assert {cfg.spectral_mxu_dtype, cfg.grid_mlp_mxu_dtype, cfg.compute_dtype,
            cfg.film.compute_dtype} == {"float32"}
    assert cfg.fuse_encoder_dft and cfg.fuse_decoder_tail and cfg.film.pallas_gcn


def test_port_imports_no_jax():
    code = (
        "import sys, msfno_torch, msfno_torch.config, msfno_torch.convert, "
        "msfno_torch.models, msfno_torch.inference.rollout, "
        "msfno_torch.data.normalization, msfno_torch.data.synthetic, "
        "msfno_torch.ops.kernels.spectral_mlp, msfno_torch.ops.kernels.grid_mlp, "
        "msfno_torch.ops.kernels.gcn_layer, msfno_torch.ops.kernels.grid_encoder_spectral, "
        "msfno_torch.ops.kernels.spectral_decoder, msfno_torch.models.registry, "
        "msfno_torch.ops.kernels.gcn_layer_bwd, msfno_torch.ops.kernels.spectral_decoder_bwd, "
        "msfno_torch.ops.kernels.spectral_mlp_bwd, msfno_torch.training.trainer, "
        "msfno_torch.training.checkpoint, msfno_torch.utils.observability, "
        "msfno_torch.ops.kernels.dft_analysis, msfno_torch.ops.kernels.dft_synthesis, "
        "msfno_torch.ops.fft, msfno_torch.ops.activations, msfno_torch.ops.contractions\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'msfno_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True)


def test_entry_points_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = tcfg.SFNOConfig(**SMALL)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FourierNeuralOperatorNetFilmed(cfg)
    assert FourierNeuralOperatorNetFilmed(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("cls_input", [False, True])
def test_mae_generator_builds(cls_input):
    """The MAE generator builds with and without class-token input (held
    against JAX in tests/test_torch_mae.py): ContextCast and its film head,
    or the film head alone."""
    film = dataclasses.replace(SMALL["film"], film_gen_type="mae", cls_input=cls_input,
                               patch_size=(2, 4, 4))
    cfg = tcfg.SFNOConfig(**{**SMALL, "film": film})
    net = FourierNeuralOperatorNetFilmed(cfg, device="cpu")
    assert hasattr(net.film_gen, "film_gen") != cls_input
    sst = (torch.randn(2, film.embed_dim) if cls_input
           else torch.randn(2, film.temporal_step, *film.sst_shape))
    with torch.no_grad():
        y = net(torch.randn(2, *cfg.img_size, cfg.in_chans), sst)
    assert y.shape == (2, *cfg.img_size, cfg.out_chans) and torch.isfinite(y).all()


def test_serving_fusions_build():
    # the fused head and tail engage at the small size, as on the serving tier
    cfg = tcfg.SFNOConfig(**SMALL, pallas_grid_mlp=True, use_pallas=True)
    net = FourierNeuralOperatorNetFilmed(cfg, device="cpu")
    assert net.fuse_dft and net.blocks[-1].fuse_tail
    assert not any(b.fuse_tail for b in net.blocks[:-1])
