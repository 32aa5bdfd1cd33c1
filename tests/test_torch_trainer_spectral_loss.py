"""The port's Trainer against the JAX package's with a spectral training
loss (`loss_fn="SpectralL2Sphere"`, its SHT truncated to the model's modes):
one fine-tune step's loss, film gradient and updated film parameters, fp32,
from the same initial state."""

import jax.numpy as jnp
import torch

from msfno_tpu.data.synthetic import gen_batch
from msfno_tpu.utils.config import FilmConfig, SFNOConfig, TrainConfig
from tests.test_torch_trainer import jax_loss_and_grads, pair, report, tree_rel

torch.set_num_threads(2)

CFG = SFNOConfig(
    img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3, embed_dim=16, num_layers=2,
    spectral_layers=1,
    film=FilmConfig(film_gen_type="gcn_custom", model_depth=1, embed_dim=16, mlp_dim=16,
                    num_film_features=16, sst_shape=(8, 16), temporal_step=2,
                    pallas_gcn=False),
)


def test_spectral_loss_train_step_matches_jax():
    tcfg = TrainConfig(loss_fn="SpectralL2Sphere", film_scale_start=0.8)
    jt, js, pt, ps = pair(CFG, tcfg)
    batch = gen_batch(CFG, 1, 0, seed=70)
    era5, sst = jnp.asarray(batch.era5), jnp.asarray(batch.sst)
    jl, jg = jax_loss_and_grads(jt, js, era5, sst)
    pl, _, pg = pt.loss_and_grads(ps, *pt._device_batch(batch))
    assert report("trainer SpectralL2Sphere loss",
                  abs(float(pl) - float(jl)) / float(jl)) <= 1e-5
    assert report("trainer SpectralL2Sphere film grad", tree_rel(pg, jg)) <= 1e-4
    js, _ = jt._train_step(js, era5, sst)
    ps, _ = pt._train_step(ps, *pt._device_batch(batch))
    assert report("trainer SpectralL2Sphere trainable",
                  tree_rel(ps.trainable, js.trainable)) <= 1e-4
