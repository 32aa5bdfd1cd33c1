"""The port's Trainer against the JAX package's on the paths that take the
gradient past the last block: three steps of the two-step rollout loss
(multi_step_training=1: step 1's loss crosses the whole net into step 0's
output), and retrain_film (the decoder and the last block train too)."""

import jax.numpy as jnp
import numpy as np
import torch

from msfno_tpu.data.synthetic import gen_batch
from msfno_tpu.utils.config import TrainConfig
from tests.test_torch_trainer import CFG, jax_loss_and_grads, pair, report, tree_rel

torch.set_num_threads(2)


def test_multi_step_training_matches_jax():
    jt, js, pt, ps = pair(CFG, TrainConfig(multi_step_training=1, film_scale_start=1.0))
    for i in range(3):
        batch = gen_batch(CFG, 1, 1, seed=40 + i)
        assert batch.era5.shape[0] == 3 and batch.sst.shape[0] == 3
        js, jm = jt._train_step(js, jnp.asarray(batch.era5), jnp.asarray(batch.sst))
        ps, pm = pt._train_step(ps, *pt._device_batch(batch))
        assert pm["per_step"].shape == (2,)
        ref = torch.tensor(np.asarray(jm["per_step"]))
        err = float((pm["per_step"] - ref).norm() / ref.norm())
        assert report(f"trainer multi-step losses, step {i}", err) <= 1e-5
    assert report("trainer multi-step trainable after 3 steps",
                  tree_rel(ps.trainable, js.trainable)) <= 1e-4


def test_retrain_film_matches_jax():
    jt, js, pt, ps = pair(CFG, TrainConfig(retrain_film=True, film_scale_start=1.0))
    assert any(k.startswith("decoder.") for k in ps.trainable)
    assert any(k.startswith(f"blocks.{CFG.num_layers - 1}.") for k in ps.trainable)
    batch = gen_batch(CFG, 1, 0, seed=50)
    era5, sst = jnp.asarray(batch.era5), jnp.asarray(batch.sst)
    jl, jg = jax_loss_and_grads(jt, js, era5, sst)
    pl, _, pg = pt.loss_and_grads(ps, *pt._device_batch(batch))
    assert abs(float(pl) - float(jl)) / float(jl) <= 1e-5
    assert report("trainer retrain_film grad", tree_rel(pg, jg)) <= 1e-4
    js, _ = jt._train_step(js, era5, sst)
    ps, _ = pt._train_step(ps, *pt._device_batch(batch))
    assert report("trainer retrain_film trainable", tree_rel(ps.trainable, js.trainable)) <= 1e-4
