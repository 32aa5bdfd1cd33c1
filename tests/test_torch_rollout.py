"""Rollout of the PyTorch port against the JAX package's: a 3-step filmed
rollout with per-step SST and normalization, the loop form of scan_rollout,
bf16 serving parameters and the bf16 carry."""

import dataclasses

import numpy as np
import pytest
import torch

from msfno_torch.convert import from_flax_params
from msfno_torch.data.normalization import Normalizer, SSTNormalizer
from msfno_torch.inference.rollout import (
    RolloutConfig,
    rollout,
    scan_rollout,
    serving_params,
)
from msfno_torch.models import FourierNeuralOperatorNetFilmed
from test_torch_model import FP32, SERVING, inputs, jax_net, rel_l2, report, torch_net

torch.set_num_threads(2)

STEPS = 3


def _seq(cfg):
    rng = np.random.default_rng(7)
    x0, sst = inputs(cfg)
    sst_seq = sst[None] + 0.1 * rng.standard_normal((STEPS,) + sst.shape).astype(np.float32)
    norm = Normalizer(rng.standard_normal(cfg.in_chans).astype(np.float32),
                      (1.0 + rng.random(cfg.in_chans)).astype(np.float32))
    return x0, sst_seq, norm, SSTNormalizer(0.2, 1.5)


def test_rollout_matches_jax():
    pytest.importorskip("jax")
    from msfno_tpu.data.normalization import Normalizer as JNormalizer
    from msfno_tpu.data.normalization import SSTNormalizer as JSSTNormalizer
    from msfno_tpu.inference.rollout import RolloutConfig as JRolloutConfig
    from msfno_tpu.inference.rollout import rollout as jax_rollout

    model, params = jax_net(FP32)
    x0, sst_seq, norm, sstn = _seq(FP32)
    outs_j = list(jax_rollout(
        model, params, x0, JRolloutConfig(steps=STEPS), sst_seq=sst_seq,
        normalizer=JNormalizer(norm.means, norm.stds),
        sst_normalizer=JSSTNormalizer(sstn.mean, sstn.std), scale=0.9,
    ))
    net = torch_net(FP32, params)
    outs_t = list(rollout(net, x0, RolloutConfig(steps=STEPS), sst_seq=sst_seq,
                          normalizer=norm, sst_normalizer=sstn, scale=0.9))
    assert len(outs_t) == STEPS
    for i, (a, b) in enumerate(zip(outs_t, outs_j)):
        assert a.dtype == np.float32 and a.shape == b.shape
        assert report(f"rollout step {i + 1}", rel_l2(a, b)) <= 1e-4
    # the loop form of scan_rollout: normalized-space outputs of the same run
    stacked = scan_rollout(net, x0, STEPS, sst_seq=sst_seq, normalizer=norm,
                           sst_normalizer=sstn, scale=0.9, collect_channels=[0, 2])
    assert stacked.shape == (STEPS, 1, 32, 64, 2)
    denorm = stacked.numpy() * norm.stds[[0, 2]] + norm.means[[0, 2]]
    np.testing.assert_allclose(denorm, np.stack(outs_t)[..., [0, 2]], rtol=1e-5, atol=1e-5)


def test_bf16_carry_and_serving_params():
    # bf16 output dtype: the initial state is cast to it, emitted fields
    # stay fp32; bf16-stored parameters stay within the serving class
    cfg = dataclasses.replace(SERVING, output_dtype="bfloat16")
    x0, sst_seq, norm, sstn = _seq(cfg)
    net = FourierNeuralOperatorNetFilmed(cfg, device="cpu", seed=2)
    ref = list(rollout(net, x0, RolloutConfig(steps=2), sst_seq=sst_seq,
                       normalizer=norm, sst_normalizer=sstn))
    serving_params(net)
    assert all(p.dtype == torch.bfloat16 for p in net.parameters())
    outs = list(rollout(net, x0, RolloutConfig(steps=2), sst_seq=sst_seq,
                        normalizer=norm, sst_normalizer=sstn))
    for a, b in zip(outs, ref):
        assert a.dtype == np.float32 and np.isfinite(a).all()
        assert rel_l2(a, b) <= 3e-2
