"""Rollout of the PyTorch port against the JAX package's: a 3-step filmed
rollout with per-step SST and normalization, the loop form of scan_rollout,
bf16 serving parameters and the bf16 carry; the one-step-behind fetch (the
order of steps, stepper calls and yields against JAX's, a consumer that
stops early, values against the synchronous fetch, arrays the consumer
owns), on the CPU and (marked `cuda`) on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from msfno_torch.convert import from_flax_params
from msfno_torch.data.normalization import Normalizer, SSTNormalizer
from msfno_torch.inference.rollout import (
    RolloutConfig,
    _collect,
    _states,
    rollout,
    scan_rollout,
    serving_params,
)
from msfno_torch.models import FourierNeuralOperatorNetFilmed
from test_torch_model import (
    FP32,
    FUSED_SERVING,
    SERVING,
    inputs,
    jax_net,
    rel_l2,
    report,
    torch_net,
)

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


class _Recorded:
    """sst_seq whose reads are recorded: both rollouts read sst_seq[i]
    once, when they run step i."""

    def __init__(self, seq, events):
        self.seq, self.events = seq, events

    def __getitem__(self, i):
        self.events.append(("step", i))
        return self.seq[i]


def _drive(run, sst_seq, stop=None):
    """(events, fields) of `run(sst_seq, stepper)`, the consumer stopping
    after `stop` fields."""
    events, fields = [], []
    stepper = lambda i, hours: events.append(("stepper", i))  # noqa: E731
    for k, field in enumerate(run(_Recorded(sst_seq, events), stepper)):
        events.append(("yield", k))
        fields.append(field)
        if stop is not None and k + 1 == stop:
            break
    return events, fields


def _sync_fetch(net, x0, steps, sst_seq, norm, sstn, scale, channels=None):
    """The synchronous fetch: each step, then its field's `.cpu()`, before
    the next step runs."""
    for state in _states(net, x0, steps, sst_seq, norm, sstn, scale):
        yield _collect(norm(state.float(), reverse=True), channels).cpu().numpy()


def _port_run(net, x0, cfg, norm, sstn):
    return lambda seq, stepper: rollout(net, x0, cfg, sst_seq=seq, normalizer=norm,
                                        sst_normalizer=sstn, scale=0.9, stepper=stepper)


@pytest.mark.parametrize("steps", [1, STEPS])
def test_fetch_runs_one_step_behind_as_in_jax(steps):
    """The port's sequence of steps, stepper calls and yields is JAX's
    (step i, then yield i-1, then stepper(i)); a consumer that stops after
    k fields has run k+1 steps, the same prefix of that sequence; the
    fields equal the synchronous fetch bit for bit and JAX's to 1e-4."""
    pytest.importorskip("jax")
    from msfno_tpu.data.normalization import Normalizer as JNormalizer
    from msfno_tpu.data.normalization import SSTNormalizer as JSSTNormalizer
    from msfno_tpu.inference.rollout import RolloutConfig as JRolloutConfig
    from msfno_tpu.inference.rollout import rollout as jax_rollout

    model, params = jax_net(FP32)
    x0, sst_seq, norm, sstn = _seq(FP32)
    jax_events, jax_fields = _drive(
        lambda seq, stepper: jax_rollout(
            model, params, x0, JRolloutConfig(steps=steps), sst_seq=seq,
            normalizer=JNormalizer(norm.means, norm.stds),
            sst_normalizer=JSSTNormalizer(sstn.mean, sstn.std), scale=0.9, stepper=stepper),
        sst_seq)
    want = [("step", 0), ("stepper", 0)]
    for i in range(1, steps):
        want += [("step", i), ("yield", i - 1), ("stepper", i)]
    assert jax_events == want + [("yield", steps - 1)]
    net = torch_net(FP32, params)
    run = _port_run(net, x0, RolloutConfig(steps=steps), norm, sstn)
    events, fields = _drive(run, sst_seq)
    assert events == jax_events
    sync = list(_sync_fetch(net, x0, steps, sst_seq, norm, sstn, 0.9))
    for i, (a, b, j) in enumerate(zip(fields, sync, jax_fields)):
        assert a.dtype == np.float32 and np.array_equal(a, b)
        assert report(f"overlapped rollout step {i + 1} of {steps}", rel_l2(a, j)) <= 1e-4
    for k in range(1, steps + 1):
        events, _ = _drive(run, sst_seq, stop=k)
        assert events == jax_events[:jax_events.index(("yield", k - 1)) + 1]
        assert sum(e == "step" for e, _ in events) == min(k + 1, steps)


@pytest.mark.parametrize("denormalize,channels", [(True, None), (False, None), (True, [2, 0])])
def test_yielded_arrays_are_the_consumers_own(denormalize, channels):
    """Every field a consumer keeps stays as it was yielded while the
    rollout runs on, and no two fields share memory."""
    x0, sst_seq, norm, sstn = _seq(FP32)
    net = FourierNeuralOperatorNetFilmed(FP32, device="cpu", seed=3)
    cfg = RolloutConfig(steps=STEPS, denormalize=denormalize, collect_channels=channels)
    kept, copies = [], []
    for field in rollout(net, x0, cfg, sst_seq=sst_seq, normalizer=norm,
                         sst_normalizer=sstn):
        kept.append(field)
        copies.append(field.copy())
    assert len(kept) == STEPS
    assert kept[0].shape[-1] == (FP32.out_chans if channels is None else 2)
    for a, b in zip(kept, copies):
        assert np.array_equal(a, b, equal_nan=True)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(kept) for b in kept[i + 1:])


@pytest.mark.cuda
def test_card_fetch_is_the_synchronous_fetch():
    """On the card: the copies through pinned staging buffers on a side
    stream give the synchronous fetch's fields bit for bit, in the same
    order of steps, stepper calls and yields as on the CPU; every kept
    field is the consumer's own (pageable) array."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x0, sst_seq, norm, sstn = _seq(FUSED_SERVING)
    net = FourierNeuralOperatorNetFilmed(FUSED_SERVING, device="cuda", seed=3)
    run = _port_run(net, x0, RolloutConfig(steps=STEPS), norm, sstn)
    events, fields = _drive(run, sst_seq)
    cpu_net = FourierNeuralOperatorNetFilmed(FUSED_SERVING, device="cpu", seed=3)
    assert events == _drive(_port_run(cpu_net, x0, RolloutConfig(steps=STEPS), norm, sstn),
                            sst_seq)[0]
    sync = list(_sync_fetch(net, x0, STEPS, sst_seq, norm, sstn, 0.9))
    for a, b in zip(fields, sync):
        assert np.array_equal(a, b, equal_nan=True)
    assert not any(np.shares_memory(a, b) for i, a in enumerate(fields)
                   for b in fields[i + 1:])
