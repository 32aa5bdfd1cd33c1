"""The fine-tune path fed from a store, on the CPU and (marked `cuda`) on the
card: an npy store written from a numpy seed, read by ERA5Dataset and
PrefetchLoader (the native reader), a first batch equal to the frames
assembled with np.load, one `Trainer._train_step` on it against the first
step of `Trainer.train` through the loader (the loader changes no number),
then an epoch and a validation through the loaders at the serving tier's
knobs (every forward kernel; on the card also the backward kernels'
launches).  No JAX here: the file also runs where JAX is absent."""

import dataclasses
import itertools
import os

import numpy as np
import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.data import era5 as te
from msfno_torch.data.synthetic import synthetic_land_mask
from msfno_torch.training.trainer import Trainer
from test_torch_model import FUSED_SERVING

CFG = dataclasses.replace(FUSED_SERVING, output_dtype="float32")
T = CFG.film.temporal_step
N_FRAMES = 3 + 1 + T  # 3 samples at multi_step_training=0


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(request.param)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("store"))
    rng = np.random.default_rng(0)
    h, w = CFG.img_size
    hs, ws = CFG.film.sst_shape
    land = synthetic_land_mask(hs, ws)
    for i in range(N_FRAMES):
        np.save(f"{root}/era5_{i:06d}.npy",
                rng.standard_normal((h, w, CFG.in_chans)).astype(np.float32))
        sst = rng.standard_normal((hs, ws)).astype(np.float32)
        sst[land] = np.nan
        np.save(f"{root}/sst_{i:06d}.npy", sst)
    return root


def loader(root, **kw):
    ds = te.ERA5Dataset(te.NpyBackend(root), multi_step=0, temporal_step=T)
    return te.PrefetchLoader(ds, batch_size=1, shuffle=True, seed=2, num_workers=2,
                             prefetch=2, num_shards=1, **kw)


def test_first_batch_is_the_store(store):
    ld = loader(store)
    assert ld.dataset.backend.native
    batch = next(iter(ld.epoch(0)))
    base = int(ld._order(0)[0])
    era5 = np.stack([np.load(os.path.join(store, f"era5_{base + j:06d}.npy")) for j in range(2)])
    sst = np.stack([np.stack([np.load(os.path.join(store, f"sst_{base + j + k:06d}.npy"))
                              for k in range(T)]) for j in range(2)])
    np.testing.assert_array_equal(batch.era5[:, 0], era5)
    np.testing.assert_array_equal(batch.sst[:, 0], sst)  # NaNs in the same places


def test_loader_fed_fine_tune(store, device):
    from msfno_torch.ops.kernels import launch_counts, reset_launch_counts

    tc = tcfg.TrainConfig(film_scale_start=1.0, bf16_frozen_params=True,
                          validation_interval=0)
    a = Trainer(CFG, tc, device=device)
    b = Trainer(CFG, tc, device=device)
    b.model.load_state_dict(a.model.state_dict())
    sa, sb = a.init_state(), b.init_state()
    frozen0 = {k: p.detach().clone() for k, p in sb.frozen.items()}
    film0 = {k: p.detach().clone() for k, p in sb.trainable.items()}
    train = loader(store)
    val = loader(store)
    # one step on the first batch handed over in memory, and the first step
    # of train() through the loader: the same loss
    sa, ma = a._train_step(sa, *a._device_batch(next(iter(train.epoch(0)))))
    reset_launch_counts()
    sb = b.train(sb, loader=train, val_loader=lambda: itertools.islice(val.epoch(0), 2))
    counts = launch_counts()
    losses = [r["loss"] for r in b.writer.records if "loss" in r]
    assert len(losses) == len(train) == 3 and sb.step == 3
    assert abs(losses[0] - float(ma["loss"])) <= 1e-6 * abs(float(ma["loss"]))
    assert all(np.isfinite(v) for v in losses)
    assert np.isfinite([r["validation loss step=0"] for r in b.writer.records
                        if "validation loss step=0" in r]).all()
    assert any(not torch.equal(p, film0[k]) for k, p in sb.trainable.items())
    assert all(torch.equal(p, frozen0[k]) for k, p in sb.frozen.items())
    if device.type == "cuda":
        # per forward of the net, on the same device
        reset_launch_counts()
        with torch.no_grad():
            e, s = b._device_batch(next(iter(train.epoch(0))))
            b._apply(b.normalizer(e[0].float()), b.sst_normalizer(s[1].float()), 1.0)
        fwd = launch_counts()
        # 3 train steps and 2 validation forwards; the validation's gamma /
        # beta statistics run the generator once more; the backward: the
        # generator's layers and the tail once a step, no block (film-only,
        # multi_step_training=0)
        want = {k: 5 * n for k, n in fwd.items()}
        want["gcn_layer"] += fwd["gcn_layer"]
        want.update(gcn_layer_bwd=3 * fwd["gcn_layer"], spectral_decoder_bwd=3,
                    spectral_mlp_bwd=0)
        assert fwd["spectral_mlp"] == CFG.num_layers and fwd["spectral_decoder"] == 1
        assert counts == want
    else:
        assert sum(counts.values()) == 0  # the CPU takes the plain versions


def test_bf16_transfer_feeds_the_trainer(store, device):
    tr = Trainer(CFG, tcfg.TrainConfig(film_scale_start=1.0), device=device)
    batch = next(iter(loader(store, transfer_dtype=torch.bfloat16).epoch(0)))
    era5, sst = tr._device_batch(batch)
    assert era5.dtype == torch.bfloat16 and era5.device.type == device.type
    ref = next(iter(loader(store).epoch(0)))
    torch.testing.assert_close(era5.float().cpu(), torch.from_numpy(ref.era5),
                               rtol=2**-8, atol=0)
    state, m = tr._train_step(tr.init_state(), era5, sst)
    assert np.isfinite(float(m["loss"]))


@pytest.mark.cuda
def test_auto_scan_steps_default_budget_is_a_quarter_of_the_card():
    from msfno_torch.training.trainer import auto_scan_steps

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tc = tcfg.TrainConfig(validation_interval=12)
    quarter = torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory // 4
    assert auto_scan_steps(CFG, tc) == auto_scan_steps(CFG, tc, quarter) >= 1
