"""Skill metrics of the PyTorch port (msfno_torch/inference/evaluate.py)
against the JAX package's numpy ones on the same seeded inputs: the
latitude weights, weighted MSE (1e-6 relative) and ACC (1e-6 absolute),
`evaluate_rollout` with static, per-step and (doy, hour)-binned
climatologies (skill and ACC 1e-6 absolute), `indexed_climatology`,
`hourly_climatology` with empty bins, and `SkillSums` streamed over 3
batches of unequal size and content against JAX's concatenate-then-mean.
The JAX functions get the same inputs widened to fp64: on fp32 inputs
numpy sums over the non-contiguous (B, H, W) axes one row after another,
which alone departs from the exact mean by about 1e-6 at these sizes (and
grows with the grid); the port sums in fp64.  The new modules of the
evaluation slice import no JAX."""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from msfno_torch.inference import evaluate as tev
from msfno_tpu.inference import evaluate as jev

torch.set_num_threads(2)

MSE_RTOL = 1e-6
ABS_TOL = 1e-6
H, W, C = 12, 24, 5


def _fields(seed, shape, scale=1.0, offset=0.0):
    rng = np.random.default_rng(seed)
    return (offset + scale * rng.standard_normal(shape)).astype(np.float32)


def _case(seed=0, s=3, b=2):
    """Targets, forecasts near them (skill well above 0 and near 0) and a
    climatology, (S, B, H, W, C) fp32."""
    tar = _fields(seed, (s, b, H, W, C), 2.0, 1.0)
    noise = _fields(seed + 1, tar.shape) * np.linspace(0.2, 2.0, C, dtype=np.float32)
    fc = tar + noise
    clim = _fields(seed + 2, (H, W, C), 1.5, 1.0)
    return fc, tar, clim


def _f64(*arrays):
    return [None if a is None else np.asarray(a, np.float64) for a in arrays]


def _assert_report(rep, ref, name=""):
    for f in ("mse_model", "mse_model_norm", "mse_climatology"):
        a, b = getattr(rep, f), getattr(ref, f)
        assert a.shape == b.shape and a.dtype == np.float32, f
        np.testing.assert_allclose(a, b, rtol=MSE_RTOL, atol=0, err_msg=f"{name} {f}")
    for f in ("skill", "acc"):
        np.testing.assert_allclose(getattr(rep, f), getattr(ref, f), rtol=0, atol=ABS_TOL,
                                   err_msg=f"{name} {f}")


def test_lat_weights_are_jax_bits():
    for h in (7, 12, 721):
        np.testing.assert_array_equal(tev.lat_weights(h).numpy(), jev.lat_weights(h))


def test_weighted_mse_and_acc_match_jax():
    fc, tar, clim = _case()
    a, b, c = fc[0], tar[0], np.broadcast_to(clim, tar[0].shape)
    mse = tev.weighted_mse(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(mse, jev.weighted_mse(*_f64(a, b)), rtol=MSE_RTOL)
    acc = tev.weighted_acc(*(torch.from_numpy(np.ascontiguousarray(v)) for v in (a, b, c)))
    np.testing.assert_allclose(acc.numpy(), jev.weighted_acc(*_f64(a, b, c)), rtol=0,
                               atol=ABS_TOL)


@pytest.mark.parametrize("kind", ["static", "per_step", "norm"])
def test_evaluate_rollout_matches_jax(kind):
    fc, tar, clim = _case(seed=3)
    extra = {}
    if kind == "per_step":
        clim = clim[None, None] + _fields(9, (fc.shape[0], 1, H, W, C), 0.3)
    if kind == "norm":
        extra = dict(forecasts_norm=fc / 2.0, targets_norm=tar / 2.0)
    ref = jev.evaluate_rollout(*_f64(fc, tar, clim), **dict(zip(extra, _f64(*extra.values()))))
    rep = tev.evaluate_rollout(torch.from_numpy(fc), torch.from_numpy(tar), clim,
                               **{k: torch.from_numpy(v) for k, v in extra.items()})
    _assert_report(rep, ref, kind)
    assert kind == "norm" or np.isnan(rep.mse_model_norm).all()
    # skill near 0 for the noisiest channel: absolute, not relative, agreement
    assert np.abs(ref.skill).min() < 0.5


def _times(s, b, start_year=2019):
    """(S, B) YYYYMMDDHH valid times 6 h apart, across Feb 28 - Mar 1 of a
    leap year for one sample, and 0 (synthetic) for another."""
    import datetime

    t = np.zeros((s, b), np.int64)
    for j in range(b - 1):
        base = datetime.datetime(start_year + j, 2, 28, 12)
        for i in range(s):
            d = base + datetime.timedelta(hours=6 * (4 * 7 * j + 5 * i))
            t[i, j] = int(d.strftime("%Y%m%d%H"))
    return t


@pytest.mark.parametrize("days", [365, 366])
def test_binned_climatology_matches_jax(days):
    s, b = 4, 3
    fc, tar, _ = _case(seed=5, s=s, b=b)
    clim = _fields(6, (days, 4, H, W, C), 1.5, 1.0)
    times = _times(s, b, start_year=2020)
    ref = jev.evaluate_rollout(*_f64(fc, tar), clim, times=times)
    rep = tev.evaluate_rollout(torch.from_numpy(fc), torch.from_numpy(tar), clim, times=times)
    _assert_report(rep, ref, f"binned {days}")
    for c in (clim, torch.from_numpy(clim)):
        got = tev.indexed_climatology(c, times, tar.shape)
        want = jev.indexed_climatology(*_f64(clim), times, tar.shape)
        np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=ABS_TOL)
    with pytest.raises(ValueError, match="times"):
        tev.evaluate_rollout(torch.from_numpy(fc), torch.from_numpy(tar), clim)


def test_hourly_climatology_matches_jax(caplog):
    n = 40
    fields = _fields(7, (n, H, W, C), 3.0, 2.0)
    rng = np.random.default_rng(8)
    doy = rng.integers(1, 6, n)  # most of the 366 x 4 bins stay empty
    hour = rng.choice([0, 6, 12, 18], n)
    ref = jev.hourly_climatology(fields, doy, hour)
    with caplog.at_level(logging.WARNING, logger="msfno_torch"):
        got = tev.hourly_climatology(torch.from_numpy(fields), doy, hour)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=ABS_TOL)
    assert any("no samples" in r.getMessage() for r in caplog.records)
    full = tev.hourly_climatology(fields, doy, hour, n_doy=5)  # arrays in, fewer bins
    np.testing.assert_allclose(full.numpy(), jev.hourly_climatology(fields, doy, hour, n_doy=5),
                               rtol=0, atol=ABS_TOL)


def test_streamed_sums_equal_concatenated_means():
    """SkillSums over 3 batches of unequal size and content, one step and
    one batch at a time, against JAX's evaluate_rollout of the batches
    concatenated along B (eval_checkpoints.py:167-172)."""
    s = 3
    parts = [_case(seed=10 + i, s=s, b=b) for i, b in enumerate((1, 3, 2))]
    parts = [(fc * (i + 1), tar * (i + 1), clim) for i, (fc, tar, clim) in enumerate(parts)]
    clim = parts[0][2]
    cat = lambda i: np.concatenate([p[i] for p in parts], axis=1)  # noqa: E731
    ref = jev.evaluate_rollout(*_f64(cat(0), cat(1), clim, cat(0) - 1.0, cat(1) - 1.0))
    sums = tev.SkillSums(s, C)
    for fc, tar, _ in parts:
        for k in range(s):
            f, t = torch.from_numpy(fc[k]), torch.from_numpy(tar[k])
            sums.add(k, f, t, torch.from_numpy(clim).expand(t.shape), f - 1.0, t - 1.0)
    _assert_report(sums.report(), ref, "streamed")


def test_skill_report_saves_the_jax_files(tmp_path):
    fc, tar, clim = _case()
    rep = tev.evaluate_rollout(torch.from_numpy(fc), torch.from_numpy(tar), clim)
    ref = jev.evaluate_rollout(fc, tar, clim)
    rep.save(str(tmp_path / "port"))
    ref.save(str(tmp_path / "jax"))
    names = sorted(f.removeprefix("port") for f in os.listdir(tmp_path) if f.startswith("port"))
    assert names == sorted(f.removeprefix("jax") for f in os.listdir(tmp_path)
                           if f.startswith("jax"))
    for n in names:  # the JAX package writes its fp32 results as fp32 too
        a, b = np.load(tmp_path / f"port{n}"), np.load(tmp_path / f"jax{n}")
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape


def test_evaluation_modules_import_no_jax():
    code = (
        "import sys, msfno_torch.inference, msfno_torch.inference.evaluate, "
        "msfno_torch.inference.eval_checkpoints, msfno_torch.inference.io, "
        "msfno_torch.inference.forecast_writer, msfno_torch.models.variables, "
        "msfno_torch.models.film.attention, msfno_torch.models.film.vit, "
        "msfno_torch.models.film.wrapper, msfno_torch.training.checkpoint, "
        "msfno_torch.training.trainer, msfno_torch.models.registry, "
        "msfno_torch.training.orbax_ckpt, msfno_torch.training.ocdbt, "
        "msfno_torch.training.zarr2, msfno_torch.utils.zstd\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'flax', 'optax', 'orbax', 'tensorstore', 'zstandard', 'msfno_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
