"""Checkpoint sweeps of the PyTorch port (msfno_torch/inference/
eval_checkpoints.py) against the JAX package's: `evaluate_checkpoints` on a
tiny filmed net (`tiny_sfno(film=True)` with num_film_features = its
embed_dim, on a 32x64 grid so that a binned climatology stays 24 MB) from the same JAX-written `.npz` files, with the scale-0
baseline, a static and a (doy, hour)-binned climatology and statistics,
within 1e-4 (MSE relative, skill and ACC absolute); the same weights as
this package's `.pt` and as a reference PyTorch checkpoint give the same
report; `select_checkpoints`' order and equidistant subset equal JAX's on
the same names, plus `.pt`; the saved arrays and plots."""

import dataclasses
import datetime
import os
import shutil

import numpy as np
import pytest
import torch

from msfno_torch import config as tcfg
from msfno_torch.data.normalization import Normalizer as TNormalizer
from msfno_torch.inference import eval_checkpoints as tec
from msfno_torch.models import FourierNeuralOperatorNetFilmed
from msfno_torch.models import registry as treg
from msfno_tpu.data.normalization import Normalizer as JNormalizer
from msfno_tpu.data.synthetic import gen_batch
from msfno_tpu.inference import eval_checkpoints as jec
from msfno_tpu.training import checkpoint as jckpt
from msfno_tpu.utils import config as jcfg

torch.set_num_threads(2)

TOL = 1e-4
STEPS = 2
_base = tcfg.tiny_sfno(film=True)
CFG = dataclasses.replace(_base, img_size=(32, 64), film=dataclasses.replace(
    _base.film, num_film_features=_base.embed_dim, temporal_step=4, sst_shape=(16, 32)))


def _valid_times(day, s, b):
    """(S, B) YYYYMMDDHH valid times 6 h apart, from Feb 27 2020 12 UTC
    plus `day` days (across the leap day), a day apart across the batch."""
    base = datetime.datetime(2020, 2, 27, 12) + datetime.timedelta(days=day)
    return np.array([[int((base + datetime.timedelta(hours=6 * i + 24 * j)).strftime("%Y%m%d%H"))
                      for j in range(b)] for i in range(s)], np.int64)


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    """Two JAX checkpoints (the second with perturbed film weights and
    film_scale 0.5), 3 batches of unequal size and content with valid
    times, statistics, and the JAX reports of both climatologies."""
    import jax

    from msfno_tpu.models import FourierNeuralOperatorNetFilmed as JFilmed

    d = tmp_path_factory.mktemp("sweep")
    cfg_j = jcfg.from_json(tcfg.to_json(CFG))
    jmod = JFilmed(cfg_j)
    b0 = gen_batch(cfg_j, 1, STEPS, seed=0)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(0), b0.era5[0], b0.sst[0])["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    head = params["film_gen"]["film_gen"]["head_film"]
    head["kernel"] = (0.02 * np.random.default_rng(1).standard_normal(head["kernel"].shape)
                      ).astype(np.float32)
    cps = [str(d / "checkpoint_iter=10_epoch=0.npz"), str(d / "checkpoint_iter=20_epoch=0.npz")]
    jckpt.save_checkpoint(cps[0], params, step=10, config_json=jcfg.to_json(cfg_j),
                          extra={"film_scale": 0.8})
    head["kernel"] = head["kernel"] * 1.5 + 0.01
    jckpt.save_checkpoint(cps[1], params, step=20, config_json=jcfg.to_json(cfg_j),
                          extra={"film_scale": 0.5})
    batches = []
    for i, b in enumerate((1, 2, 1)):
        batch = gen_batch(cfg_j, b, STEPS, seed=10 + i)
        batch.era5 *= 1.0 + 0.5 * i
        batch.times = _valid_times(3 * i, batch.era5.shape[0], b)
        batches.append(batch)
    rng = np.random.default_rng(2)
    c = CFG.in_chans
    means, stds = rng.normal(0, 1, c).astype(np.float32), rng.uniform(1, 2, c).astype(np.float32)
    h, w = CFG.img_size
    clims = {"static": rng.normal(0, 1, (h, w, c)).astype(np.float32),
             "binned": rng.normal(0, 1, (365, 4, h, w, c)).astype(np.float32)}
    jreps = {k: jec.evaluate_checkpoints(jmod, cps, batches, clim, STEPS,
                                         normalizer=JNormalizer(means, stds),
                                         include_sfno_baseline=True)
             for k, clim in clims.items()}
    return dict(dir=d, cps=cps, batches=batches, clims=clims, jreps=jreps,
                norm=TNormalizer(means, stds))


def _assert_close(rep, ref, name):
    for f in ("mse_model", "mse_model_norm", "mse_climatology"):
        np.testing.assert_allclose(getattr(rep, f), getattr(ref, f), rtol=TOL,
                                   err_msg=f"{name} {f}")
    for f in ("skill", "acc"):
        np.testing.assert_allclose(getattr(rep, f), getattr(ref, f), rtol=0, atol=TOL,
                                   err_msg=f"{name} {f}")


def _port(sweep, files, kind="static", **kw):
    net = FourierNeuralOperatorNetFilmed(CFG, device="cpu", seed=3)
    return tec.evaluate_checkpoints(net, files, sweep["batches"], sweep["clims"][kind], STEPS,
                                    normalizer=sweep["norm"], device="cpu", **kw)


@pytest.mark.parametrize("kind", ["static", "binned"])
def test_evaluate_checkpoints_matches_jax(sweep, kind, tmp_path):
    reps = _port(sweep, sweep["cps"], kind, include_sfno_baseline=True,
                 save_path=str(tmp_path / "eval"))
    ref = sweep["jreps"][kind]
    assert list(reps) == list(ref) == ["checkpoint_iter=10_epoch=0.npz@scale0",
                                       "checkpoint_iter=10_epoch=0.npz",
                                       "checkpoint_iter=20_epoch=0.npz"]
    for name in ref:
        assert reps[name].skill.shape == (STEPS, CFG.in_chans)
        _assert_close(reps[name], ref[name], f"{kind} {name}")
    # the three runs differ: film scale 0, 0.8 and 0.5 with other weights
    a, b, c = (reps[n].mse_model for n in reps)
    assert not np.array_equal(a, b) and not np.array_equal(b, c)
    files = os.listdir(tmp_path / "eval")
    assert "checkpoint_iter=20_epoch=0.npz_skill.npy" in files
    assert "checkpoint_iter=20_epoch=0.npz_acc.npy" in files
    assert "skill.pdf" in files or not _has_matplotlib()


def _has_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def test_own_and_reference_checkpoints_score_the_same(sweep):
    """The first JAX checkpoint's weights as this package's `.pt` (the
    wrapper's save_checkpoint, its film_scale in meta) and as a reference
    PyTorch checkpoint (no meta: film_scale given): the same report."""
    d = sweep["dir"]
    w = treg.get_model("sfno", "film", cfg=CFG, device="cpu")
    w.load_model(sweep["cps"][0])
    assert w.film_scale == pytest.approx(0.8) and w.ordering[:2] == ["10u", "10v"]
    pt = w.save_checkpoint(str(d / "checkpoint_iter=30_epoch=1.pt"),
                           extra={"film_scale": 0.8})
    tar = str(d / "weights.tar")
    torch.save({"model_state": {f"module.{k}": v for k, v in w.module.state_dict().items()}},
               tar)
    reps = _port(sweep, [sweep["cps"][0], pt, tar], film_scales={tar: 0.8})
    names = list(reps)
    assert names == ["checkpoint_iter=10_epoch=0.npz", "checkpoint_iter=30_epoch=1.pt",
                     "weights.tar"]
    for n in names[1:]:
        for f in ("mse_model", "skill", "acc"):
            np.testing.assert_array_equal(getattr(reps[n], f), getattr(reps[names[0]], f))
    params, meta = tec.load_eval_params(pt)
    assert meta["film_scale"] == 0.8 and set(params) == set(w.module.state_dict())
    trainable = w.get_parameters()
    assert trainable and all(k.startswith("film_gen.") for k in trainable)


def test_duplicate_names_keep_both_reports(sweep, tmp_path):
    other = tmp_path / "run_b"
    other.mkdir()
    dup = str(other / os.path.basename(sweep["cps"][0]))
    shutil.copy(sweep["cps"][0], dup)
    reps = _port(sweep, [sweep["cps"][0], dup])
    assert list(reps) == ["checkpoint_iter=10_epoch=0.npz",
                          "run_b_checkpoint_iter=10_epoch=0.npz"]


def test_select_checkpoints_matches_jax(tmp_path):
    iters = [5, 20, 100, 250, 1000, 3, 40]
    for i in iters:
        open(tmp_path / f"checkpoint_iter={i}_epoch={i % 3}.npz", "wb").close()
    open(tmp_path / "checkpoint_final.npz", "wb").close()
    pattern = str(tmp_path / "checkpoint_*")
    for k in (3, 4, 5, 8, 20):
        assert tec.select_checkpoints(pattern, k) == jec.select_checkpoints(pattern, k)
    # this package's trainer writes .pt files: selected in numeric order too
    for i in (7, 70):
        open(tmp_path / f"checkpoint_iter={i}_epoch=0.pt", "wb").close()
    got = [os.path.basename(f) for f in tec.select_checkpoints(pattern, 20)]
    assert got == [f"checkpoint_iter={i}_epoch={i % 3 if i not in (7, 70) else 0}."
                   f"{'pt' if i in (7, 70) else 'npz'}" for i in sorted(iters + [7, 70])] \
        + ["checkpoint_final.npz"]
    assert len(tec.select_checkpoints(pattern, 4)) == 4


def test_needs_cuda_unless_asked_for_cpu(sweep):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    net = FourierNeuralOperatorNetFilmed(CFG, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tec.evaluate_checkpoints(net, sweep["cps"][:1], sweep["batches"],
                                 sweep["clims"]["static"], STEPS)
