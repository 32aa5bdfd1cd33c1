"""CLI parity: the JAX package's command line (msfno_tpu.cli.main) and the
port's (msfno_torch.cli.main --cpu), each resuming the same JAX `.npz` for
two more train steps on the same synthetic batches, and each running a
12-hour forecast from it on the same initial state and SST files."""

import os

import numpy as np
import pytest
import torch

from msfno_torch import cli
from msfno_tpu import cli as jcli

TINY = ["--img-size", "16", "32", "--scale-factor", "2", "--in-chans", "3", "--out-chans", "3",
        "--embed-dim", "8", "--num-layers", "2", "--spectral-layers", "1", "--mesh", "none",
        "--model-version", "film", "--coarse-level", "2", "--model-depth", "1",
        "--film-embed-dim", "8", "--mlp-dim", "8", "--temporal-step", "2"]


def rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / den) ** 0.5


@pytest.fixture(scope="module")
def jax_npz(tmp_path_factory):
    """A JAX CLI --train checkpoint of the tiny filmed config."""
    d = tmp_path_factory.mktemp("jax0")
    assert jcli.main(TINY + ["--synthetic-data", "--train", "--num-iterations", "2",
                             "--validation-interval", "0", "--output-path", str(d)]) == 0
    return d / "checkpoint_iter=2_epoch=0.npz"


def test_resume_and_train_matches_jax_cli(tmp_path, jax_npz):
    from msfno_torch.training.checkpoint import load_checkpoint

    resume = TINY + ["--synthetic-data", "--resume-checkpoint", str(jax_npz), "--train",
                     "--num-iterations", "2", "--training-epochs", "2",
                     "--validation-interval", "0"]
    assert jcli.main(resume + ["--output-path", str(tmp_path / "jax")]) == 0
    assert cli.main(resume + ["--cpu", "--output-path", str(tmp_path / "port")]) == 0
    want, _, wmeta = load_checkpoint(str(tmp_path / "jax" / "checkpoint_iter=4_epoch=1.npz"))
    got, _, gmeta = load_checkpoint(str(tmp_path / "port" / "checkpoint_iter=4_epoch=1.pt"))
    start, _, _ = load_checkpoint(str(jax_npz))
    film = [k for k in want if k.startswith("film_gen.")]
    assert film and set(got) == set(want)
    assert rel_l2({k: want[k] for k in film}, {k: start[k] for k in film}) > 1e-4  # trained
    err = rel_l2({k: got[k] for k in film}, {k: want[k] for k in film})
    print(f"parity cli resume+train trainable rel_l2={err:.3e}")
    assert err <= 1e-5
    for k in set(want) - set(film):  # the frozen backbone, as loaded
        assert torch.equal(got[k], want[k]), k
    assert (gmeta["step"], gmeta["epoch"]) == (wmeta["step"], wmeta["epoch"]) == (4, 1)
    assert gmeta["film_scale"] == pytest.approx(wmeta["film_scale"], abs=1e-7)


def test_run_matches_jax_cli(tmp_path, jax_npz):
    rng = np.random.default_rng(3)
    x0 = rng.standard_normal((1, 16, 32, 3)).astype(np.float32)
    sst = rng.standard_normal((2, 1, 2, 7, 16)).astype(np.float32)
    sst[..., 0, :3] = np.nan
    np.save(tmp_path / "x0.npy", x0)
    np.save(tmp_path / "sst.npy", sst)
    run = TINY + ["--run", "--lead-time", "12", "--resume-checkpoint", str(jax_npz),
                  "--era5-path", str(tmp_path / "x0.npy"), "--sst-path", str(tmp_path / "sst.npy")]
    assert jcli.main(run + ["--output-path", str(tmp_path / "jax")]) == 0
    assert cli.main(run + ["--cpu", "--output-path", str(tmp_path / "port")]) == 0
    want = np.load(tmp_path / "jax" / "forecast.npz")["forecast"].astype(np.float64)
    got = np.load(tmp_path / "port" / "forecast.npz")["forecast"].astype(np.float64)
    assert got.shape == want.shape == (2, 1, 16, 32, 3)
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    print(f"parity cli run forecast rel_l2={err:.3e}")
    assert err <= 1e-5
    assert os.path.exists(tmp_path / "port" / "forecast.npz")
