"""Data-parallel training of the PyTorch port over torch.distributed:
`parallel.distributed`, `parallel.mesh`, `parallel.sharded_train` and
`Trainer(mesh=)`.  The two-rank cases run as two gloo processes (this file
is their worker, `python tests/test_torch_distributed.py MODE ...`); no
process group is ever created in the pytest process.  (a) one data-parallel
Trainer step against the JAX trainer's step on the global batch, (b) the CLI
under torchrun against a one-process run with the global batch, (c)
`measure_scaling` over one and two ranks."""

import json
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--img-size", "16", "32", "--scale-factor", "2", "--in-chans", "3",
        "--out-chans", "3", "--embed-dim", "8", "--num-layers", "2",
        "--spectral-layers", "1"]


def _tiny_cfg():
    from msfno_torch.config import SFNOConfig

    return SFNOConfig(img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3, embed_dim=8,
                      num_layers=2, spectral_layers=1)


TINY_CFG = _tiny_cfg()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _spawn(cmds, timeout=240):
    """Run the commands at once; every one must exit 0."""
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"{p.args} failed:\n{out}\n{err[-4000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _workers(mode, workdir, world=2):
    port = str(_free_port())
    return _spawn([[sys.executable, os.path.abspath(__file__), mode, str(r), str(world), port,
                    str(workdir)] for r in range(world)])


def rel_l2(a: dict, b: dict) -> float:
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / den) ** 0.5


# ------------------------------------------------------- single process


def test_world_size_hint_from_env(monkeypatch):
    from msfno_torch.parallel.distributed import world_size_hint

    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert world_size_hint() == 1
    monkeypatch.setenv("OMPI_COMM_WORLD_SIZE", "3")
    assert world_size_hint() == 3
    monkeypatch.setenv("SLURM_NTASKS", "5")
    assert world_size_hint() == 5
    monkeypatch.setenv("WORLD_SIZE", "4")
    assert world_size_hint() == 4
    monkeypatch.setenv("WORLD_SIZE", "x")
    assert world_size_hint() == 5


@pytest.mark.parametrize("var", ["SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"])
def test_scheduler_launch_without_a_group_exits(tmp_path, monkeypatch, var):
    """Processes that a scheduler started but that cannot join a group
    (no torchrun environment, no --coordinator-address) stop before any
    work instead of each training alone."""
    from msfno_torch import cli

    for v in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "SLURM_NTASKS",
              "OMPI_COMM_WORLD_SIZE"):
        monkeypatch.delenv(v, raising=False)
    monkeypatch.setenv(var, "2")
    with pytest.raises(SystemExit, match="2 processes were launched.*torchrun"):
        cli.main([*TINY, "--cpu", "--train", "--synthetic-data", "--num-iterations", "1",
                  "--output-path", str(tmp_path)])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("data_target", [1, 2, 4, 8])
def test_factorize_matches_jax(data_target):
    from msfno_torch.parallel.mesh import factorize
    from msfno_tpu.parallel.mesh import factorize as jax_factorize

    for n in range(1, 17):
        assert factorize(n, data_target) == jax_factorize(n, data_target), n


def test_make_mesh_refuses_lat_and_channel():
    from msfno_torch.parallel.mesh import check_data_only, make_mesh

    for shape in [(1, 2, 1), (1, 1, 2), (2, 2, 2)]:
        with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
            make_mesh(shape=shape)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        make_mesh(4)  # factorize(4) = (1, 2, 2): lat first
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        check_data_only(types.SimpleNamespace(mesh_dim_names=("data", "lat", "channel"),
                                              shape=(2, 1, 2)))


def test_trainer_refuses_lat_mesh():
    from msfno_torch.config import TrainConfig
    from msfno_torch.training.trainer import Trainer

    mesh = types.SimpleNamespace(mesh_dim_names=("data", "lat", "channel"), shape=(1, 2, 1))
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        Trainer(TINY_CFG, TrainConfig(), device="cpu", mesh=mesh)


def test_dropout_stream_folds_the_rank_only_above_one_rank():
    from msfno_torch.config import TrainConfig
    from msfno_torch.training.trainer import Trainer

    tr = Trainer(TINY_CFG, TrainConfig(seed=3), device="cpu")
    draw = lambda: torch.rand(4, generator=tr._train_rng(5))  # noqa: E731
    seed = np.random.SeedSequence([3, 5]).generate_state(1)[0]
    alone = draw()
    assert torch.equal(alone, torch.rand(4, generator=torch.Generator().manual_seed(int(seed))))
    tr.world, tr.rank = 2, 0
    r0 = draw()
    tr.rank = 1
    r1 = draw()
    # each rank its own masks; rank 0 draws the one-process stream (numpy's
    # SeedSequence reads [seed, step, 0] as [seed, step])
    assert not torch.equal(r0, r1) and not torch.equal(r1, alone)
    assert torch.equal(r0, alone)


# ------------------------------------------------------------ two ranks


def _two_rank_step_vs_jax(tmp_path, tcfg):
    """Each rank takes one sample of a batch of 2 and steps once; both
    replicas must equal the JAX trainer's step on the whole batch.  Rank 1
    starts from perturbed weights: `shard_state` must overwrite them.
    Returns the worst relative error of the update (new - old trainable)."""
    import jax
    import jax.numpy as jnp

    from msfno_torch.convert import from_flax_params, from_flax_train_state
    from msfno_tpu.data.synthetic import gen_batch
    from msfno_tpu.training.trainer import Trainer as JTrainer
    from msfno_tpu.utils.config import to_json
    from tests.test_training import small_cfg

    cfg = small_cfg(film=True)
    jt = JTrainer(cfg, tcfg)
    js = jt.init_state()
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    init = from_flax_train_state(np_tree(js.trainable), np_tree(js.frozen))
    torch.save(init, tmp_path / "init.pt")
    batch = gen_batch(cfg, 2, 0, seed=5)
    np.savez(tmp_path / "batch.npz", era5=batch.era5, sst=batch.sst)
    (tmp_path / "cfg.json").write_text(json.dumps([to_json(cfg), to_json(tcfg)]))

    js1, jm = jt._train_step(js, jnp.asarray(batch.era5), jnp.asarray(batch.sst))
    _workers("step", tmp_path)
    ranks = [torch.load(tmp_path / f"rank{r}.pt") for r in range(2)]
    want = {k: v for k, v in from_flax_params(np_tree(js1.params)).items()
            if k in ranks[0]["trainable"]}
    assert set(want) == set(ranks[0]["trainable"])
    for r in ranks:
        loss_err = abs(r["loss"] - float(jm["loss"])) / float(jm["loss"])
        print(f"parity ddp {tcfg.loss_fn} loss vs jax global batch rel={loss_err:.3e}")
        assert loss_err <= 1e-5
        assert r["grad_norm"] == pytest.approx(float(jm["grad_norm"]), rel=1e-5)
        err = rel_l2(r["trainable"], want)
        print(f"parity ddp {tcfg.loss_fn} updated trainable vs jax global batch "
              f"rel_l2={err:.3e}")
        assert err <= 1e-5
    for k, v in ranks[0]["trainable"].items():
        assert torch.equal(v, ranks[1]["trainable"][k]), k
    for k, v in ranks[0]["frozen"].items():
        assert torch.equal(v, ranks[1]["frozen"][k]), k
    update = lambda p: {k: p[k] - init[k] for k in want}  # noqa: E731
    return rel_l2(update(ranks[0]["trainable"]), update(want))


def test_two_rank_train_step_matches_jax_global_batch(tmp_path):
    """(a) The default loss, which sums over samples: the ranks' gradients
    add up to the global batch's."""
    from msfno_tpu.utils.config import TrainConfig

    _two_rank_step_vs_jax(tmp_path, TrainConfig(film_scale_start=0.8))


@pytest.mark.parametrize("loss_fn", ["MSE", "SpectralL2Sphere"])
def test_two_rank_mean_loss_step_matches_jax_global_batch(tmp_path, loss_fn):
    """(a) with a loss that averages over samples: the ranks' gradients
    average to the global batch's.  SGD, whose step is linear in the
    gradient, so the update itself is held to the JAX step's (a summed
    gradient would double it)."""
    from msfno_tpu.utils.config import TrainConfig

    tcfg = TrainConfig(film_scale_start=0.8, loss_fn=loss_fn, optimizer="sgd",
                       learning_rate=1e-2)
    err = _two_rank_step_vs_jax(tmp_path, tcfg)
    print(f"parity ddp {loss_fn} sgd update vs jax global batch rel_l2={err:.3e}")
    assert err <= 1e-5


STORE_BATCHES = 4  # of 2 samples (or 1 a rank) in the 10-step store's 9 pairs


@pytest.fixture
def npy_store(tmp_path):
    root = tmp_path / "store"
    root.mkdir()
    rng = np.random.default_rng(4)
    for i in range(10):
        np.save(root / f"era5_{i:06d}.npy", rng.standard_normal((16, 32, 3)).astype(np.float32))
    return str(root)


def test_rank_shards_hold_the_global_batch(npy_store):
    """rank r of 2 reads order[r::2]: its batches of 1, side by side, are the
    one-process batches of 2."""
    from msfno_torch.data.era5 import ERA5Dataset, NpyBackend, PrefetchLoader

    ds = ERA5Dataset(NpyBackend(npy_store), multi_step=0)
    whole = list(PrefetchLoader(ds, batch_size=2, num_workers=1, shard_id=0,
                                num_shards=1).epoch(0))
    parts = [list(PrefetchLoader(ds, batch_size=1, num_workers=1, shard_id=r,
                                 num_shards=2).epoch(0)) for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == STORE_BATCHES
    for b, p0, p1 in zip(whole, *parts):
        np.testing.assert_array_equal(b.era5, np.concatenate([p0.era5, p1.era5], axis=1))
        np.testing.assert_array_equal(b.times, np.concatenate([p0.times, p1.times], axis=1))


def _two_rank_and_one_process(tmp_path, npy_store, optimizer):
    """`torchrun --nproc_per_node 2 -m msfno_torch.cli --cpu --train --mesh
    2,1,1` (batch 1 a rank) and a one-process --batch-size 2 run on the
    store: each writes exactly one checkpoint (the two-rank one from rank 0)
    and logs the same per-step losses.  Returns both checkpoints' params
    and the CLI flags."""
    from msfno_torch.training.checkpoint import load_checkpoint

    common = [*TINY, "--cpu", "--train", "--era5-path", npy_store, "--no-shuffle",
              "--validation-interval", "0", "--validation-batches", "1",
              "--training-workers", "1", *optimizer]
    two, one = tmp_path / "two", tmp_path / "one"
    _spawn([
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "msfno_torch.cli", *common, "--mesh", "2,1,1", "--batch-size", "1",
         "--output-path", str(two)],
        [sys.executable, "-m", "msfno_torch.cli", *common, "--mesh", "none", "--batch-size",
         "2", "--output-path", str(one)],
    ])
    cps = {d: sorted(f for f in os.listdir(d) if f.endswith(".pt")) for d in (two, one)}
    assert cps[two] == cps[one] == [f"checkpoint_iter={STORE_BATCHES}_epoch=0.pt"], cps
    assert sorted(os.listdir(two)) == sorted(os.listdir(one))  # one log: rank 0's
    p2, _, m2 = load_checkpoint(str(two / cps[two][0]))
    p1, _, m1 = load_checkpoint(str(one / cps[one][0]))
    assert m2["step"] == m1["step"] == STORE_BATCHES
    logs = [np.load(d / "training_log_epoch0.npy", allow_pickle=True) for d in (two, one)]
    losses = [np.array([r["loss"] for r in lg if "loss" in r]) for lg in logs]
    assert len(losses[0]) == STORE_BATCHES
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    return p2, p1, common


def test_two_rank_cli_matches_one_process_global_batch(tmp_path, npy_store):
    """(b) The two-rank CLI run's checkpoint equals the one-process batch-2
    run's.  SGD: an update linear in the gradient keeps the two summation
    orders' round-off at round-off (for Adam, see the next test)."""
    p2, p1, common = _two_rank_and_one_process(tmp_path, npy_store,
                                               ["--optimizer", "sgd", "--learning-rate", "1e-2"])
    err = rel_l2(p2, p1)
    print(f"parity ddp cli 2 ranks vs 1 process batch 2 rel_l2={err:.3e}")
    assert err <= 1e-6
    from msfno_torch.cli import build_parser, configs_from_args
    from msfno_torch.training.trainer import Trainer

    init = Trainer(*configs_from_args(build_parser().parse_args(common)), device="cpu")
    assert rel_l2(init.model.state_dict(), p1) > 1e-4  # the runs trained


def _one_process_gradients(common):
    """The one-process --batch-size 2 run replayed in this process, step by
    step: each trainable leaf's largest gradient norm over the run's steps,
    as a share of its step's whole gradient norm, and the final trainable
    parameters."""
    from msfno_torch.cli import build_loaders, build_parser, configs_from_args, postprocess_args
    from msfno_torch.models.registry import load_statistics
    from msfno_torch.training.trainer import Trainer

    argv = [*common, "--mesh", "none", "--batch-size", "2"]
    args = postprocess_args(build_parser().parse_args(argv), world_size=1)
    model_cfg, train_cfg = configs_from_args(args)
    tr = Trainer(model_cfg, train_cfg, device="cpu",
                 normalizer=load_statistics(args.assets, model_cfg.in_chans))
    state = tr.init_state()
    loader, _ = build_loaders(args, model_cfg, train_cfg, argv)
    share = dict.fromkeys(state.trainable, 0.0)
    for b in loader.epoch(0):
        _, _, grads = tr.loss_and_grads(state, *tr._device_batch(b))
        total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads.values())))
        for k, g in grads.items():
            share[k] = max(share[k], float(g.double().norm()) / total)
        tr.tx.step(state.trainable, grads, state.opt_state)
        state.step += 1
    assert state.step == STORE_BATCHES
    return share, {k: v.detach().clone() for k, v in state.trainable.items()}


ROUND_OFF = 1e-5  # a leaf's gradient share below this is nought to rounding


def test_two_rank_cli_with_adam_logs_the_same_losses(tmp_path, npy_store):
    """The same runs with Adam.  Adam divides each leaf's gradient by its own
    scale, so the round-off of the whole gradient weighs 1/share more in a
    leaf with a small share of it, and a gradient that is zero in exact
    arithmetic (a bias before an instance norm) turns into steps of +-lr
    that part between the two summation orders.  The other leaves must
    agree within 1e-6 together and within 1e-6 / share each, and the
    leaves that part (by more than 1%) must be exactly those whose
    one-process gradient is nought to rounding."""
    p2, p1, common = _two_rank_and_one_process(tmp_path, npy_store,
                                               ["--optimizer", "adam", "--learning-rate", "1e-3"])
    share, replay = _one_process_gradients(common)
    assert set(share) <= set(p1)
    leaf_err = {k: rel_l2({k: p2[k]}, {k: p1[k]}) for k in share}
    noise = {k for k, v in share.items() if v < ROUND_OFF}
    steady = set(share) - noise
    err = rel_l2({k: p2[k] for k in steady}, {k: p1[k] for k in steady})
    worst = max(steady, key=lambda k: leaf_err[k] * share[k])
    print(f"parity ddp cli adam 2 ranks vs 1 process batch 2 rel_l2={err:.3e} over "
          f"{len(steady)} leaves (worst {worst}: {leaf_err[worst]:.3e} at grad share "
          f"{share[worst]:.3e}); nought to rounding: "
          + ", ".join(f"{k} share {share[k]:.1e} apart {leaf_err[k]:.2f}" for k in sorted(noise)))
    assert rel_l2({k: replay[k] for k in steady}, {k: p1[k] for k in steady}) <= 1e-6
    assert err <= 1e-6
    for k in steady:
        assert leaf_err[k] <= 1e-6 / share[k], (k, leaf_err[k], share[k])
    assert {k for k in share if leaf_err[k] > 1e-2} == noise
    assert all(torch.equal(p2[k], p1[k]) for k in set(p1) - set(share))


def test_two_rank_cli_run_writes_once_and_matches_one_process(tmp_path):
    """--run under a data mesh computes on every rank and writes from rank
    0: the forecast equals a one-process run's, bit for bit."""
    run = [*TINY, "--cpu", "--run", "--lead-time", "12"]
    two, one = tmp_path / "two", tmp_path / "one"
    _spawn([
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "2", "-m", "msfno_torch.cli", *run, "--mesh", "2,1,1", "--output-path", str(two)],
        [sys.executable, "-m", "msfno_torch.cli", *run, "--output-path", str(one)],
    ])
    assert os.listdir(two) == ["forecast.npz"]
    np.testing.assert_array_equal(np.load(two / "forecast.npz")["forecast"],
                                  np.load(one / "forecast.npz")["forecast"])


def test_lone_process_mesh_1_1_1_matches_no_mesh(tmp_path):
    """--mesh 1,1,1 in a lone process joins a group of one and trains on the
    data-parallel path: the checkpoint equals a --mesh none run's."""
    from msfno_torch.training.checkpoint import load_checkpoint

    train = [*TINY, "--cpu", "--synthetic-data", "--train", "--num-iterations", "2",
             "--validation-interval", "0"]
    _spawn([[sys.executable, "-m", "msfno_torch.cli", *train, "--mesh", mesh, "--output-path",
             str(tmp_path / mesh)] for mesh in ("1,1,1", "none")])
    a, _, _ = load_checkpoint(str(tmp_path / "1,1,1" / "checkpoint_iter=2_epoch=0.pt"))
    b, _, _ = load_checkpoint(str(tmp_path / "none" / "checkpoint_iter=2_epoch=0.pt"))
    assert all(torch.equal(a[k], b[k]) for k in b)


def test_measure_scaling_over_one_and_two_ranks(tmp_path):
    """(c) weak scaling of an all-reduce step over 1 and 2 ranks: both ranks
    return rank 0's measurement, the base at efficiency 1."""
    _workers("scaling", tmp_path)
    res = [json.loads((tmp_path / f"scaling{r}.json").read_text()) for r in range(2)]
    assert res[0] == res[1]
    assert set(res[0]) == {"1", "2"}
    assert res[0]["1"]["efficiency"] == 1.0
    for v in res[0].values():
        assert v["seconds"] > 0 and v["rate"] > 0 and v["efficiency"] > 0


# ------------------------------------------------------------ the worker


def _worker(mode, rank, world, port, workdir):
    import torch.distributed as dist

    from msfno_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        if mode == "step":
            _step_worker(rank, world, workdir, make_mesh(shape=(world, 1, 1)))
        elif mode == "scaling":
            _scaling_worker(rank, workdir)
        else:
            raise ValueError(mode)
    finally:
        dist.barrier()
        dist.destroy_process_group()


def _step_worker(rank, world, workdir, mesh):
    from msfno_torch.config import from_json
    from msfno_torch.parallel import make_sharded_train_step
    from msfno_torch.training.trainer import Trainer

    cfg_json, tcfg_json = json.loads(open(os.path.join(workdir, "cfg.json")).read())
    tr = Trainer(from_json(cfg_json), from_json(tcfg_json), device="cpu", mesh=mesh)
    tr.model.load_state_dict(torch.load(os.path.join(workdir, "init.pt")))
    if rank:
        with torch.no_grad():
            for p in tr.model.parameters():
                p.add_(0.1)
    state = tr.init_state()
    b = np.load(os.path.join(workdir, "batch.npz"))
    step_fn, place_batch = make_sharded_train_step(tr, mesh)
    state, m = step_fn(state, *place_batch(b["era5"][:, rank:rank + 1],
                                           b["sst"][:, rank:rank + 1]))
    torch.save({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "trainable": {k: v.detach() for k, v in state.trainable.items()},
                "frozen": {k: v.detach() for k, v in state.frozen.items()}},
               os.path.join(workdir, f"rank{rank}.pt"))


def _scaling_worker(rank, workdir):
    import torch.distributed as dist

    from msfno_torch.parallel.distributed import measure_scaling

    def step_fn(mesh):
        group = mesh.get_group("data")
        x = torch.ones(1 << 12)

        def fn(t):
            dist.all_reduce(t, group=group)
            return t

        return fn, (x,)

    res = measure_scaling(step_fn, [2, 1], iters=3, mode="weak")
    with open(os.path.join(workdir, f"scaling{rank}.json"), "w") as f:
        json.dump(res, f)


if __name__ == "__main__":
    mode, rank, world, port, workdir = sys.argv[1:6]
    _worker(mode, int(rank), int(world), port, workdir)
