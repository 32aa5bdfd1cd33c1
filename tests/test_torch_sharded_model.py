"""The port's nets, trainer, rollout and checkpoints under a (data, lat,
channel) mesh with lat or channel > 1, against the JAX package unsharded and
under a (2, 2, 2) mesh of the simulated CPU devices (fp32, rel-L2 1e-5).

The port's ranks run as gloo processes (this file is their worker,
`python tests/test_torch_sharded_model.py RANK WORLD PORT DIR D,L,C`), one
spawn of D*L*C ranks a mesh, each rank computing every case into one
`.npz`; inputs and weights are made here from numpy seeds and carried by
`convert.from_flax_params`.  Each data rank takes its share of the batch of
2.  No process group is ever created in the pytest process.  Configurations:
JAX's `small_cfg` (tests/test_training.py) unfilmed and filmed, and filmed
variants with 17 rows (uneven over lat) and 3 blocks: instance and layer
norm, the linear filter (its modes through `mode_inv`, its weight sharded),
and the planar FFT.

The bf16 tier (film-only SGD step of the filmed net at compute, spectral
and SHT dtype bfloat16, the frozen backbone stored in bf16, the block
kernels off as every model mesh gates them, the generator on its plain
path, in fp32 and in bf16) is held on meshes 1,2,2 and 2,2,1 against the
port's own one-process bf16 step, and that step against JAX's unsharded
bf16 step, at the bf16-class tolerances BF16_TOL.
"""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ["1,2,1", "1,1,2", "1,2,2", "2,2,1"]
FORWARD = ["net", "filmed", "odd", "layer_norm", "linear", "fft"]
# the whole unfilmed linear net (16 and 17 rows) / the filmed net's
# film-only step
STEPS = ("sgd", "sgd_odd", "film")
# JAX's own step under (2, 2, 2) with the linear filter on 17 rows is off
# its unsharded step by ~90% (its forward agrees): a fault of the JAX
# package (ROADMAP Queue 3), so that case is held to the unsharded step only
NO_JAX_MESH_STEP = ("sgd_odd",)
# the bf16 tier's film-only step, with the generator in fp32 and in bf16
BF16 = ("bf16_genf32", "bf16")
BF16_MESHES = ("1,2,2", "2,2,1")
# bf16-class bounds: the loss (relative), the film gradient and the update
# (rel-L2), for the sharded step against the one-process step, and for
# that step against JAX's
BF16_TOL = {"loss": 1e-2, "grad": 5e-2, "update": 5e-2}
ROLLOUT_STEPS = 3
SCALE = 0.8
TOL = 1e-5
TINY = ["--img-size", "16", "32", "--scale-factor", "2", "--in-chans", "3",
        "--out-chans", "3", "--embed-dim", "8", "--num-layers", "3",
        "--spectral-layers", "1"]


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_cfg(name):
    """The JAX SFNOConfig of a case."""
    from tests.test_training import small_cfg

    if name in BF16:
        cfg = small_cfg(film=True)
        film = dataclasses.replace(cfg.film, pallas_gcn=False,
                                   compute_dtype="float32" if name == "bf16_genf32"
                                   else "bfloat16")
        return dataclasses.replace(cfg, film=film, compute_dtype="bfloat16",
                                   spectral_mxu_dtype="bfloat16", sht_mxu_dtype="bfloat16",
                                   use_pallas=False, pallas_grid_mlp=False,
                                   output_dtype="float32")
    if name == "net":
        return small_cfg(film=False)
    cfg = small_cfg(film=True)
    if name in ("filmed", "fft"):
        over = {"fft": dict(spectral_transform="fft")}.get(name, {})
        return dataclasses.replace(cfg, **over)
    if name in ("sgd", "sgd_odd"):  # every parameter trained: the sharded pos_embed and w
        return dataclasses.replace(small_cfg(film=False), num_layers=3, filter_type="linear",
                                   img_size=(17 if name == "sgd_odd" else 16, 32))
    over = dict(img_size=(17, 32), num_layers=3)
    over.update({"layer_norm": dict(normalization_layer="layer_norm"),
                 "linear": dict(filter_type="linear")}.get(name, {}))
    return dataclasses.replace(cfg, **over)


def _train_cfg(name):
    from msfno_tpu.utils.config import TrainConfig

    # SGD: the update is linear in the gradient, so two summation orders
    # stay apart by their round-off (Adam's first step is the gradient's sign)
    return TrainConfig(batch_size=2, optimizer="sgd", learning_rate=1e-2, film_scale_start=SCALE,
                       bf16_frozen_params=name in BF16)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    h, w = cfg.img_size
    x = rng.standard_normal((2, h, w, cfg.in_chans)).astype(np.float32)
    if cfg.film is None:
        return x, None
    hs, ws = cfg.film.sst_shape
    return x, rng.standard_normal((2, cfg.film.temporal_step, hs, ws)).astype(np.float32)


def _batch(cfg, steps):
    from msfno_tpu.data.synthetic import gen_batch

    b = gen_batch(cfg, 2, steps, seed=5)
    return b.era5, b.sst


# ------------------------------------------------------- the JAX side


def _np_tree(t):
    import jax

    return jax.tree_util.tree_map(np.asarray, t)


@functools.lru_cache(maxsize=None)
def jax_forward(name):
    """(params, {"single": y, "mesh": y under (2, 2, 2)}) of a forward case."""
    import jax
    import jax.numpy as jnp

    from msfno_tpu.models import FourierNeuralOperatorNet, FourierNeuralOperatorNetFilmed
    from msfno_tpu.parallel import make_mesh
    from msfno_tpu.parallel.annotate import use_mesh
    from tests.test_torch_spectral_configs import _random_params

    cfg = _jax_cfg(name)
    model = (FourierNeuralOperatorNetFilmed if cfg.film else FourierNeuralOperatorNet)(cfg)
    x, sst = _inputs(cfg)
    args = (jnp.asarray(x),) + ((jnp.asarray(sst), SCALE) if cfg.film else ())
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    params = _random_params(shapes, np.random.default_rng(1))
    apply = jax.jit(lambda p, *a: model.apply({"params": p}, *a))
    out = {"single": np.asarray(apply(params, *args))}
    with use_mesh(make_mesh(8, shape=(2, 2, 2))):
        out["mesh"] = np.asarray(jax.jit(lambda p, *a: model.apply({"params": p}, *a))(
            params, *args))
    return params, out


@functools.lru_cache(maxsize=None)
def jax_train(name):
    """(initial state as a state_dict, {"single" | "mesh": (loss, updated
    trainable state_dict)}) of one train step on the batch of 2."""
    import jax.numpy as jnp

    from msfno_torch.convert import from_flax_params, from_flax_train_state
    from msfno_tpu.parallel import make_mesh, make_sharded_train_step
    from msfno_tpu.parallel.sharded_train import shard_state
    from msfno_tpu.training.trainer import Trainer as JTrainer

    cfg, tcfg = _jax_cfg(name), _train_cfg(name)
    era5, sst = _batch(cfg, 0)
    jt = JTrainer(cfg, tcfg)
    js = jt.init_state()
    init = from_flax_train_state(_np_tree(js.trainable), _np_tree(js.frozen))
    names = set(from_flax_params(_np_tree(js.trainable)))
    out = {}
    s1, m1 = jt._train_step(js, jnp.asarray(era5), None if sst is None else jnp.asarray(sst))
    out["single"] = (float(m1["loss"]), {k: v for k, v in from_flax_params(
        _np_tree(s1.params)).items() if k in names})
    if name in NO_JAX_MESH_STEP or name in BF16:
        return init, out
    mesh = make_mesh(8, shape=(2, 2, 2))
    jt2 = JTrainer(cfg, tcfg)
    step, place = make_sharded_train_step(jt2, mesh)
    st = jt2.init_state()
    if cfg.img_size[0] % 2 == 0:
        # JAX places a parameter only where the rows divide (device_put
        # needs even splits); 17 rows stay replicated, the activations sharded
        st = shard_state(st, mesh)
    s2, m2 = step(st, *place(era5, sst))
    out["mesh"] = (float(m2["loss"]), {k: v for k, v in from_flax_params(
        _np_tree(s2.params)).items() if k in names})
    return init, out


@functools.lru_cache(maxsize=None)
def jax_rollout():
    """(params, {"single" | "mesh": (steps, 2, H, W, C)}) of scan_rollout."""
    import jax.numpy as jnp

    from msfno_tpu.inference.rollout import scan_rollout
    from msfno_tpu.models import FourierNeuralOperatorNetFilmed
    from msfno_tpu.parallel import make_mesh

    params, _ = jax_forward("filmed")  # JAX places 16 rows over lat (17: device_put refuses)
    cfg = _jax_cfg("filmed")
    era5, sst = _batch(cfg, ROLLOUT_STEPS)
    model = FourierNeuralOperatorNetFilmed(cfg)
    kw = dict(sst_seq=jnp.asarray(sst[1:ROLLOUT_STEPS + 1]), scale=SCALE)
    return {"single": np.asarray(scan_rollout(model, params, jnp.asarray(era5[0]),
                                              ROLLOUT_STEPS, **kw)),
            "mesh": np.asarray(scan_rollout(model, params, jnp.asarray(era5[0]), ROLLOUT_STEPS,
                                            mesh=make_mesh(8, shape=(2, 2, 2)), **kw))}


# ------------------------------------------------------------ the worker


def _worker(rank, world, port, workdir, shape):
    import torch
    import torch.distributed as dist

    from msfno_torch.config import from_json
    from msfno_torch.inference.rollout import scan_rollout
    from msfno_torch.models import FourierNeuralOperatorNet, FourierNeuralOperatorNetFilmed
    from msfno_torch.parallel.annotate import use_mesh
    from msfno_torch.parallel.mesh import make_mesh
    from msfno_torch.parallel.sharded_train import whole_state
    from msfno_torch.training.checkpoint import load_checkpoint
    from msfno_torch.training.trainer import Trainer

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    mesh = make_mesh(shape=shape)
    d, n_data = mesh.get_local_rank("data"), shape[0]
    b0, b1 = d * 2 // n_data, (d + 1) * 2 // n_data  # this data rank's samples
    meta = json.loads(open(os.path.join(workdir, "cases.json")).read())
    out = {}

    for name in FORWARD:
        cfg = from_json(meta["cfg"][name])
        net = (FourierNeuralOperatorNetFilmed if cfg.film else FourierNeuralOperatorNet)(
            cfg, device="cpu")
        net.load_state_dict(torch.load(os.path.join(workdir, f"{name}.pt")))
        z = np.load(os.path.join(workdir, f"{name}.npz"))
        args = (torch.from_numpy(z["x"][b0:b1]),)
        if cfg.film:
            args += (torch.from_numpy(z["sst"][b0:b1]), SCALE)
        with torch.no_grad(), use_mesh(mesh):
            out[f"fwd/{name}"] = net(*args).numpy()
        if name == "odd":  # dropout and drop-path: the whole masks, each rank its part
            drop = FourierNeuralOperatorNetFilmed(
                dataclasses.replace(cfg, drop_rate=0.2, drop_path_rate=0.1), device="cpu")
            drop.load_state_dict(net.state_dict())
            gen = lambda: torch.Generator().manual_seed(7)  # noqa: E731
            with torch.no_grad():
                out["drop/one"] = drop(*args, rng=gen()).numpy()
                with use_mesh(mesh):
                    out["drop/mesh"] = drop(*args, rng=gen()).numpy()
        if name == "filmed":
            with torch.no_grad():
                ys = scan_rollout(net, z["era5"][0, b0:b1], ROLLOUT_STEPS,
                                  sst_seq=z["sst_seq"][1:ROLLOUT_STEPS + 1, b0:b1], scale=SCALE,
                                  mesh=mesh)
            out["rollout"] = ys.numpy()

    for name in STEPS:
        cfg, tcfg = from_json(meta["cfg"][name]), from_json(meta["tcfg"])
        tr = Trainer(cfg, tcfg, device="cpu", mesh=mesh, checkpoint_dir=workdir)
        tr.model.load_state_dict(torch.load(os.path.join(workdir, f"init_{name}.pt")))
        state = tr.init_state()
        z = np.load(os.path.join(workdir, f"batch_{name}.npz"))
        sst = torch.from_numpy(z["sst"][:, b0:b1]) if "sst" in z else None
        state, m = tr._train_step(state, torch.from_numpy(z["era5"][:, b0:b1]), sst)
        params, opt = whole_state(state)
        out[f"{name}/loss"] = np.float64(m["loss"])
        out[f"{name}/grad_norm"] = np.float64(m["grad_norm"])
        for k in state.trainable:
            out[f"{name}/p/{k}"] = params[k].numpy()
        if name == "sgd" and shape == (1, 2, 2):
            _checkpoint_cases(tr, state, params, opt, workdir, rank, out)
    _multi_step_case(mesh, meta, out)
    if ",".join(map(str, shape)) in BF16_MESHES:
        _bf16_case(mesh, meta, workdir, out)
    np.savez(os.path.join(workdir, f"{'_'.join(map(str, shape))}_rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


def _multi_step_case(mesh, meta, out):
    """A 3-step rollout loss (multi_step_training=2) with retrain_film (the
    decoder, the last block and the generator trained) on the 17-row
    linear filmed net, SGD, under the mesh and on one device, in this rank:
    the gathered output fed back as the next input."""
    import torch

    from msfno_torch.config import from_json
    from msfno_torch.data.synthetic import gen_batch
    from msfno_torch.parallel.sharded_train import whole_state
    from msfno_torch.training.trainer import Trainer

    cfg = from_json(meta["cfg"]["linear"])
    tcfg = dataclasses.replace(from_json(meta["tcfg"]), multi_step_training=2,
                               retrain_film=True)
    b = gen_batch(cfg, 2, 2, seed=3)
    n_data, d = mesh.mesh.shape[0], mesh.get_local_rank("data")
    share = slice(d * 2 // n_data, (d + 1) * 2 // n_data)  # the mesh's data rank's samples
    for key, m, samples in (("mesh", mesh, share), ("one", None, slice(None))):
        tr = Trainer(cfg, tcfg, device="cpu", mesh=m)
        state = tr.init_state()
        state, metrics = tr._train_step(state, torch.from_numpy(b.era5[:, samples]),
                                        torch.from_numpy(b.sst[:, samples]))
        params, _ = whole_state(state)
        out[f"ms2_{key}/loss"] = np.float64(metrics["loss"])
        for k in state.trainable:
            out[f"ms2_{key}/p/{k}"] = params[k].numpy()


def _bf16_case(mesh, meta, workdir, out):
    """The bf16 tier's film-only SGD step (BF16 configs), under the mesh
    (each data rank its share of the batch of 2) and on one process, in
    this rank: the loss, the reduced film gradient and the updated film
    parameters."""
    import torch

    from msfno_torch.config import from_json
    from msfno_torch.parallel.sharded_train import reduce_gradients, whole_state
    from msfno_torch.training.losses import sums_over_samples
    from msfno_torch.training.trainer import Trainer

    n_data, d = mesh.mesh.shape[0], mesh.get_local_rank("data")
    share = slice(d * 2 // n_data, (d + 1) * 2 // n_data)
    for name in BF16:
        cfg, tcfg = from_json(meta["cfg"][name]), from_json(meta["tcfg_bf16"])
        z = np.load(os.path.join(workdir, f"batch_{name}.npz"))
        for key, m, samples in (("mesh", mesh, share), ("one", None, slice(None))):
            tr = Trainer(cfg, tcfg, device="cpu", mesh=m)
            tr.model.load_state_dict(torch.load(os.path.join(workdir, f"init_{name}.pt")))
            state = tr.init_state()
            era5 = torch.from_numpy(z["era5"][:, samples])
            sst = torch.from_numpy(z["sst"][:, samples])
            loss, per_step, grads = tr.loss_and_grads(state, era5, sst)
            if m is not None:
                reduce_gradients(grads, state.trainable, m, [loss, per_step],
                                 mean=not sums_over_samples(tcfg.loss_fn))
            tr.tx.step(state.trainable, grads, state.opt_state)
            params, _ = whole_state(state)
            out[f"{name}_{key}/loss"] = np.float64(loss)
            for k in state.trainable:
                out[f"{name}_{key}/g/{k}"] = grads[k].float().numpy()
                out[f"{name}_{key}/p/{k}"] = params[k].float().numpy()


def _checkpoint_cases(tr, state, params, opt, workdir, rank, out):
    """Under 1,2,2: the checkpoint against the file an unsharded trainer
    writes from the same (gathered) state, and that file restored onto a
    1,4,1 mesh and onto no mesh."""
    import torch
    import torch.distributed as dist

    from msfno_torch.parallel.mesh import make_mesh
    from msfno_torch.parallel.sharded_train import whole_state
    from msfno_torch.training.trainer import Trainer

    path = tr.save_checkpoint(state)
    if rank == 0:
        one = Trainer(tr.cfg, tr.tcfg, device="cpu", checkpoint_dir=os.path.join(workdir, "one"))
        st = one.init_state()
        with torch.no_grad():
            for k, p in st.params.items():
                p.copy_(params[k])
        st.opt_state = opt
        one.iter, one.epoch = tr.iter, tr.epoch
        ref = one.save_checkpoint(st)
        out["ckpt/bit_identical"] = np.bool_(open(path, "rb").read() == open(ref, "rb").read())
        bare = Trainer(tr.cfg, tr.tcfg, device="cpu")
        st0 = bare.restore(bare.init_state(), path, resume_optimizer=True)
        w0, o0 = whole_state(st0)
        out["ckpt/none_equal"] = np.bool_(all(torch.equal(w0[k], params[k]) for k in params)
                                          and _same(o0, opt))
    dist.barrier()
    other = make_mesh(shape=(1, 4, 1))
    tr2 = Trainer(tr.cfg, tr.tcfg, device="cpu", mesh=other)
    st2 = tr2.restore(tr2.init_state(), path, resume_optimizer=True)
    w2, o2 = whole_state(st2)
    out["ckpt/141_equal"] = np.bool_(all(torch.equal(w2[k], params[k]) for k in params)
                                     and _same(o2, opt))
    out["ckpt/141_sharded"] = np.bool_(getattr(st2.trainable["pos_embed"], "_mesh_spec", None)
                                       is not None)


def _same(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return set(a) == set(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b


# --------------------------------------------------------------- the tests


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _spawn(cmds, timeout=300):
    procs = [subprocess.Popen(c, cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for c in cmds]
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"{p.args} failed:\n{out}\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The cases' configs, weights and inputs, written once."""
    import torch

    from msfno_torch.convert import from_flax_params
    from msfno_tpu.utils.config import to_json

    d = tmp_path_factory.mktemp("sharded_model")
    cases = {"cfg": {}, "tcfg": to_json(_train_cfg("sgd")),
             "tcfg_bf16": to_json(_train_cfg("bf16"))}
    for name in FORWARD:
        params, _ = jax_forward(name)
        cfg = _jax_cfg(name)
        cases["cfg"][name] = to_json(cfg)
        torch.save(from_flax_params(params), d / f"{name}.pt")
        x, sst = _inputs(cfg)
        era5, sst_seq = _batch(cfg, ROLLOUT_STEPS) if cfg.film else (None, None)
        arrays = dict(x=x) if sst is None else dict(x=x, sst=sst, era5=era5, sst_seq=sst_seq)
        np.savez(d / f"{name}.npz", **arrays)
    for name in STEPS + BF16:
        init, _ = jax_train(name)
        cases["cfg"][name] = to_json(_jax_cfg(name))
        torch.save(init, d / f"init_{name}.pt")
        era5, sst = _batch(_jax_cfg(name), 0)
        np.savez(d / f"batch_{name}.npz", **(dict(era5=era5) if sst is None
                                             else dict(era5=era5, sst=sst)))
    (d / "cases.json").write_text(json.dumps(cases))
    return d


@functools.lru_cache(maxsize=None)
def _run(workdir: str, mesh: str) -> list[dict]:
    shape = tuple(int(s) for s in mesh.split(","))
    world = int(np.prod(shape))
    port = str(_free_port())
    _spawn([[sys.executable, os.path.abspath(__file__), str(r), str(world), port, workdir, mesh]
            for r in range(world)])
    tag = "_".join(map(str, shape))
    return [dict(np.load(os.path.join(workdir, f"{tag}_rank{r}.npz"))) for r in range(world)]


@pytest.fixture(scope="module")
def port_runs(workdir):
    return lambda mesh: _run(str(workdir), mesh)


def _samples(mesh: str, rank: int) -> slice:
    data, lat, chan = (int(s) for s in mesh.split(","))
    d = rank // (lat * chan)
    return slice(d * 2 // data, (d + 1) * 2 // data)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", FORWARD)
def test_forward_matches_jax(port_runs, mesh, name):
    """Every rank's gathered output equals the JAX net's, unsharded and under
    (2, 2, 2), on its data rank's samples."""
    _, want = jax_forward(name)
    for r, res in enumerate(port_runs(mesh)):
        got = res[f"fwd/{name}"]
        for ref in ("single", "mesh"):
            err = rel_l2(got, want[ref][_samples(mesh, r)])
            print(f"parity sharded {name} mesh {mesh} rank {r} vs jax {ref} rel_l2={err:.3e}")
            assert err <= TOL


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", STEPS)
def test_train_step_matches_jax(port_runs, mesh, name):
    """One SGD step through Trainer(mesh=) (the whole unfilmed linear net:
    the sharded pos_embed and SpectralConvS2 weight; the filmed net's
    film-only step): the loss and the updated trainable parameters equal
    the JAX trainer's step on the batch of 2, unsharded and under (2, 2, 2)
    (unsharded only for NO_JAX_MESH_STEP), on every rank."""
    init, want = jax_train(name)
    res = port_runs(mesh)
    for ref in want:
        loss, params = want[ref]
        for r, got in enumerate(res):
            lerr = abs(float(got[f"{name}/loss"]) - loss) / abs(loss)
            mine = {k: got[f"{name}/p/{k}"] for k in params}
            err = rel_l2(np.concatenate([mine[k].ravel() for k in params]),
                         np.concatenate([params[k].numpy().ravel() for k in params]))
            upd = rel_l2(np.concatenate([(mine[k] - init[k].numpy()).ravel() for k in params]),
                         np.concatenate([(params[k] - init[k]).numpy().ravel() for k in params]))
            print(f"parity sharded step {name} mesh {mesh} rank {r} vs jax {ref} loss "
                  f"rel={lerr:.3e} params rel_l2={err:.3e} update rel_l2={upd:.3e}")
            assert lerr <= TOL and err <= TOL and upd <= 1e-4
    for got in res[1:]:  # the replicas agree bit for bit
        for k in want["single"][1]:
            np.testing.assert_array_equal(got[f"{name}/p/{k}"], res[0][f"{name}/p/{k}"])


@pytest.mark.parametrize("mesh", MESHES)
def test_dropout_under_mesh_is_the_one_device_forward(port_runs, mesh):
    """With dropout and drop-path acting (a forward given a generator), the
    17-row filmed net under the mesh equals its one-device forward from the
    same generator: the masks are the same (JAX draws other streams, so the
    port is held to itself)."""
    for r, res in enumerate(port_runs(mesh)):
        err = rel_l2(res["drop/mesh"], res["drop/one"])
        print(f"parity sharded dropout mesh {mesh} rank {r} vs one device rel_l2={err:.3e}")
        assert err <= TOL
        assert rel_l2(res["drop/one"], res["fwd/odd"]) > 1e-2  # the masks acted


@pytest.mark.parametrize("mesh", MESHES)
def test_multi_step_retrain_film_step_is_the_one_device_step(port_runs, mesh):
    """multi_step_training=2 with retrain_film under the mesh (each data
    rank its share of the batch of 2) equals the step on the batch of 2 on
    one device: the loss and the updated trainable parameters."""
    for r, res in enumerate(port_runs(mesh)):
        one = {k[len("ms2_one/p/"):]: v for k, v in res.items() if k.startswith("ms2_one/p/")}
        lerr = abs(float(res["ms2_mesh/loss"]) - float(res["ms2_one/loss"]))
        err = rel_l2(np.concatenate([res[f"ms2_mesh/p/{k}"].ravel() for k in one]),
                     np.concatenate([v.ravel() for v in one.values()]))
        print(f"parity sharded multi-step retrain_film mesh {mesh} rank {r} vs one device "
              f"loss abs={lerr:.3e} params rel_l2={err:.3e}")
        assert len(one) > 2 and lerr <= TOL * abs(float(res["ms2_one/loss"])) and err <= TOL


@pytest.mark.parametrize("mesh", MESHES)
def test_rollout_matches_jax(port_runs, mesh):
    """A 3-step scan_rollout of the filmed net under the mesh equals JAX's,
    unsharded and under (2, 2, 2)."""
    want = jax_rollout()
    for r, res in enumerate(port_runs(mesh)):
        for ref in ("single", "mesh"):
            err = rel_l2(res["rollout"], want[ref][:, _samples(mesh, r)])
            print(f"parity sharded rollout mesh {mesh} rank {r} vs jax {ref} rel_l2={err:.3e}")
            assert err <= TOL


def _flat(res, prefix, names):
    return np.concatenate([res[f"{prefix}/{k}"].astype(np.float64).ravel() for k in names])


@pytest.mark.parametrize("mesh", BF16_MESHES)
@pytest.mark.parametrize("name", BF16)
def test_bf16_step_under_mesh_is_the_one_process_step(port_runs, mesh, name):
    """The bf16 tier's film-only step under the mesh against the port's
    one-process bf16 step on the batch of 2 (the same gates: the block
    kernels off, the generator plain): the loss, the film gradient and the
    update within BF16_TOL, on every rank."""
    init, _ = jax_train(name)
    for r, res in enumerate(port_runs(mesh)):
        names = sorted(k[len(f"{name}_one/g/"):] for k in res if k.startswith(f"{name}_one/g/"))
        assert names and all(k.startswith("film_gen.") for k in names)
        lerr = abs(float(res[f"{name}_mesh/loss"]) - float(res[f"{name}_one/loss"])) / abs(
            float(res[f"{name}_one/loss"]))
        gerr = rel_l2(_flat(res, f"{name}_mesh/g", names), _flat(res, f"{name}_one/g", names))
        start = np.concatenate([init[k].double().numpy().ravel() for k in names])
        uerr = rel_l2(_flat(res, f"{name}_mesh/p", names) - start,
                      _flat(res, f"{name}_one/p", names) - start)
        print(f"parity sharded bf16 step {name} mesh {mesh} rank {r} vs one process loss "
              f"rel={lerr:.3e} grad rel_l2={gerr:.3e} update rel_l2={uerr:.3e}")
        assert lerr <= BF16_TOL["loss"] and gerr <= BF16_TOL["grad"]
        assert uerr <= BF16_TOL["update"]


@pytest.mark.parametrize("name", BF16)
def test_bf16_one_process_step_matches_jax(port_runs, name):
    """The port's one-process bf16 step (as the mesh runs computed it)
    against JAX's unsharded bf16 step of the same config and weights: the
    loss and the update within BF16_TOL."""
    init, want = jax_train(name)
    loss, params = want["single"]
    res = port_runs(BF16_MESHES[0])[0]
    names = sorted(params)
    lerr = abs(float(res[f"{name}_one/loss"]) - loss) / abs(loss)
    start = np.concatenate([init[k].double().numpy().ravel() for k in names])
    want_upd = np.concatenate([params[k].double().numpy().ravel() for k in names]) - start
    uerr = rel_l2(_flat(res, f"{name}_one/p", names) - start, want_upd)
    print(f"parity bf16 one-process step {name} vs jax loss rel={lerr:.3e} "
          f"update rel_l2={uerr:.3e}")
    assert lerr <= BF16_TOL["loss"] and uerr <= BF16_TOL["update"]


def test_checkpoint_under_mesh_is_the_unsharded_file(port_runs):
    """The .pt a 1,2,2 trainer writes (pos_embed and the linear filter's
    weight held as shards, with their SGD state) is, byte for byte, the file
    an unsharded trainer writes from the same state."""
    res = port_runs("1,2,2")
    assert bool(res[0]["ckpt/bit_identical"])


def test_checkpoint_restores_onto_other_meshes(port_runs):
    """That file restored onto a 1,4,1 mesh (sharded anew) and onto no mesh
    gives back the same parameters and optimizer state, bit for bit."""
    res = port_runs("1,2,2")
    assert bool(res[0]["ckpt/none_equal"])
    for r in res:
        assert bool(r["ckpt/141_equal"]) and bool(r["ckpt/141_sharded"])


def test_cli_torchrun_mesh_1_2_2_matches_one_process(tmp_path):
    """`torchrun --nproc_per_node 4 -m msfno_torch.cli --cpu --mesh 1,2,2
    --train` writes one checkpoint (rank 0's) that equals a one-process
    run's (SGD, rel-L2 1e-6), and logs the same losses."""
    import torch

    from msfno_torch.training.checkpoint import load_checkpoint

    common = [*TINY, "--cpu", "--train", "--synthetic-data", "--num-iterations", "2",
              "--validation-interval", "0", "--optimizer", "sgd", "--learning-rate", "1e-2"]
    four, one = tmp_path / "four", tmp_path / "one"
    _spawn([
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         "4", "-m", "msfno_torch.cli", *common, "--mesh", "1,2,2", "--output-path", str(four)],
        [sys.executable, "-m", "msfno_torch.cli", *common, "--mesh", "none", "--output-path",
         str(one)],
    ])
    cps = {d: sorted(f for f in os.listdir(d) if f.endswith(".pt")) for d in (four, one)}
    assert cps[four] == cps[one] == ["checkpoint_iter=2_epoch=0.pt"], cps
    p4, _, m4 = load_checkpoint(str(four / cps[four][0]))
    p1, _, m1 = load_checkpoint(str(one / cps[one][0]))
    assert set(p4) == set(p1) and m4["step"] == m1["step"] == 2
    num = sum(float(((p4[k].double() - p1[k].double()) ** 2).sum()) for k in p1)
    den = sum(float((p1[k].double() ** 2).sum()) for k in p1)
    print(f"parity sharded cli 1,2,2 vs one process rel_l2={(num / den) ** 0.5:.3e}")
    assert (num / den) ** 0.5 <= 1e-6
    assert all(p4[k].shape == p1[k].shape and p4[k].dtype == p1[k].dtype for k in p1)
    logs = [np.load(d / "training_log_epoch0.npy", allow_pickle=True) for d in (four, one)]
    losses = [np.array([r["loss"] for r in lg if "loss" in r]) for lg in logs]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)
    assert torch.isfinite(torch.as_tensor(losses[0])).all()


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            tuple(int(s) for s in sys.argv[5].split(",")))
