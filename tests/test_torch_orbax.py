"""Orbax checkpoint directories in the port (`msfno_torch/training/
{orbax_ckpt,ocdbt,zarr2}.py`, no orbax, tensorstore or JAX) against the JAX
package, which writes and reads them through orbax and tensorstore (the
oracles of these tests only).

JAX-written directories (built once for the module): the tiny filmed net of
`small_cfg(film=True)` after one Adam step on the (2, 2, 2) mesh of the
simulated CPU devices, its arrays saved shard by shard (multi-chunk zarr
arrays), with its `.npz` twin; a bf16 leaf sharded over a 2 x 2 mesh; and a
two-process save (jax.distributed over gloo, one root manifest over
`ocdbt.process_0/` and `ocdbt.process_1/`).  The port's `peek` and
`load_checkpoint` must equal `msfno_tpu`'s `peek_orbax` /
`load_checkpoint_orbax` and the `.npz` path, bit for bit; a port-written
directory must restore leaf for leaf through orbax and list its keys in
tensorstore.  The committed fixture `tests/fixtures/orbax_jax_tiny/`
(the card's copy of the first case) must read equal to its twin.

`python tests/test_torch_orbax.py --write-fixture` rewrites the fixture.
"""

import dataclasses
import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "orbax_jax_tiny")
FIXTURE_SEED = 0


def _np(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _tcfg():
    from msfno_tpu.utils.config import TrainConfig

    return TrainConfig(batch_size=2, optimizer="adam", learning_rate=1e-3, film_scale_start=0.8)


def write_jax_checkpoints(orbax_dir: str, npz_path: str, seed: int = FIXTURE_SEED) -> None:
    """One Adam step of the JAX trainer on `small_cfg(film=True)` under the
    (2, 2, 2) mesh (batch of 2 from `gen_batch(seed=seed)`), saved by
    `msfno_tpu.training.checkpoint.save_checkpoint_orbax` and its twin by
    `save_checkpoint`, as the JAX trainer saves."""
    import jax.numpy as jnp

    from msfno_tpu.data.synthetic import gen_batch
    from msfno_tpu.parallel import make_mesh, make_sharded_train_step
    from msfno_tpu.parallel.sharded_train import shard_state
    from msfno_tpu.training import checkpoint as jckpt
    from msfno_tpu.training.trainer import Trainer as JTrainer
    from msfno_tpu.utils.config import to_json
    from tests.test_training import small_cfg

    cfg = small_cfg(film=True)
    jt = JTrainer(cfg, _tcfg())
    mesh = make_mesh(8, shape=(2, 2, 2))
    step, place = make_sharded_train_step(jt, mesh)
    b = gen_batch(cfg, 2, 0, seed=seed)
    state, _ = step(shard_state(jt.init_state(), mesh), *place(jnp.asarray(b.era5),
                                                                jnp.asarray(b.sst)))
    kw = dict(opt_state=state.opt_state, step=1, epoch=0, config_json=to_json(cfg),
              extra={"film_scale": float(state.film_scale)})
    jckpt.save_checkpoint_orbax(orbax_dir, state.params, **kw)
    jckpt.save_checkpoint(npz_path, state.params, **kw)


@pytest.fixture(scope="module")
def jax_dirs(tmp_path_factory):
    """{"tiny": (dir, npz), "bf16": (dir, whole array), "multi": (dir,
    the arrays)} written by the JAX package."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from msfno_tpu.training import checkpoint as jckpt

    root = tmp_path_factory.mktemp("jax_orbax")
    out = {}
    tiny, npz = str(root / "checkpoint_iter=1_epoch=0"), str(root / "tiny.npz")
    write_jax_checkpoints(tiny, npz)
    out["tiny"] = (tiny, npz)

    rng = np.random.default_rng(3)
    whole = jnp.asarray(rng.standard_normal((10, 6)).astype(np.float32)).astype(jnp.bfloat16)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("a", "b"))
    bf16 = str(root / "bf16")
    jckpt.save_checkpoint_orbax(bf16, {"w": jax.device_put(whole, NamedSharding(
        mesh, PartitionSpec("a", "b"))), "b": np.arange(5, dtype=np.int64)}, step=3)
    out["bf16"] = (bf16, np.asarray(whole.astype(jnp.float32)))

    multi = str(root / "multi")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--multi", str(i),
                               str(port), multi], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for i in range(2)]
    try:
        for p in procs:
            o, e = p.communicate(timeout=240)
            assert p.returncode == 0, f"{o}\n{e[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    out["multi"] = (multi, dict(np.load(multi + "_arrays.npz")))
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _multi_worker(pid: int, port: int, out: str) -> None:
    """One of two JAX processes (2 CPU devices each) saving a 2 x 2-sharded
    array, a replicated one and a host array into one shared directory."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}", num_processes=2,
                               process_id=pid)
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from msfno_tpu.training.checkpoint import save_checkpoint_orbax

    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("a", "b"))
    arrays = {"w": np.arange(16 * 120, dtype=np.float32).reshape(16, 120) / 7.0,
              "r": np.arange(5, dtype=np.float32)}
    w = jax.make_array_from_callback(arrays["w"].shape, NamedSharding(
        mesh, PartitionSpec("a", "b")), lambda i: arrays["w"][i])
    r = jax.make_array_from_callback((5,), NamedSharding(mesh, PartitionSpec()),
                                     lambda i: arrays["r"][i])
    save_checkpoint_orbax(out, {"w": w, "r": r, "n": np.ones(3, np.float32)}, step=2)
    if pid == 0:
        np.savez(out + "_arrays.npz", n=np.ones(3, np.float32), **arrays)


# ----------------------------------------------------------- comparisons


def _leaf(v) -> np.ndarray:
    """A leaf as numpy: bf16 (torch or ml_dtypes) as its bits."""
    if isinstance(v, torch.Tensor):
        return v.view(torch.int16).numpy() if v.dtype == torch.bfloat16 else v.numpy()
    a = np.asarray(v)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _assert_tree_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), (where, sorted(got), sorted(want))
        for k in want:
            _assert_tree_equal(got[k], want[k], f"{where}/{k}")
        return
    g, w = _leaf(got), _leaf(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (where, g.dtype, w.dtype, g.shape)
    np.testing.assert_array_equal(g, w, err_msg=where)


def _assert_state_equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _assert_state_equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    else:
        assert got == want and type(got) is type(want), where


def test_jax_dir_reads_like_jax_and_like_its_npz(jax_dirs):
    """peek, and load_checkpoint with the optax state, of a JAX-written
    directory: bit for bit the JAX package's own load (converted) and the
    port's load of the `.npz` twin of the same payload."""
    from msfno_torch.convert import from_flax_params
    from msfno_torch.training import checkpoint as tckpt
    from msfno_tpu.training import checkpoint as jckpt

    d, npz = jax_dirs["tiny"]
    assert tckpt.is_orbax_dir(d) and jckpt.is_orbax_dir(d)
    assert tckpt.peek(d) == jckpt.peek_orbax(d)
    tcfg = _tcfg()
    params, opt, meta = tckpt.load_checkpoint(d, with_opt_state=True, train_cfg=tcfg)
    jparams, _, jmeta = jckpt.load_checkpoint_orbax(d)
    assert meta == jmeta
    _assert_state_equal(params, from_flax_params(_np(jparams)))
    nparams, nopt, nmeta = tckpt.load_checkpoint(npz, with_opt_state=True, train_cfg=tcfg)
    _assert_state_equal(params, nparams)
    _assert_state_equal(opt, nopt)
    assert {k: v for k, v in meta.items() if k != "backend"} == nmeta
    assert meta["backend"] == "orbax" and opt["inner"]["count"] == 1
    # the raw leaves, against orbax's own restore
    from msfno_torch.training.orbax_ckpt import _restore
    from msfno_tpu.training.checkpoint import _restore_orbax_numpy

    _assert_tree_equal(_restore(d), _restore_orbax_numpy(d))


def test_multi_chunk_bf16_leaf(jax_dirs):
    """A bf16 leaf sharded over 2 x 2 devices is four zarr chunks; the port
    assembles it bit for bit."""
    from msfno_torch.training.ocdbt import OcdbtReader
    from msfno_torch.training.orbax_ckpt import _restore
    from msfno_tpu.training.checkpoint import _restore_orbax_numpy

    d, whole = jax_dirs["bf16"]
    with OcdbtReader(d) as store:
        zarray = json.loads(store.read("params.w/.zarray"))
        chunks = [k for k in store.keys() if k.startswith("params.w/") and k[-1].isdigit()]
    assert zarray["dtype"] == "bfloat16" and zarray["chunks"] == [5, 3]
    assert sorted(chunks) == [f"params.w/{i}.{j}" for i in range(2) for j in range(2)]
    got = _restore(d)
    _assert_tree_equal(got, _restore_orbax_numpy(d))
    assert got["params"]["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["params"]["w"].float().numpy(), whole)


def test_multi_process_tree_reads_as_one_store(jax_dirs):
    """A two-process save: the root manifest merges both processes' trees
    (data files under ocdbt.process_0/ and ocdbt.process_1/)."""
    from msfno_torch.training import checkpoint as tckpt
    from msfno_torch.training.ocdbt import OcdbtReader
    from msfno_torch.training.orbax_ckpt import _restore
    from msfno_tpu.training.checkpoint import _restore_orbax_numpy

    d, arrays = jax_dirs["multi"]
    with OcdbtReader(d) as store:
        files = {v[0].split("/")[0] for v in store.entries.values() if not isinstance(v, bytes)}
    assert files == {"ocdbt.process_0", "ocdbt.process_1"}
    got = _restore(d)
    _assert_tree_equal(got, _restore_orbax_numpy(d))
    for k, v in arrays.items():
        np.testing.assert_array_equal(got["params"][k].numpy(), v)
    assert tckpt.peek(d)["step"] == 2


def _port_trainer(tmp, backend="orbax"):
    from msfno_torch.config import from_json
    from msfno_torch.training.trainer import Trainer
    from msfno_tpu.utils.config import to_json
    from tests.test_training import small_cfg

    tcfg = dataclasses.replace(_tcfg(), checkpoint_backend=backend)
    return Trainer(from_json(to_json(small_cfg(film=True))), from_json(to_json(tcfg)),
                   device="cpu", checkpoint_dir=str(tmp))


def _port_step(tr):
    from msfno_torch.data.synthetic import gen_batch

    state = tr.init_state()
    b = gen_batch(tr.cfg, 2, 0, seed=1)
    state, _ = tr._train_step(state, torch.from_numpy(b.era5), torch.from_numpy(b.sst))
    return state


def test_port_dir_restores_through_orbax_and_tensorstore(tmp_path):
    """A port-written directory (one Adam step of the same net): orbax's
    restore gives every parameter and optimizer leaf bit for bit, tensorstore
    lists the OCDBT keys, and the port reads it back equal to its `.pt`."""
    import tensorstore as ts

    from msfno_torch.parallel.sharded_train import whole_state
    from msfno_torch.training import checkpoint as tckpt
    from msfno_torch.training.ocdbt import OcdbtReader
    from msfno_tpu.training.checkpoint import _restore_orbax_numpy, peek_orbax

    tr = _port_trainer(tmp_path / "orbax")
    state = _port_step(tr)
    d = tr.save_checkpoint(state)
    assert os.path.basename(d) == "checkpoint_iter=0_epoch=0" and tckpt.is_orbax_dir(d)
    params, opt = whole_state(state)
    tree = _restore_orbax_numpy(d)
    for name, t in params.items():
        node = tree["params"]
        for part in name.split("."):
            node = node[part]
        np.testing.assert_array_equal(np.asarray(node), t.numpy(), err_msg=name)
    for name, t in opt["inner"]["mu"].items():
        np.testing.assert_array_equal(tree["opt_state"]["inner"]["mu"][name], t.numpy())
    assert int(tree["opt_state"]["inner"]["count"]) == opt["inner"]["count"] == 1
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{d}/"}).result()
    with OcdbtReader(d) as store:
        assert sorted(k.decode() for k in kv.list().result()) == store.keys()
    assert peek_orbax(d) == tckpt.peek(d)
    p2, o2, meta = tckpt.load_checkpoint(d, with_opt_state=True)
    _assert_state_equal(p2, params)
    _assert_state_equal(o2, opt)
    assert meta["writer"] == "msfno_torch" and meta["backend"] == "orbax"
    pt = _port_trainer(tmp_path / "pt", backend="npz")
    pt.iter, pt.epoch = tr.iter, tr.epoch
    ref = pt.save_checkpoint(state)
    p3, o3, meta3 = tckpt.load_checkpoint(ref, with_opt_state=True)
    _assert_state_equal(p2, p3)
    _assert_state_equal(o2, o3)
    assert {k: v for k, v in meta.items() if k not in ("backend", "writer")} == meta3
    # saving again onto the same path replaces the directory
    assert tr.save_checkpoint(state) == d and tckpt.peek(d)["step"] == 0


def test_sidecar_less_dirs_recover_meta(jax_dirs, tmp_path):
    """Without meta.json both packages read the payload's meta_json leaf
    and write the sidecar back, whichever package wrote the directory."""
    from msfno_torch.training import checkpoint as tckpt
    from msfno_tpu.training import checkpoint as jckpt

    jdir = str(tmp_path / "jax")
    shutil.copytree(jax_dirs["tiny"][0], jdir)
    want = json.load(open(os.path.join(jdir, "meta.json")))
    os.remove(os.path.join(jdir, "meta.json"))
    assert tckpt.peek(jdir) == want and os.path.exists(os.path.join(jdir, "meta.json"))
    tr = _port_trainer(tmp_path / "port")
    pdir = tr.save_checkpoint(tr.init_state())
    want = json.load(open(os.path.join(pdir, "meta.json")))
    os.remove(os.path.join(pdir, "meta.json"))
    assert tckpt.is_orbax_dir(pdir)
    assert jckpt.peek_orbax(pdir) == want and os.path.exists(os.path.join(pdir, "meta.json"))
    os.remove(os.path.join(pdir, "meta.json"))
    assert tckpt.load_checkpoint(pdir)[2] == want


def test_not_a_checkpoint_and_corruption_raise(tmp_path, jax_dirs):
    """A directory without the markers raises FileNotFoundError with the
    JAX package's message; a flipped byte fails the manifest's crc32c."""
    from msfno_torch.training import checkpoint as tckpt
    from msfno_tpu.training import checkpoint as jckpt

    empty = tmp_path / "empty"
    empty.mkdir()
    for fn in (tckpt.peek, tckpt.load_checkpoint):
        with pytest.raises(FileNotFoundError) as got:
            fn(str(empty))
        with pytest.raises(FileNotFoundError) as want:
            jckpt.peek(str(empty))
        assert str(got.value) == str(want.value)
    bad = str(tmp_path / "bad")
    shutil.copytree(jax_dirs["tiny"][0], bad)
    m = os.path.join(bad, "manifest.ocdbt")
    data = bytearray(open(m, "rb").read())
    data[20] ^= 1
    open(m, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc32c"):
        tckpt.load_checkpoint(bad)


def test_ocdbt_interior_nodes_and_version_tree(tmp_path):
    """A store tensorstore writes with 200-byte nodes and a version-tree
    arity of 4 (interior b-tree nodes, version-tree nodes, indirect and
    inline values over 7 commits) reads equal, key for key."""
    import tensorstore as ts

    from msfno_torch.training.ocdbt import OcdbtReader

    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 200, "version_tree_arity_log2": 2,
                       "max_inline_value_bytes": 16}}
    kv = ts.KvStore.open(spec).result()
    for g in range(7):
        txn = ts.Transaction()
        for i in range(12):
            kv.with_transaction(txn)[f"key{g:02d}_{i:03d}/a"] = (f"v{g}-{i}" * (1 + i % 4)).encode()
        txn.commit_async().result()
    want = {k.decode(): kv.read(k).result().value for k in kv.list().result()}
    with OcdbtReader(str(tmp_path)) as store:
        assert {k: store.read(k) for k in store.keys()} == want
        assert store.latest()["root_height"] > 1
        gens = [v["generation"] for v in store.versions()]
    assert gens == list(range(1, len(gens) + 1)) and len(gens) > 4


@pytest.mark.parametrize("comp", [None, {"id": "zstd", "level": 5}])
def test_zarr_edge_chunks_and_fill(tmp_path, comp):
    """zarr v2 arrays tensorstore writes into an OCDBT store: edge chunks,
    a chunk absent because it holds the fill value, with and without the
    compressor."""
    import tensorstore as ts

    from msfno_torch.training.ocdbt import OcdbtReader
    from msfno_torch.training.zarr2 import read_array

    a = np.arange(7 * 5, dtype=np.float64).reshape(7, 5)
    a[4:, 3:] = 2.5
    kv = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    t = ts.open({"driver": "zarr", "kvstore": {**kv, "path": "arr/"},
                 "metadata": {"shape": [7, 5], "chunks": [4, 3], "dtype": "<f8",
                              "fill_value": 2.5, "compressor": comp}},
                create=True).result()
    t[...] = a
    with OcdbtReader(str(tmp_path)) as store:
        assert "arr/1.0" in store and "arr/1.1" not in store  # all fill: not stored
        np.testing.assert_array_equal(read_array(store, "arr").numpy(), a)


# -------------------------------------------------------------- fixture


def _fixture_blocks():
    """The zstd block kinds in every frame of the fixture: its OCDBT nodes
    and manifests and the zarr chunks they hold."""
    from msfno_torch.training.ocdbt import OcdbtReader
    from tests.test_torch_zstd import _blocks

    frames = []
    for dirpath, _, names in os.walk(FIXTURE):
        for n in names:
            data = open(os.path.join(dirpath, n), "rb").read()
            if data[:2] == b"\x0c\xdb":
                frames.append(data[14:-4])
    with OcdbtReader(FIXTURE) as store:
        frames += [store.read(k) for k in store.keys() if not k.endswith("/.zarray")]
    return [b for f in frames for b in _blocks(f)]


def test_fixture_reads_equal_to_its_twin_and_holds_entropy_coded_blocks():
    """The committed JAX-written fixture (`write_jax_checkpoints`, seed
    FIXTURE_SEED) holds Compressed blocks with Huffman literals and
    FSE-compressed sequence tables, and the port reads it equal to the
    `.npz` the same payload gave."""
    from msfno_torch.training import checkpoint as tckpt
    from msfno_torch.training.orbax_ckpt import _restore

    blocks = _fixture_blocks()
    comp = [b for b in blocks if b[0] == 2]
    assert any(b[1] == 2 for b in comp)  # Huffman-compressed literals
    assert any(b[4] and 2 in b[4] for b in comp)  # an FSE-compressed sequence table
    twin = np.load(FIXTURE + ".npz")
    tree = _restore(FIXTURE)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat[prefix + (k,)] = v
    walk(tree, ())
    want = {k for k in twin.files if k.startswith(("params/", "opt_state/"))}
    got = set()
    for keys, v in flat.items():
        if keys[0] == "meta_json":
            meta = json.loads(v.numpy().tobytes())
            assert meta.pop("backend") == "orbax"
            assert meta == json.loads(twin["meta/json"].tobytes())
            continue
        name = "/".join(("opt_state",) + keys[1:] if keys[0] == "opt_leaves" else keys)
        got.add(name)
        np.testing.assert_array_equal(v.numpy(), twin[name], err_msg=name)
    assert got == want
    params, opt, meta = tckpt.load_checkpoint(FIXTURE, with_opt_state=True, train_cfg=_tcfg())
    nparams, nopt, _ = tckpt.load_checkpoint(FIXTURE + ".npz", with_opt_state=True,
                                             train_cfg=_tcfg())
    _assert_state_equal(params, nparams)
    _assert_state_equal(opt, nopt)
    assert meta["step"] == 1


if __name__ == "__main__":
    if sys.argv[1] == "--multi":
        _multi_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    elif sys.argv[1] == "--write-fixture":
        sys.path.insert(0, REPO)
        import tests.conftest  # noqa: F401  (the 8 simulated CPU devices)

        shutil.rmtree(FIXTURE, ignore_errors=True)
        write_jax_checkpoints(FIXTURE, FIXTURE + ".npz")
