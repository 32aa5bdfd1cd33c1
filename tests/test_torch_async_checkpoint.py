"""Asynchronous Orbax saves in the port
(`msfno_torch.training.orbax_ckpt.save_checkpoint_orbax(..., async_save=True)`,
`wait_for_async_saves`, `Trainer` with `async_checkpoint`) against the
synchronous save and the JAX package (msfno_tpu/training/checkpoint.py's
async branch, tests/test_training.py's test_async_orbax_checkpoint): the
directory written in the background is the synchronous one and the JAX
package reads it; an optimizer step run while it is written does not reach
it; one write is in flight at a time; a writer's error surfaces at the next
save or drain and leaves no directory; `Trainer.train` returns after the
last directory has committed, on both ranks of a 2,1,1 mesh (two gloo
processes: this file is their worker, `python
tests/test_torch_async_checkpoint.py RANK WORLD PORT DIR`)."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from msfno_torch.config import SFNOConfig, TrainConfig
from msfno_torch.data.synthetic import gen_batch
from msfno_torch.training import checkpoint as ckpt_io
from msfno_torch.training import orbax_ckpt
from msfno_torch.training.ocdbt import OcdbtReader

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = SFNOConfig(img_size=(16, 32), scale_factor=2, in_chans=3, out_chans=3, embed_dim=8,
                 num_layers=2, spectral_layers=1)
TCFG = TrainConfig(batch_size=1, training_epochs=1, validation_interval=0,
                   checkpoint_backend="orbax", async_checkpoint=True)

torch.set_num_threads(2)


def _trainer(tmp, **kw):
    from msfno_torch.training.trainer import Trainer

    return Trainer(CFG, TCFG, device="cpu", checkpoint_dir=str(tmp), **kw)


def _step(tr, state, seed=1):
    b = gen_batch(tr.cfg, 1, 0, seed=seed)
    state, _ = tr._train_step(state, torch.from_numpy(b.era5), None)
    return state


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


def _equal(got, want, where=""):
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for k in want:
            _equal(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and torch.equal(got, want), where
    else:
        assert got == want and type(got) is type(want), where


def _save(path, state, **kw):
    return ckpt_io.save_checkpoint_orbax(str(path), dict(state.params),
                                         opt_state=state.opt_state, step=3, epoch=1,
                                         extra={"film_scale": 1.0}, **kw)


@pytest.fixture
def gated_store(monkeypatch):
    """The store writer held at a gate until the test opens it; `calls`
    records each write's start and end."""
    gate, calls, real = threading.Event(), [], orbax_ckpt.write_store

    def held(root, items):
        calls.append(("start", root))
        assert gate.wait(timeout=60), "the gate was never opened"
        real(root, items)
        calls.append(("end", root))

    monkeypatch.setattr(orbax_ckpt, "write_store", held)
    yield gate, calls
    gate.set()
    orbax_ckpt.wait_for_async_saves()


def _store_items(path) -> dict:
    with OcdbtReader(str(path)) as store:
        return {k: store.read(k) for k in store.keys()}


def test_async_dir_is_the_sync_dir_and_reads_in_jax(tmp_path):
    """Every stored key's bytes, `_METADATA` and meta.json of the async
    directory equal the synchronous one's; the port's load gives the state
    bit for bit, and the JAX package's peek / load_checkpoint read it equal
    to the port's."""
    from msfno_tpu.training import checkpoint as jckpt

    tr = _trainer(tmp_path)
    state = _step(tr, tr.init_state())
    a = _save(tmp_path / "sync", state)
    b = _save(tmp_path / "async", state, async_save=True)
    ckpt_io.wait_for_async_saves()
    names = lambda d: sorted("d/*" if p.startswith("d/") else p  # noqa: E731
                             for p in (os.path.relpath(os.path.join(r, f), d)
                                       for r, _, fs in os.walk(d) for f in fs))
    assert names(a) == names(b)
    for f in ("_METADATA", "meta.json"):
        assert json.load(open(os.path.join(a, f))) == json.load(open(os.path.join(b, f)))
    assert _store_items(a) == _store_items(b)
    params, opt, meta = ckpt_io.load_checkpoint(b, with_opt_state=True)
    _equal(params, dict(state.params))
    _equal(opt, state.opt_state)
    assert meta["step"] == 3 and meta["backend"] == "orbax"
    assert jckpt.peek(b) == ckpt_io.peek(b) == meta
    jparams, _, jmeta = jckpt.load_checkpoint(b)
    assert jmeta == meta
    flat = orbax_ckpt._flat(jparams)
    assert set(flat) == set(params)
    for k, t in params.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), t.numpy(), err_msg=k)


def test_store_bytes_survive_short_writes(tmp_path, monkeypatch):
    """The data file is written by batched writev calls; one that writes
    only part of its batch (at most 777 bytes here) is carried on where it
    stopped, and the directory's stored bytes are those of a whole write."""
    from msfno_torch.training import ocdbt

    tr = _trainer(tmp_path)
    state = _step(tr, tr.init_state())
    a = _save(tmp_path / "whole", state)
    real, calls = os.writev, []

    def short(fd, buffers):
        calls.append(len(buffers))
        return real(fd, [b"".join(bytes(b) for b in buffers)[:777]])

    monkeypatch.setattr(ocdbt.os, "writev", short)
    b = _save(tmp_path / "short", state)
    monkeypatch.undo()
    assert len(calls) > 10
    assert _store_items(a) == _store_items(b)


def test_step_during_the_write_does_not_reach_it(tmp_path, gated_store):
    """The save returns before the write commits; an Adam step run while
    the writer is held changes every trainable parameter and moment, and
    the directory still holds the state as it was at the save."""
    gate, _ = gated_store
    tr = _trainer(tmp_path)
    state = _step(tr, tr.init_state())
    before = (_clone(dict(state.params)), _clone(state.opt_state))
    path = _save(tmp_path / "cp", state, async_save=True)
    assert not os.path.exists(path)  # returned before the commit
    state = _step(tr, state, seed=2)
    assert not torch.equal(next(iter(state.trainable.values())),
                           before[0][next(iter(state.trainable))])
    gate.set()
    ckpt_io.wait_for_async_saves()
    params, opt, _ = ckpt_io.load_checkpoint(path, with_opt_state=True)
    _equal(params, before[0])
    _equal(opt, before[1])


def test_second_async_save_waits_for_the_first(tmp_path, gated_store):
    gate, calls = gated_store
    tr = _trainer(tmp_path)
    state = _step(tr, tr.init_state())
    first = _save(tmp_path / "one", state, async_save=True)
    second = threading.Thread(target=_save, args=(tmp_path / "two", state),
                              kwargs={"async_save": True})
    second.start()
    time.sleep(0.3)
    assert second.is_alive()  # blocked on the write in flight
    assert [c for c, _ in calls] == ["start"]
    gate.set()
    second.join(timeout=60)
    assert not second.is_alive()
    ckpt_io.wait_for_async_saves()
    assert [c for c, _ in calls] == ["start", "end", "start", "end"]
    assert calls[0][1].startswith(first) and calls[2][1].startswith(str(tmp_path / "two"))
    assert all(os.path.exists(os.path.join(p, "meta.json"))
               for p in (first, str(tmp_path / "two")))


def test_saves_from_many_threads_keep_one_write_in_flight(tmp_path, monkeypatch):
    """More threads than cores each save twice, asynchronously and not,
    with the interpreter switching threads as often as it can: never two
    writes at once, and every directory committed."""
    tr = _trainer(tmp_path)
    state = _step(tr, tr.init_state())
    real, busy, most = orbax_ckpt.write_store, [0], [0]
    guard = threading.Lock()

    def counted(root, items):
        with guard:
            busy[0] += 1
            most[0] = max(most[0], busy[0])
        try:
            real(root, items)
        finally:
            with guard:
                busy[0] -= 1

    monkeypatch.setattr(orbax_ckpt, "write_store", counted)
    n = (os.cpu_count() or 1) + 1
    paths = [[tmp_path / f"t{i}_{k}" for k in range(2)] for i in range(n)]

    def saves(mine):
        _save(mine[0], state, async_save=True)
        _save(mine[1], state)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=saves, args=(p,)) for p in paths]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        ckpt_io.wait_for_async_saves()
    finally:
        sys.setswitchinterval(switch)
    assert most[0] == 1
    assert all((p / "meta.json").exists() for mine in paths for p in mine)


def test_writer_error_surfaces_and_leaves_no_directory(tmp_path, monkeypatch):
    """A failed write is raised by the drain and by the next save, which
    then writes nothing; no directory and no temporary directory is left,
    and nothing is written again synchronously."""
    tr = _trainer(tmp_path)
    state = _step(tr, tr.init_state())

    reached = threading.Event()

    def broken(root, items):
        os.makedirs(os.path.join(root, "d"))
        reached.set()
        raise OSError("no space left on the checkpoint volume")

    monkeypatch.setattr(orbax_ckpt, "write_store", broken)
    path = _save(tmp_path / "cp", state, async_save=True)
    with pytest.raises(OSError, match="no space left"):
        ckpt_io.wait_for_async_saves()
    ckpt_io.wait_for_async_saves()  # drained: nothing is in flight now
    assert os.listdir(tmp_path) == []
    reached.clear()
    _save(tmp_path / "cp", state, async_save=True)
    assert reached.wait(timeout=60)
    monkeypatch.undo()
    with pytest.raises(OSError, match="no space left"):
        _save(tmp_path / "next", state, async_save=True)
    ckpt_io.wait_for_async_saves()
    assert os.listdir(tmp_path) == [] and not os.path.exists(path)


def test_trainer_drains_before_train_returns(tmp_path, monkeypatch):
    """tests/test_training.py's test_async_orbax_checkpoint on the port,
    with the writer slowed: the last directory is committed with meta.json
    and step 2 when train() returns; a failing writer fails train()."""
    real = orbax_ckpt.write_store

    def slow(root, items):
        time.sleep(0.5)
        real(root, items)

    monkeypatch.setattr(orbax_ckpt, "write_store", slow)
    tr = _trainer(tmp_path)
    tr.train(tr.init_state(), num_batches=2)
    cps = sorted(f for f in os.listdir(tmp_path) if f.startswith("checkpoint_"))
    assert cps == ["checkpoint_iter=2_epoch=0"]
    path = os.path.join(tmp_path, cps[-1])
    assert os.path.exists(os.path.join(path, "meta.json"))
    params, _, meta = ckpt_io.load_checkpoint(path)
    assert meta["step"] == 2 and any(k.startswith("encoder") for k in params)

    def broken(root, items):
        raise OSError("the checkpoint volume went away")

    monkeypatch.setattr(orbax_ckpt, "write_store", broken)
    tr = _trainer(tmp_path / "failed")
    with pytest.raises(OSError, match="went away"):
        tr.train(tr.init_state(), num_batches=1)
    assert not os.listdir(tmp_path / "failed")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_rank_train_returns_after_the_commit(tmp_path):
    """A 2,1,1 mesh of two gloo processes, rank 0's writer slowed by 1 s:
    on both ranks `train()` returns with the last directory committed."""
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), "2", port,
                               str(tmp_path)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, f"{p.args} failed:\n{out}\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    res = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(2)]
    assert all(r["committed"] for r in res), res
    assert res[1]["seconds"] >= 1.0  # rank 1 waited for rank 0's slow write
    params, _, meta = ckpt_io.load_checkpoint(str(tmp_path / "cp" / "checkpoint_iter=2_epoch=0"))
    assert meta["step"] == 2


def _worker(rank: int, world: int, port: str, workdir: str) -> None:
    import torch.distributed as dist

    from msfno_torch.parallel.mesh import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=world)
    try:
        if rank == 0:
            real = orbax_ckpt.write_store

            def slow(root, items):
                time.sleep(1.0)
                real(root, items)

            orbax_ckpt.write_store = slow
        mesh = make_mesh(shape=(world, 1, 1))
        from msfno_torch.training.trainer import Trainer

        tcfg = TrainConfig(batch_size=2, training_epochs=1, validation_interval=0,
                           checkpoint_backend="orbax", async_checkpoint=True)
        tr = Trainer(CFG, tcfg, device="cpu", mesh=mesh,
                     checkpoint_dir=os.path.join(workdir, "cp"))
        state = tr.init_state()
        t0 = time.perf_counter()
        tr.train(state, num_batches=2)
        seconds = time.perf_counter() - t0
        last = os.path.join(workdir, "cp", "checkpoint_iter=2_epoch=0", "meta.json")
        with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
            json.dump({"committed": os.path.exists(last), "seconds": seconds}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    rank, world, port, workdir = sys.argv[1:5]
    _worker(int(rank), int(world), port, workdir)
