"""Orbax checkpoint directories without orbax (port of
msfno_tpu/training/checkpoint.py:85-329).

A directory holds `_METADATA` (the tree: each leaf's keys and value type,
and whether the arrays live in OCDBT or zarr3), `_CHECKPOINT_METADATA`,
the arrays as zarr v2 over an OCDBT store (`ocdbt.py`, `zarr2.py`), and
the `meta.json` sidecar; the metadata is also the payload's `meta_json`
leaf, so a directory whose sidecar never landed is still a checkpoint.

The JAX package's payload is `params` (the flax tree), `meta_json` and
`opt_leaves/{i}` (the optax state's leaves in `tree_flatten` order).  This
package writes the same container with its own payload, as its `.pt`
files hold it: `params` under their state_dict names split on `.` into a
nested tree, `opt_state` (its `Optimizer` state; ints as Orbax scalars) and
`meta_json`, whose meta carries `"backend": "orbax"` and
`"writer": WRITER`.  It writes no flax names.  Rank 0 writes a whole
directory (tmp + rename); reads return CPU tensors whatever mesh saved the
arrays.  `save_checkpoint_orbax(..., async_save=True)` snapshots the state
and writes the directory on a background thread, at most one at a time;
`wait_for_async_saves()` drains it (msfno_tpu's async save).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

from msfno_torch.training import zarr2
from msfno_torch.training.ocdbt import OcdbtReader, write_store

WRITER = "msfno_torch"
MARKERS = ("_METADATA", "manifest.ocdbt", "_CHECKPOINT_METADATA")
HANDLER = "orbax.checkpoint._src.handlers.pytree_checkpoint_handler.PyTreeCheckpointHandler"


def is_orbax_dir(path: str) -> bool:
    """A directory with the meta.json sidecar, or a committed Orbax tree
    whose sidecar never landed (msfno_tpu's is_orbax_dir)."""
    if not os.path.isdir(path):
        return False
    if os.path.exists(os.path.join(path, "meta.json")):
        return True
    return any(os.path.exists(os.path.join(path, m)) for m in MARKERS)


def _leaves(path: str) -> list[tuple[tuple[str, ...], str]]:
    """[(keys, value type)] of every leaf, from _METADATA."""
    with open(os.path.join(path, "_METADATA")) as f:
        md = json.load(f)
    if md.get("use_zarr3") or not md.get("use_ocdbt"):
        raise NotImplementedError(f"{path}: only zarr v2 arrays in an OCDBT store are read "
                                  "(the layout the JAX package writes)")
    out = []
    for entry in md["tree_metadata"].values():
        if entry["value_metadata"].get("skip_deserialize"):
            continue
        keys = tuple(str(k["key"]) for k in entry["key_metadata"])
        out.append((keys, entry["value_metadata"]["value_type"]))
    return out


def _restore(path: str, only: tuple[str, ...] | None = None) -> dict:
    """The payload as a nested dict of CPU tensors (Orbax scalars as Python
    numbers); `only` restores just the leaves under those top-level keys."""
    tree: dict = {}
    with OcdbtReader(path) as store:
        for keys, vtype in _leaves(path):
            if only is not None and keys[0] not in only:
                continue
            arr = zarr2.read_array(store, ".".join(keys))
            node = tree
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = arr.item() if vtype == "scalar" else arr
    return tree


def _meta_of(blob: torch.Tensor) -> dict:
    return json.loads(blob.numpy().tobytes().decode())


def _write_json(path: str, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def peek_orbax(path: str) -> dict:
    """The meta.json sidecar; without one, the payload's meta_json leaf,
    and the sidecar is written back (on rank 0) so later peeks stay cheap."""
    sidecar = os.path.join(path, "meta.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return json.load(f)
    blob = _restore(path, only=("meta_json",)).get("meta_json")
    if blob is None:
        raise FileNotFoundError(
            f"{path}: no meta.json sidecar and no meta_json leaf in the "
            f"orbax payload — not a checkpoint saved by this framework")
    meta = _meta_of(blob)
    if not dist.is_initialized() or dist.get_rank() == 0:
        _write_json(sidecar, meta)
    return meta


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _numpy_tree(tree):
    """A JAX-written tree's leaves as numpy (bf16 as its exact fp32)."""
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return (tree.float() if tree.dtype == torch.bfloat16 else tree).numpy()
    return np.asarray(tree)


def load_checkpoint_orbax(path: str, with_opt_state: bool = False, train_cfg=None,
                          convert=None):
    """(params, opt_state or None, meta) of an Orbax directory.  This
    package's payload gives its state_dict and optimizer state as saved; a
    JAX one its parameters through `convert` (default
    `convert.from_flax_params`) and, with `with_opt_state`, its optax
    leaves through `checkpoint.jax_opt_state`, as the `.npz` path maps
    them."""
    from msfno_torch.training.checkpoint import jax_opt_state

    path = os.path.abspath(path)
    payload = _restore(path)
    sidecar = os.path.join(path, "meta.json")
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            meta = json.load(f)
    elif "meta_json" in payload:
        meta = _meta_of(payload["meta_json"])
    else:
        raise FileNotFoundError(f"{path}: no meta.json and no meta_json leaf")
    if meta.get("writer") == WRITER:
        opt_state = payload.get("opt_state") if with_opt_state else None
        return _flat(payload["params"]), opt_state, meta
    if convert is None:
        from msfno_torch.convert import from_flax_params as convert
    tree = _numpy_tree(payload["params"])
    opt_state = None
    if with_opt_state and "opt_leaves" in payload:
        if train_cfg is None:
            raise ValueError(f"{path}: the optax state's leaf order comes from the train "
                             "config; pass train_cfg=")
        opt = _numpy_tree(payload["opt_leaves"])
        opt_state = jax_opt_state([opt[str(i)] for i in range(len(opt))], tree, train_cfg,
                                  meta.get("step", 0))
    return convert(tree), opt_state, meta


def _nest(params: dict) -> dict:
    tree: dict = {}
    for name, v in params.items():
        *parents, leaf = name.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        if leaf in node:
            raise ValueError(f"parameter {name} collides with another's tree path")
        node[leaf] = v
    return tree


def _walk(tree: dict, keys: tuple = ()):
    """(keys, value type, tensor) of every leaf; None leaves are dropped."""
    for k, v in tree.items():
        here = keys + (str(k),)
        if isinstance(v, dict):
            yield from _walk(v, here)
        elif isinstance(v, torch.Tensor):
            yield here, "np.ndarray", v
        elif isinstance(v, np.ndarray):
            yield here, "np.ndarray", torch.from_numpy(v)
        elif isinstance(v, (bool, int, float)):
            yield here, "scalar", torch.tensor(v, dtype=torch.bool if isinstance(v, bool)
                                               else torch.int64 if isinstance(v, int)
                                               else torch.float64)
        elif v is not None:
            raise TypeError(f"{'/'.join(here)}: a {type(v).__name__} cannot be saved")


def _tensors(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _tensors(v)
        elif isinstance(v, torch.Tensor):
            yield v


def _snapshot(tree: dict):
    """(a copy of `tree` that no later in-place update reaches, the event
    of its copies from the card or None).  Host tensors are cloned; card
    tensors are copied into pinned host memory on a side stream that waits
    for the work queued so far, and the compute stream waits for that copy
    before its next kernel, so an optimizer update queued after the save
    cannot reach the copy; `record_stream` keeps the caching allocator from
    handing a source's blocks on before the copy has read them.  The
    writer waits on the event, not on the card."""
    card = next((t.device for t in _tensors(tree) if t.is_cuda), None)
    if card is not None:
        stream = torch.cuda.Stream(card)
        stream.wait_stream(torch.cuda.current_stream(card))

    def copy(v):
        if isinstance(v, dict):
            return {k: copy(x) for k, x in v.items()}
        if isinstance(v, np.ndarray):
            return v.copy()
        if not isinstance(v, torch.Tensor):
            return v
        v = v.detach()
        if not v.is_cuda:
            return v.clone()
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        with torch.cuda.stream(stream):
            host.copy_(v, non_blocking=True)
        v.record_stream(stream)
        return host

    out = copy(tree)
    if card is None:
        return out, None
    done = torch.cuda.Event()
    done.record(stream)
    torch.cuda.current_stream(card).wait_event(done)
    return out, done


class _Writer(threading.Thread):
    """The thread of one asynchronous save; keeps the exception it hit."""

    def __init__(self, path: str, write):
        super().__init__(name=f"orbax-writer {os.path.basename(path)}", daemon=False)
        self.path, self._write, self.error = path, write, None

    def run(self) -> None:
        try:
            self._write()
        except BaseException as e:  # re-raised by wait_for_async_saves
            self.error = e


# at most one asynchronous write in flight per process, as the JAX
# package's single AsyncCheckpointer (wait_for_async_saves() takes no
# handle): the next save, or wait_for_async_saves(), drains it first;
# _LOCK makes the drain and the start of the next write one step
_INFLIGHT: _Writer | None = None
_LOCK = threading.RLock()


def wait_for_async_saves() -> None:
    """Block until the in-flight asynchronous save, if any, has committed
    (its meta.json included), then re-raise any exception its writer hit:
    the directory is then absent, never retried or written synchronously."""
    global _INFLIGHT
    with _LOCK:
        writer, _INFLIGHT = _INFLIGHT, None
        if writer is None:
            return
        writer.join()
    if writer.error is not None:
        writer.error.add_note(f"in the asynchronous checkpoint write to {writer.path}")
        raise writer.error


def _write_dir(path: str, payload: dict, meta: dict, t0: int) -> None:
    """The directory of `payload` at `path`: zarr v2 arrays over an OCDBT
    store, `_METADATA`, `_CHECKPOINT_METADATA` and `meta.json` in a
    temporary directory (removed if any of it fails), renamed onto `path`."""
    items, tree_md = {}, {}
    for keys, vtype, t in _walk(payload):
        name = ".".join(keys)
        if f"{name}/.zarray" in items:
            raise ValueError(f"two leaves are stored as the array {name}")
        items.update(zarr2.array_items(name, t))
        tree_md[str(keys)] = {"key_metadata": [{"key": k, "key_type": 2} for k in keys],
                              "value_metadata": {"value_type": vtype, "skip_deserialize": False}}
    tmp = f"{path}.orbax-checkpoint-tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        os.makedirs(tmp)
        write_store(tmp, items)
        _write_json(os.path.join(tmp, "_METADATA"), {
            "tree_metadata": tree_md, "use_ocdbt": True, "use_zarr3": False,
            "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
        _write_json(os.path.join(tmp, "_CHECKPOINT_METADATA"), {
            "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {},
            "init_timestamp_nsecs": t0, "commit_timestamp_nsecs": time.time_ns(),
            "custom_metadata": {}})
        _write_json(os.path.join(tmp, "meta.json"), meta)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    old = f"{path}.orbax-checkpoint-old-{os.getpid()}"
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)


def save_checkpoint_orbax(path: str, params: dict, opt_state=None, step: int = 0,
                          epoch: int = 0, config_json: str = "{}",
                          extra: dict | None = None, async_save: bool = False) -> str:
    """Write params (name -> tensor), the optimizer state and the metadata
    as an Orbax directory at `path` (the JAX package's container, this
    package's payload), through a temporary directory renamed onto `path`;
    an existing `path` is replaced.

    Either way the asynchronous save in flight, if any, is drained first.
    async_save=True then takes a snapshot of the state (`_snapshot`) and
    returns; a non-daemon thread writes and commits the directory.  The
    next save, or wait_for_async_saves(), drains it and re-raises what the
    write hit."""
    global _INFLIGHT
    t0 = time.time_ns()
    path = os.path.abspath(path)
    meta = {"step": int(step), "epoch": int(epoch), "config": config_json,
            "format_version": 1, "backend": "orbax", "writer": WRITER}
    if extra:
        meta.update(extra)
    payload = {"params": _nest(dict(params)),
               "meta_json": np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    with _LOCK:
        wait_for_async_saves()  # one write at a time: the tmp path is per process
        if not async_save:
            _write_dir(path, payload, meta, t0)
            return path
        payload, copied = _snapshot(payload)

        def write():
            if copied is not None:
                copied.synchronize()
            _write_dir(path, payload, meta, t0)

        _INFLIGHT = _Writer(path, write)
        _INFLIGHT.start()
    return path
