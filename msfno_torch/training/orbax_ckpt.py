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
arrays.
"""

from __future__ import annotations

import json
import os
import shutil
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


def save_checkpoint_orbax(path: str, params: dict, opt_state=None, step: int = 0,
                          epoch: int = 0, config_json: str = "{}",
                          extra: dict | None = None) -> str:
    """Write params (name -> tensor), the optimizer state and the metadata
    as an Orbax directory at `path` (the JAX package's container, this
    package's payload), through a temporary directory renamed onto `path`;
    an existing `path` is replaced."""
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
    old = f"{path}.orbax-checkpoint-old-{os.getpid()}"
    if os.path.exists(path):
        os.replace(path, old)
    os.replace(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    return path
