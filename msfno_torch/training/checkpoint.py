"""Checkpoint I/O (port of msfno_tpu/training/checkpoint.py:52-151,332;
reference MSFNO/Models/train.py:779-819, MSFNO/Models/checkpoint.py:9-57).

This package's format is one `torch.save` file holding the parameters
(state_dict names), the optimizer state, and the JAX package's metadata:
step, epoch, config (JSON) and film_scale.  `load_checkpoint` also reads
a JAX-written `.npz` training checkpoint: its parameters through
`convert.from_flax_params`, and its optax optimizer state mapped into this
package's `Optimizer` state (`jax_opt_state`).  `peek` and
`load_checkpoint` also take an Orbax checkpoint directory, the JAX
package's or this package's (`orbax_ckpt.py`, read and written without
orbax; `save_checkpoint_orbax(..., async_save=True)` writes in the
background until `wait_for_async_saves()`).
"""

from __future__ import annotations

import json
import os
import re
import sys
import zipfile
from typing import Any

import numpy as np
import torch

from msfno_torch.training.orbax_ckpt import (  # noqa: F401 (re-exported)
    is_orbax_dir,
    load_checkpoint_orbax,
    peek_orbax,
    save_checkpoint_orbax,
    wait_for_async_saves,
)

FORMAT_VERSION = 1
OPTIMIZERS = ("adam", "adamw", "sgd")
SCHEDULERS = ("none", "cosine", "step")


def _cpu(tree):
    """The tree on the host, its keys interned: pickle writes an equal key
    once per object, so a file's bytes then depend on its values only (a
    sharded run's file is the unsharded run's, byte for byte)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {sys.intern(k) if isinstance(k, str) else k: _cpu(v) for k, v in tree.items()}
    return tree


def save_checkpoint(path: str, params: dict, opt_state=None, step: int = 0, epoch: int = 0,
                    config_json: str = "{}", extra: dict[str, Any] | None = None) -> str:
    """Write params (name -> tensor), the optimizer state and the metadata
    to `path`, atomically (temporary file, then rename)."""
    meta = {"step": int(step), "epoch": int(epoch), "config": config_json,
            "format_version": FORMAT_VERSION}
    if extra:
        meta.update(extra)
    payload = {"meta": meta, "params": _cpu(dict(params)),
               "opt_state": _cpu(opt_state) if opt_state is not None else None}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def _is_npz(path: str) -> bool:
    return zipfile.is_zipfile(path) and path.endswith(".npz")


def _not_a_checkpoint_dir(path: str) -> None:
    if os.path.isdir(path):
        raise FileNotFoundError(
            f"{path} is a directory but has no meta.json — not an orbax "
            f"checkpoint saved by this framework"
        )


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def peek(path: str) -> dict[str, Any]:
    """Checkpoint metadata without reading tensor data (the file is mapped,
    not read): this package's files, JAX `.npz` files and Orbax directories
    (their meta.json sidecar)."""
    if is_orbax_dir(path):
        return peek_orbax(path)
    _not_a_checkpoint_dir(path)
    if _is_npz(path):
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta/json"]).decode())
            meta["keys"] = [k for k in z.files if k.startswith("params/")]
        return meta
    ckpt = _load(path)
    return {**ckpt["meta"], "keys": list(ckpt["params"])}


def _npz_tree(z) -> dict:
    """The "params/*" leaves of a JAX `.npz` as a nested dict of arrays."""
    keys = [k for k in z.files if k.startswith("params/")]
    return _nest([tuple(k[len("params/"):].split("/")) for k in keys], [z[k] for k in keys])


def _flat_paths(tree: dict, prefix: tuple = ()) -> list[tuple[str, ...]]:
    out = []
    for k, v in tree.items():
        out.extend(_flat_paths(v, prefix + (k,)) if isinstance(v, dict) else [prefix + (k,)])
    return out


def _nest(paths, leaves) -> dict:
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf
    return tree


def trainable_flax_paths(tree: dict, train_cfg) -> list[tuple[str, ...]]:
    """The flax paths of the parameters the JAX trainer optimizes, in
    `jax.tree_util` order (dict keys sorted at every level): all of them
    for an SFNO, the film-trainable subset (`film_trainable_predicate` with
    the config's retrain_film) for a filmed one."""
    from msfno_torch.training.partition import film_trainable_predicate

    paths = _flat_paths(tree)
    if "film_gen" in tree or "film_head" in tree:
        num_layers = sum(1 for k in tree if re.fullmatch(r"blocks_\d+", k))
        pred = film_trainable_predicate(train_cfg.retrain_film, num_layers)
        paths = [p for p in paths if pred(p)]
    return sorted(paths)


def jax_opt_state(leaves: list[np.ndarray], tree: dict, train_cfg, step: int = 0) -> dict:
    """The optax state of `msfno_tpu.training.optim.create_optimizer(
    train_cfg)` as this package's `Optimizer` state (CPU tensors).

    The JAX `.npz` stores the state's leaves as `opt_state/{i}` in
    `jax.tree_util.tree_flatten` order and no tree structure, so the order
    is rebuilt from the train config and the trainable parameters'
    flax paths (`trainable_flax_paths`, N of them, dict keys sorted):

      optax.MultiSteps (accumulation_steps > 0) first:
          mini_step, gradient_step, <inner>, acc_grads x N
          (MultiStepsState's fields; its skip_state () has no leaf)
      <inner> = the chain of create_optimizer:
          adam / adamw: ScaleByAdamState count, mu x N, nu x N
                        (adamw's add_decayed_weights: EmptyState, no leaf)
          sgd:          TraceState trace x N
          then, for schedule cosine / step, ScaleByScheduleState count
          (schedule none: optax.scale's EmptyState, no leaf).

    The moments map to this package's names through
    `convert.from_flax_params`, layout changes included.  A chain other
    than these, or a leaf count or shape that disagrees, raises
    ValueError."""
    from msfno_torch.convert import from_flax_params

    opt, sched, acc = train_cfg.optimizer, train_cfg.scheduler, train_cfg.accumulation_steps
    if opt not in OPTIMIZERS or sched not in SCHEDULERS:
        raise ValueError(f"no optax chain is known for optimizer={opt!r}, scheduler={sched!r}")
    paths = trainable_flax_paths(tree, train_cfg)
    n, pos = len(paths), 0

    def take(k):
        nonlocal pos
        out = leaves[pos:pos + k]
        if len(out) != k:
            raise ValueError(f"optax state: {len(leaves)} leaves, fewer than the chain of "
                             f"{opt}/{sched}/accumulation_steps={acc} over {n} parameters")
        pos += k
        return out

    def counts(k):
        vals = take(k)
        if any(np.ndim(v) for v in vals):
            raise ValueError(f"optax state: an array where the chain of {opt}/{sched}/"
                             f"accumulation_steps={acc} has a count")
        return [int(v) for v in vals]

    def moments(arrays):
        for path, a in zip(paths, arrays):
            node = tree
            for p in path:
                node = node[p]
            if np.shape(node) != np.shape(a):
                raise ValueError(f"optax state: leaf of shape {np.shape(a)} for parameter "
                                 f"{'/'.join(path)} of shape {np.shape(node)}")
        return from_flax_params(_nest(paths, arrays))

    multi = acc > 0
    if multi:
        mini_step, gradient_step = counts(2)
    inner: dict = {}
    if opt == "sgd":
        inner["trace"] = moments(take(n))
    else:
        count = counts(1)[0]
        inner.update(count=count, mu=moments(take(n)), nu=moments(take(n)))
    if sched != "none":
        inner["sched_count"] = counts(1)[0]
    else:  # a constant rate: the count of applied updates
        inner["sched_count"] = inner.get("count", gradient_step if multi else int(step))
    state = {"inner": inner}
    if multi:
        state.update(mini_step=mini_step, gradient_step=gradient_step, acc=moments(take(n)))
    if pos != len(leaves):
        raise ValueError(f"optax state: {len(leaves)} leaves, the chain of "
                         f"{opt}/{sched}/accumulation_steps={acc} over {n} parameters "
                         f"takes {pos}")
    return state


def load_checkpoint(path: str, with_opt_state: bool = False, train_cfg=None, convert=None):
    """Returns (params, opt_state or None, meta).  A JAX `.npz` checkpoint
    gives its parameters under this package's names (through `convert`, a
    flax tree -> state_dict function, by default `from_flax_params`: the
    SFNO family's) and, with `with_opt_state`, its optax state mapped by
    `jax_opt_state`, which needs the run's `TrainConfig` (`train_cfg`) to
    order the leaves.  An Orbax directory goes through
    `orbax_ckpt.load_checkpoint_orbax` with the same arguments."""
    from msfno_torch.convert import from_flax_params

    if is_orbax_dir(path):
        return load_checkpoint_orbax(path, with_opt_state, train_cfg, convert)
    convert = convert or from_flax_params
    _not_a_checkpoint_dir(path)
    if _is_npz(path):
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta/json"]).decode())
            tree = _npz_tree(z)
            opt_state = None
            if with_opt_state and "meta/opt_num_leaves" in z.files:
                if train_cfg is None:
                    raise ValueError(
                        f"{path}: the optax state's leaf order comes from the train "
                        "config; pass train_cfg=")
                leaves = [z[f"opt_state/{i}"] for i in range(int(z["meta/opt_num_leaves"]))]
                opt_state = jax_opt_state(leaves, tree, train_cfg, meta.get("step", 0))
            return convert(tree), opt_state, meta
    ckpt = _load(path)
    return ckpt["params"], ckpt["opt_state"] if with_opt_state else None, ckpt["meta"]


def merge_film_checkpoint(backbone_params: dict, film_params: dict) -> dict:
    """Overlay film-generator weights onto a backbone state_dict (reference
    film-weights merge, sfno/model.py:909-912, 983-1005)."""
    return {**backbone_params, **film_params}
