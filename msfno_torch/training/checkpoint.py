"""Checkpoint I/O (port of msfno_tpu/training/checkpoint.py:52-151,332;
reference MSFNO/Models/train.py:779-819, MSFNO/Models/checkpoint.py:9-57).

This package's format is one `torch.save` file holding the parameters
(state_dict names), the optimizer state, and the JAX package's metadata:
step, epoch, config (JSON) and film_scale.  `load_checkpoint` also reads
the parameters of a JAX-written `.npz` training checkpoint through
`convert.from_flax_params`; its optimizer state and Orbax checkpoint
directories raise NotImplementedError.
"""

from __future__ import annotations

import json
import os
import zipfile
from typing import Any

import numpy as np
import torch

FORMAT_VERSION = 1


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
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


def _check_file(path: str) -> None:
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory: Orbax checkpoints come in a later slice; this "
            "package reads its own files and the JAX package's .npz files"
        )


def _load(path: str) -> dict:
    return torch.load(path, map_location="cpu", weights_only=True, mmap=True)


def peek(path: str) -> dict[str, Any]:
    """Checkpoint metadata without reading tensor data (the file is mapped,
    not read): this package's files and JAX `.npz` files."""
    _check_file(path)
    if _is_npz(path):
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta/json"]).decode())
            meta["keys"] = [k for k in z.files if k.startswith("params/")]
        return meta
    ckpt = _load(path)
    return {**ckpt["meta"], "keys": list(ckpt["params"])}


def _npz_params(z) -> dict[str, torch.Tensor]:
    from msfno_torch.convert import from_flax_params

    tree: dict = {}
    for key in z.files:
        if not key.startswith("params/"):
            continue
        node = tree
        *parents, leaf = key[len("params/"):].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = z[key]
    return from_flax_params(tree)


def load_checkpoint(path: str, with_opt_state: bool = False):
    """Returns (params, opt_state or None, meta).  A JAX `.npz` checkpoint
    gives its parameters under this package's names; asking for its
    optimizer state (optax pytrees) raises NotImplementedError."""
    _check_file(path)
    if _is_npz(path):
        with np.load(path) as z:
            meta = json.loads(bytes(z["meta/json"]).decode())
            if with_opt_state and "meta/opt_num_leaves" in z.files:
                raise NotImplementedError(
                    f"{path}: optimizer state written by the JAX package (optax) is not "
                    "read by this package; resume from its parameters only"
                )
            return _npz_params(z), None, meta
    ckpt = _load(path)
    return ckpt["params"], ckpt["opt_state"] if with_opt_state else None, ckpt["meta"]


def merge_film_checkpoint(backbone_params: dict, film_params: dict) -> dict:
    """Overlay film-generator weights onto a backbone state_dict (reference
    film-weights merge, sfno/model.py:909-912, 983-1005)."""
    return {**backbone_params, **film_params}
