"""Parameter partitioning for FiLM fine-tuning (port of
msfno_tpu/training/partition.py:21-65).

The reference freezes the pretrained SFNO with requires_grad=False on
everything except the film generator (or {film_gen, decoder, the last
blocks} under --retrain-film; MSFNO/Models/sfno/model.py:922-923,
1016-1026).  Here the JAX package's predicate runs on this package's
parameter names, mapped to the JAX top-level names (`blocks.{i}` ->
`blocks_{i}`), and freezing is `requires_grad_(False)`.
"""

from __future__ import annotations

from typing import Callable

import torch


def film_trainable_predicate(
    retrain_film: bool = False, num_layers: int = 12, retrain_blocks: int = 1
) -> Callable[[tuple[str, ...]], bool]:
    """Which parameter paths (JAX-style tuples) train during film
    fine-tuning: the film generator (and a mae film head); with
    retrain_film, also the decoder and the last `retrain_blocks` blocks."""
    unfrozen_blocks = {
        f"blocks_{i}" for i in range(num_layers - retrain_blocks, num_layers)
    }

    def predicate(path: tuple[str, ...]) -> bool:
        top = path[0]
        if top in ("film_gen", "film_head"):
            return True
        if retrain_film and (top == "decoder" or top in unfrozen_blocks):
            return True
        return False

    return predicate


def jax_path(name: str) -> tuple[str, ...]:
    """A state_dict name as the JAX package's top-level path:
    "blocks.11.norm1.weight" -> ("blocks_11", "norm1", "weight")."""
    parts = name.split(".")
    if parts[0] == "blocks" and len(parts) > 1:
        return (f"blocks_{parts[1]}", *parts[2:])
    return tuple(parts)


def split_params(model: torch.nn.Module, predicate) -> tuple[dict, dict]:
    """(trainable, frozen) name -> Parameter dicts, by the predicate on each
    parameter's JAX-style path; frozen parameters get requires_grad False,
    trainable ones True."""
    trainable, frozen = {}, {}
    for name, p in model.named_parameters():
        keep = predicate(jax_path(name))
        p.requires_grad_(keep)
        (trainable if keep else frozen)[name] = p
    return trainable, frozen


def count_params(params: dict) -> int:
    return sum(p.numel() for p in params.values())
