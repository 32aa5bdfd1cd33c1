"""Checkpoint-list skill evaluation (port of
msfno_tpu/inference/eval_checkpoints.py; reference --eval-model path:
main.py:303-337 selects an equidistant checkpoint subset;
FourCastNetv2_filmed.evaluate_model, sfno/model.py:1292-1486, rolls each out
against validation data, computes per-variable MSE in real and normalized
space and skill against climatology, then saves arrays and PDF plots).

The rollout runs on the module's device, step by step: each step's
forecast is denormalised and scored there (`evaluate.SkillSums`) and then
dropped, so a lead of S steps holds one state at a time, never S of them,
and nothing of a forecast crosses to the host.  Targets go to the device
one step at a time.
"""

from __future__ import annotations

import glob
import logging
import os
import re

import numpy as np
import torch

from msfno_torch.data.normalization import Normalizer
from msfno_torch.inference.evaluate import (
    SkillReport,
    SkillSums,
    climatology_step,
    is_binned,
)
from msfno_torch.inference.rollout import _states
from msfno_torch.runtime import resolve_device

log = logging.getLogger("msfno_torch")

# this package's trainer names its checkpoints checkpoint_iter={i}_epoch={e}.pt
# (an Orbax directory: the same name without a suffix)
CHECKPOINT_SUFFIXES = (".npz", ".pt")


def load_eval_params(path: str) -> tuple[dict, dict]:
    """(state_dict, meta) of any checkpoint this package reads: its own
    `.pt`, a JAX `.npz`, an Orbax directory, or a reference PyTorch
    checkpoint (`weights.tar` and the reference Trainer's saves,
    sfno/model.py:207-271; no meta)."""
    from msfno_torch.models.registry import read_checkpoint

    params, meta, _ = read_checkpoint(path)
    return params, meta


def _checkpoint_sort_key(path: str) -> tuple:
    """Numeric (iter, epoch) from 'checkpoint_iter={i}_epoch={e}...' names:
    the trainers write unpadded ints, so a lexicographic sort would put
    iter=100 before iter=20; unparseable names sort last, by name."""
    m = re.search(r"iter=(\d+)", os.path.basename(path))
    e = re.search(r"epoch=(\d+)", os.path.basename(path))
    if m:
        return (0, int(m.group(1)), int(e.group(1)) if e else 0, path)
    return (1, 0, 0, path)


def select_checkpoints(pattern: str, max_count: int = 5) -> list[str]:
    """Equidistant subset of the matching checkpoints, `.npz` files, this
    package's `.pt` files and Orbax directories (reference main.py:305-322;
    msfno_tpu/inference/eval_checkpoints.py:69-75), in training-iteration
    order."""
    from msfno_torch.training.orbax_ckpt import is_orbax_dir

    files = sorted((f for f in glob.glob(pattern)
                    if (f.endswith(CHECKPOINT_SUFFIXES) and os.path.isfile(f))
                    or is_orbax_dir(f)),
                   key=_checkpoint_sort_key)
    if len(files) <= max_count:
        return files
    idx = np.linspace(0, len(files) - 1, max_count).round().astype(int)
    return [files[i] for i in sorted(set(idx))]


def _load_into(module: torch.nn.Module, path: str, params: dict, reference: bool) -> None:
    result = module.load_state_dict(params, strict=not reference)
    if reference and (result.missing_keys or result.unexpected_keys):
        log.warning("eval: %s: keys not loaded (strict=False): missing %s, unexpected %s",
                    path, result.missing_keys[:10], result.unexpected_keys[:10])


def _score_batch(module, batch, steps, sums, climatology, binned, normalizer,
                 sst_normalizer, scale, dev, mesh=None) -> None:
    """Roll one batch out step by step and add each step's sums: the
    forecast denormalised on the device, the target brought over alone."""
    sst_seq = batch.sst[1:steps + 1] if batch.sst is not None else None
    target_shape = (steps,) + tuple(batch.era5.shape[1:])
    times = getattr(batch, "times", None)
    # no valid times (synthetic data carries 0): the binned climatology's mean
    times = (np.asarray(times)[1:steps + 1] if times is not None
             else np.zeros(target_shape[:2], np.int64))
    states = _states(module, batch.era5[0], steps, sst_seq, normalizer, sst_normalizer, scale,
                     mesh)
    with torch.inference_mode():
        for k, state in enumerate(states):
            out_n = state.float()
            target = torch.as_tensor(np.asarray(batch.era5[k + 1]), device=dev).float()
            clim = climatology_step(climatology, k, target_shape, times, dev, binned)
            sums.add(k, normalizer(out_n, reverse=True), target, clim, out_n,
                     normalizer(target))


def evaluate_checkpoints(
    module: torch.nn.Module,
    checkpoint_files: list[str],
    batches,
    climatology,
    steps: int,
    normalizer: Normalizer | None = None,
    sst_normalizer=None,
    save_path: str | None = None,
    film_scales: dict[str, float] | None = None,
    include_sfno_baseline: bool = False,
    device=None,
    mesh=None,
) -> dict[str, SkillReport]:
    """Roll out each checkpoint over `batches` and score skill against
    climatology.

    batches: Batch objects with era5 (S >= steps + 1, B, H, W, C).  Each
    checkpoint is loaded into `module` (moved to `device`: CUDA unless
    "cpu" is asked for), at its meta's film_scale unless `film_scales`
    names one.  With include_sfno_baseline, the first checkpoint is also
    evaluated at film scale 0, the pure-SFNO reference (--eval-sfno,
    model.py:1346-1354), named "<file>@scale0".  A name met twice gets its
    directory as a prefix.  climatology: broadcastable to the targets
    (static, e.g. (H, W, C), or per step) or (doy, hour)-binned
    ((365|366, 4, H, W, C)), indexed by each batch's valid times.  With
    `mesh`, every rollout runs under it (each rank its band; the outputs
    gathered, the sums the same on every rank)."""
    from msfno_torch.models.registry import read_checkpoint

    dev = resolve_device(device)
    module.to(dev)
    batches = list(batches)  # iterated once per checkpoint
    if not batches:
        raise ValueError("evaluate_checkpoints: no validation batches")
    channels = batches[0].era5.shape[-1]
    normalizer = normalizer or Normalizer.identity(channels)
    # the targets of every batch concatenated, as the JAX package scores them
    target_shape = (steps, sum(b.era5.shape[1] for b in batches)) + batches[0].era5.shape[2:]
    binned = is_binned(climatology, target_shape)
    if not binned:  # on the device once; a binned one is indexed on the host
        climatology = torch.as_tensor(climatology, device=dev).float()

    runs = [(cp, None) for cp in checkpoint_files]
    if include_sfno_baseline and checkpoint_files:
        runs.insert(0, (checkpoint_files[0], 0.0))
    reports: dict[str, SkillReport] = {}
    loaded = None  # the baseline reuses the first checkpoint: load it once
    for cp, scale_override in runs:
        if loaded != cp:
            params, meta, reference = read_checkpoint(cp)
            _load_into(module, cp, params, reference)
            del params
            loaded = cp
        scale = (scale_override if scale_override is not None
                 else (film_scales or {}).get(cp, meta.get("film_scale", 1.0)))
        sums = SkillSums(steps, channels, dev)
        for batch in batches:
            _score_batch(module, batch, steps, sums, climatology, binned, normalizer,
                         sst_normalizer, scale, dev, mesh)
        name = os.path.basename(cp) + ("" if scale_override is None else "@scale0")
        if name in reports:
            parent = os.path.basename(os.path.dirname(cp)) or str(len(reports))
            name = f"{parent}/{name}".replace(os.sep, "_")
        reports[name] = sums.report()
        log.info("%s: mean skill %.4f, mean ACC %.4f", name,
                 float(np.mean(reports[name].skill)), float(np.mean(reports[name].acc)))
        if save_path:
            os.makedirs(save_path, exist_ok=True)
            reports[name].save(os.path.join(save_path, name))
    if save_path:
        plot_skill(reports, save_path)
    return reports


def plot_skill(reports: dict[str, SkillReport], save_path: str,
               variable_names: list[str] | None = None):
    """Per-variable skill / MSE / ACC PDF plots (reference
    model.py:1454-1482); logs and returns when matplotlib is missing."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover
        log.warning("matplotlib unavailable; skipping plots")
        return
    for metric in ("skill", "mse_model", "acc"):
        if any(getattr(rep, metric, None) is None for rep in reports.values()):
            continue
        fig, ax = plt.subplots(figsize=(8, 4))
        for name, rep in reports.items():
            ax.plot(np.mean(getattr(rep, metric), axis=-1), marker="o", label=name)
        ax.set_xlabel("lead step")
        ax.set_ylabel(metric)
        ax.legend(fontsize=6)
        fig.tight_layout()
        fig.savefig(os.path.join(save_path, f"{metric}.pdf"))
        plt.close(fig)
