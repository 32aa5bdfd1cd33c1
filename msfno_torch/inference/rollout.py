"""Autoregressive inference rollout (port of msfno_tpu/inference/rollout.py;
reference FourCastNetv2.running(), MSFNO/Models/sfno/model.py:289-372).

The model state stays on the device across steps; each step's output is
fed back as the next input.  Emitted fields are always fp32, whatever the
model's output dtype; the carry keeps the output dtype, and the initial
state is cast to it as well.  With `mesh=` every step runs under it
(`parallel.annotate.use_mesh`): each rank of a (lat, channel) model group
takes its band of the state, and the step's output comes back gathered,
the same on every rank; the parameters may be whole or held as shards.
"""

from __future__ import annotations

import dataclasses
import itertools
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np
import torch

from msfno_torch.data.normalization import Normalizer, SSTNormalizer
from msfno_torch.parallel.annotate import use_mesh
from msfno_torch.utils.observability import set_request, span, upload

# forecasts begun in this process: the first part of a rollout step's
# request id (forecast, step)
_forecasts = itertools.count()


@dataclasses.dataclass
class RolloutConfig:
    steps: int  # number of 6h steps (lead_time // 6, model.py:327)
    step_hours: int = 6
    collect_channels: Sequence[int] | None = None  # None = all
    denormalize: bool = True


def serving_params(model: torch.nn.Module, dtype=torch.bfloat16,
                   frozen_only: bool = False) -> torch.nn.Module:
    """Store the model's fp32 parameters in `dtype` (in place) for
    bf16-compute serving: every consumer already rounds its operands to bf16
    on the serving tier, and the stored weights (the 1.06 GB fp32 pos_embed
    above all) halve in size.  Keep fp32 parameters for the exact tier.
    `frozen_only` converts only the parameters that need no gradient (the
    fine-tune trainer's frozen backbone, trainer.py:212-215 in the JAX
    package): trainable ones stay fp32."""
    with torch.no_grad():
        for p in model.parameters():
            if p.dtype == torch.float32 and not (frozen_only and p.requires_grad):
                p.data = p.data.to(dtype)
    return model


def _states(model, x0, steps: int, sst_seq, normalizer, sst_normalizer, scale, mesh=None):
    """The autoregressive loop shared by `rollout` and `scan_rollout`:
    yields each step's state (normalized space, the model's output dtype),
    each step run under `mesh` with the request id (forecast, step).  The
    uploads and normalization of x0 and of each step's SST are
    `rollout.inputs` spans."""
    dev = next(model.parameters()).device
    normalizer = normalizer or Normalizer.identity(x0.shape[-1])
    sstn = sst_normalizer or SSTNormalizer.identity()
    out_dtype = getattr(model, "out_dtype", torch.float32)
    forecast = next(_forecasts)
    with torch.inference_mode():
        set_request((forecast, 0))
        with span("rollout.inputs", dev):
            state = normalizer(upload(x0, dev).float()).to(out_dtype)
        for i in range(steps):
            set_request((forecast, i))
            with use_mesh(mesh):
                if sst_seq is None:
                    state = model(state)
                else:
                    with span("rollout.inputs", dev):
                        sst_i = sstn(upload(sst_seq[i], dev).float())
                    state = model(state, sst_i, scale)
            yield state


def _collect(t: torch.Tensor, channels) -> torch.Tensor:
    if channels is None:
        return t
    return t[..., upload(np.asarray(channels), t.device)]


class _Fetch:
    """The device->host copies of `rollout`'s fields.  On the card a field
    is copied by a side stream, which waits for an event recorded after
    the field's fetch, into one of two pinned staging buffers taken in
    turns; a worker thread waits on that copy's event alone, then copies
    the buffer into a fresh pageable array, the consumer's own, while the
    caller queues the next step.  The caller takes field i (`result`)
    before it queues the copy of field i+2 into the same buffer.
    `record_stream` keeps the field's memory from being handed on before
    the copy has read it.  A host field is already there: `result` gives it
    as `.numpy()`."""

    def __init__(self):
        self.stream, self.pool, self.staging, self.turn = None, None, [None, None], 0

    def __call__(self, out: torch.Tensor):
        if not out.is_cuda:
            host = out.cpu().numpy()
            return lambda: host
        if self.stream is None:
            self.stream = torch.cuda.Stream(out.device)
            self.pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="rollout-fetch")
        buf = self.staging[self.turn]
        if buf is None or buf.shape != out.shape or buf.dtype != out.dtype:
            buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.staging[self.turn] = buf
        self.turn ^= 1
        self.stream.wait_stream(torch.cuda.current_stream(out.device))
        with torch.cuda.stream(self.stream):
            buf.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        out.record_stream(self.stream)

        def to_host() -> np.ndarray:
            done.synchronize()
            return torch.empty(buf.shape, dtype=buf.dtype).copy_(buf).numpy()

        return self.pool.submit(to_host).result

    def close(self) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=True)


def _wait(pending) -> np.ndarray:
    """The fetched field, the consumer's wait in a `rollout.fetch_wait`
    span."""
    with span("rollout.fetch_wait"):
        return pending()


def rollout(model, x0, cfg: RolloutConfig, sst_seq=None,
            normalizer: Normalizer | None = None,
            sst_normalizer: SSTNormalizer | None = None, scale: float = 1.0,
            stepper=None, mesh=None) -> Iterator[np.ndarray]:
    """Streaming rollout on the model's device: yields one (B, H, W, C_collect)
    fp32 numpy field per step (denormalized unless cfg.denormalize=False).
    x0 is the raw initial condition; sst_seq (steps, B, T, Hs, Ws) drives a
    filmed model.

    The fetch runs one step behind, as in the JAX package: step i is run
    and its fetch queued (denormalize, collect, fp32 and, on the card, the
    copy into pinned host memory, `_Fetch`), then step i-1 is yielded and
    `stepper(i, step_hours)` called; the last step is yielded after the
    loop.  So the consumer's work on field i-1 overlaps step i on the
    card, step i's copy overlaps step i+1, and a consumer that stops after
    k fields has run k+1 steps.  The fp32 cast, denormalization, collection
    and queued fetch of a step are a `rollout.outputs` span."""
    normalizer = normalizer or Normalizer.identity(x0.shape[-1])
    states = _states(model, x0, cfg.steps, sst_seq, normalizer, sst_normalizer, scale, mesh)
    fetch, pending = _Fetch(), None
    try:
        for i, state in enumerate(states):
            with span("rollout.outputs", state):
                out = state.float()
                if cfg.denormalize:
                    out = normalizer(out, reverse=True)
                fetched = fetch(_collect(out, cfg.collect_channels))
            if pending is not None:
                yield _wait(pending)
            pending = fetched
            if stepper is not None:
                stepper(i, cfg.step_hours)
        if pending is not None:
            yield _wait(pending)
    finally:
        fetch.close()


def scan_rollout(model, x0, steps: int, sst_seq=None,
                 normalizer: Normalizer | None = None,
                 sst_normalizer: SSTNormalizer | None = None, scale: float = 1.0,
                 collect_channels: Sequence[int] | None = None, mesh=None) -> torch.Tensor:
    """The JAX `scan_rollout` as a loop: returns the stacked
    (steps, B, H, W, C_collect) normalized-space outputs, fp32, on the
    model's device."""
    states = _states(model, x0, steps, sst_seq, normalizer, sst_normalizer, scale, mesh)
    return torch.stack([_collect(s, collect_channels).float() for s in states])
