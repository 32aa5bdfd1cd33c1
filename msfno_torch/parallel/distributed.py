"""Process-group bootstrap and scaling measurement (port of
msfno_tpu/parallel/distributed.py).

Replaces the reference's mp.spawn + init_process_group("nccl") launcher
(main.py:39-49, 1149-1156): one process per card, started by torchrun (or
given an address, a rank and a world size), joined into one
torch.distributed group: NCCL on the card, gloo on the CPU.
"""

from __future__ import annotations

import logging
import os
import time

import torch
import torch.distributed as dist

log = logging.getLogger("msfno_torch")

def world_size_hint() -> int:
    """The number of processes, without initialising anything: an
    initialised group's world size, else torchrun's WORLD_SIZE, SLURM_NTASKS,
    OMPI_COMM_WORLD_SIZE, else 1.  Used for the reference's world-size
    division of the scheduler horizon (main.py:136) before any device work."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    for var in ("WORLD_SIZE", "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE"):
        try:
            n = int(os.environ.get(var, "1"))
        except ValueError:
            continue
        if n > 1:
            return n
    return 1


def torchrun_env() -> bool:
    return all(v in os.environ for v in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"))


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, device=None) -> dict:
    """Join the default process group, once: at `tcp://coordinator_address`
    with the given rank and world size, or through torchrun's environment
    (`env://`); with neither, nothing is initialised.  The backend is NCCL
    for a CUDA device and gloo for "cpu"; under NCCL the process first
    takes its card (`torch.cuda.set_device(LOCAL_RANK)`), so "cuda" means
    this rank's card.  A failure raises: a rank that trained alone while
    the others wait at the rendezvous is the failure to avoid.  Returns the
    JAX package's info dict (one device per process)."""
    if not dist.is_initialized() and (coordinator_address is not None or torchrun_env()):
        from msfno_torch.runtime import resolve_device

        dev = resolve_device(device)
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if coordinator_address is not None:
            if num_processes is None or process_id is None:
                raise ValueError("--coordinator-address needs --num-processes and --process-id")
            rank, world = int(process_id), int(num_processes)
            init = f"tcp://{coordinator_address}"
        else:
            rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
            init = "env://"
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world)
        log.info("joined a %s group: rank %d of %d", backend, rank, world)
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    info = {"process_index": rank, "process_count": world, "local_devices": 1,
            "global_devices": world}
    log.info("distributed: %s", info)
    return info


def _block(out) -> None:
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def measure_scaling(step_fn, device_counts: list[int], iters: int = 5,
                    mode: str = "weak") -> dict[int, dict]:
    """Throughput against the number of ranks for a mesh-parameterised step.

    step_fn(mesh) -> (callable, args); callable(*args) returns a tensor.
    Each n is measured on a mesh of the first n ranks (a subgroup); the
    other ranks wait at a barrier.  mode:
    - "weak": per-rank work fixed; efficiency = t_base / t_n;
    - "strong": total work fixed; efficiency = (t_base * n_base) / (t_n * n).
    Returns {n: {seconds, rate, efficiency}} relative to the smallest n, the
    same on every rank (rank 0's measurement)."""
    from msfno_torch.parallel.mesh import data_mesh

    if mode not in ("weak", "strong"):
        raise ValueError(f"mode must be 'weak' or 'strong', got {mode!r}")
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    results: dict[int, dict] = {}
    timings: dict[int, float] = {}
    for n in sorted(set(device_counts)):
        if n > world:
            log.warning("skipping %d ranks (world size %d)", n, world)
            continue
        mesh = data_mesh(n)
        if rank < n:
            fn, args = step_fn(mesh)
            _block(fn(*args))
            t0 = time.perf_counter()
            for _ in range(iters):
                out = fn(*args)
            _block(out)
            timings[n] = (time.perf_counter() - t0) / iters
        if dist.is_initialized():
            dist.barrier()
        if rank != 0:
            continue
        dt, n_base = timings[n], min(timings)
        t_base = timings[n_base]
        if mode == "weak":
            efficiency, rate = t_base / dt, n / dt
        else:
            efficiency, rate = (t_base * n_base) / (dt * n), 1.0 / dt
        results[n] = {"seconds": dt, "rate": rate, "efficiency": efficiency}
        log.info("%d ranks (%s): %.4fs/step, efficiency %.1f%%", n, mode, dt, 100 * efficiency)
    if dist.is_initialized():
        box = [results]
        dist.broadcast_object_list(box, src=0)
        results = box[0]
    return results
