"""Hand-written CUDA kernels for Hopper (sm_90a) and their plain versions.

Each kernel lives in `msfno_torch/csrc/<name>.cu` with a plain C interface.
At first use it is compiled with nvcc into a shared library under
`msfno_torch/_build/` and loaded with ctypes; pointers and the stream go in
as `c_void_p`, and each C function returns `cudaGetLastError()`, which the
wrapper turns into an exception.  Nothing is compiled at import time, so the
package imports on a machine without nvcc or a card.

Each wrapper module (one per name in `KERNELS`) holds the
kernel's plain PyTorch version, used for tensors on the CPU, and a launch
counter: a CUDA tensor always goes to the kernel, or the wrapper raises.
The forward wrappers are `torch.autograd.Function`s whose backward is what
the JAX package's `custom_vjp` does: a backward kernel (`*_bwd`) where the
JAX package has one, else the VJP of the fp32 reference; the two DFT
kernels, which JAX cannot differentiate, raise in their backward.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
KERNELS = ("spectral_mlp", "grid_mlp", "gcn_layer", "grid_encoder_spectral",
           "spectral_decoder", "gcn_layer_bwd", "spectral_decoder_bwd", "spectral_mlp_bwd",
           "dft_analysis", "dft_synthesis")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def _library_path(name: str) -> Path:
    # the shared headers are part of every kernel's source
    src = b"".join(p.read_bytes() for p in
                   [CSRC_DIR / f"{name}.cu", *sorted(CSRC_DIR.glob("*.cuh"))])
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile_command(name: str, out: Path, verbose: bool) -> list[str]:
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(CSRC_DIR / f"{name}.cu")]
    if verbose:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build(names=KERNELS, verbose: bool = False) -> dict[str, str]:
    """Compile the named kernels that are not built yet, one nvcc process per
    source, all started together.  Returns nvcc's output per kernel built
    (with `verbose`, ptxas' register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (
            subprocess.Popen(
                _compile_command(name, tmp, verbose),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ),
            tmp, out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel `name`, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        path = _library_path(name)
        if not path.exists():
            build((name,))
        lib = _LIBS[name] = ctypes.CDLL(str(path))
    return lib


def check(status: int, name: str) -> None:
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status}")


def kernel_operand(t: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(contiguous tensor, is_bf16) in a dtype the kernels read: bf16 stays,
    any other dtype becomes fp32."""
    if t.dtype not in (torch.float32, torch.bfloat16):
        t = t.float()
    return t.contiguous(), int(t.dtype == torch.bfloat16)


def operand_dtype(mxu_dtype: str) -> torch.dtype:
    """The kernels' operand type for a matmul knob: bf16 for "bfloat16";
    fp32 for "float32" and "tensorfloat" (the JAX package's
    `kernel_mxu_dtype`, msfno_tpu/ops/pallas/__init__.py:1-10, maps both to
    its fp32 kernels).  The fp32 kernels compute fp32-class products: true
    fp32 FMA on the CUDA cores, or, in `spectral_mlp` and the tail's
    backward, three TF32 tensor-core passes over hi / lo splits
    (`tf32x3`), never one TF32 pass."""
    if mxu_dtype == "bfloat16":
        return torch.bfloat16
    if mxu_dtype in ("float32", "tensorfloat"):
        return torch.float32
    raise ValueError(f"unknown mxu dtype {mxu_dtype!r}")


def check_prepared(name: str, tensors, mxu_dtype: str) -> None:
    """Raise unless the prepared operands `tensors` are of the operand type
    of `mxu_dtype`: a bf16 pack never reaches an fp32 kernel, nor the
    reverse."""
    want = operand_dtype(mxu_dtype)
    got = {t.dtype for t in tensors}
    if got != {want}:
        raise ValueError(f"{name}: prepared operands of {sorted(map(str, got))} for "
                         f"{mxu_dtype!r} operands ({want}): pass prepare(..., {mxu_dtype!r})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def reference_vjp(fn, inputs, needs, grads):
    """Gradients of `fn(*inputs)` (a tensor or a tuple of tensors) at the
    cotangents `grads` (None: no cotangent) for the inputs flagged in
    `needs`, by autograd through `fn`: the VJP of a plain fp32 reference.
    Returns one entry per input, None where not needed."""
    with torch.enable_grad():
        leaves = [
            t.detach().requires_grad_(bool(n)) if t is not None else None
            for t, n in zip(inputs, needs)
        ]
        outs = fn(*leaves)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g.to(o.dtype)) for o, g in zip(outs, grads) if g is not None]
        wanted = [t for t, n in zip(leaves, needs) if n and t is not None]
        got = iter(torch.autograd.grad(
            [o for o, _ in pairs], wanted, [g for _, g in pairs], allow_unused=True
        ))
    out = []
    for t, n in zip(inputs, needs):
        if n and t is not None:
            d = next(got)
            out.append(torch.zeros_like(t) if d is None else d.to(t.dtype))
        else:
            out.append(None)
    return out


def strided_sum(part: torch.Tensor) -> torch.Tensor:
    """(B, n, C) -> (B, C) in the order of `stats_reduce` (csrc/tile_common.cuh),
    the kernels' fixed-order reduce of per-block partials: rows i, i + 8, ...
    for each i < 8, then the 8 sums in order.  A plain mirror for the
    tests."""
    lanes = part.new_zeros((part.shape[0], 8, part.shape[2]))
    for i in range(part.shape[1]):
        lanes[:, i % 8] += part[:, i]
    out = part.new_zeros((part.shape[0], part.shape[2]))
    for i in range(8):
        out += lanes[:, i]
    return out


TILE_ROWS = 128  # rows a statistics tile (CH_BM, chain_gemm.cuh; F32_BM, TF3_BM, row_gemm.cuh)
REDUCE_GROUPS = 64  # runs of partials the kernels add first, then add the runs


def reduce_groups(n: int) -> tuple[int, int]:
    """(runs, partials per run) of the kernels' two-level sum of n partials
    (`tile_reduce`, then `stats_reduce`)."""
    per = -(-n // min(REDUCE_GROUPS, n))
    return -(-n // per), per


def stats_scratch(samples: int, rows_per_sample: int, c: int, dev):
    """The kernels' statistics buffers for samples of `rows_per_sample` rows
    and c channels: ([part_sum, part_sq] (samples, tiles, c) per 128-row
    tile, [grp_sum, grp_sq] (samples, groups, c) per run of tiles, [ssum,
    ssq] (samples, c)), and the number of runs (`reduce_groups`)."""
    tiles = -(-rows_per_sample // TILE_ROWS)
    groups, _ = reduce_groups(tiles)
    bufs = [torch.empty(shape, device=dev) for shape in
            [(samples, tiles, c)] * 2 + [(samples, groups, c)] * 2 + [(samples, c)] * 2]
    return bufs, groups


def tile_stats_reduce(part: torch.Tensor) -> torch.Tensor:
    """Plain mirror of the kernels' two-level fixed-order sum of their (B, n,
    C) partials (tests only): each run of partials (`reduce_groups`) in
    `stats_reduce`'s order, then the runs in that order."""
    groups, per = reduce_groups(part.shape[1])
    runs = [strided_sum(part[:, g * per:(g + 1) * per]) for g in range(groups)]
    return strided_sum(torch.stack(runs, dim=1))


def _wrappers() -> dict:
    import importlib

    return {name: importlib.import_module(f"msfno_torch.ops.kernels.{name}")
            for name in KERNELS}


def launch_counts() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in _wrappers().items()}


def reset_launch_counts() -> None:
    for mod in _wrappers().values():
        mod.LAUNCHES = 0
