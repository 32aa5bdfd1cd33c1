"""Device choice, matmul precision and parameter-derived caches.

Entry points run on CUDA unless the caller asks for the CPU: with no card
and no explicit `device="cpu"` they raise instead of quietly running on the
host.
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA by default, the CPU only when
    asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        exact_fp32_matmuls()
    return device


def exact_fp32_matmuls() -> None:
    """A "float32" knob means true fp32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def torch_dtype(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    try:
        return _DTYPES[str(name)]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


def mxu_round(t: torch.Tensor, mxu_dtype: str) -> torch.Tensor:
    """fp32 copy of `t` rounded to the matmul operand dtype of a knob.

    "float32" and "tensorfloat" keep fp32 operands; "bfloat16" rounds to
    bf16 (round to nearest even), as the JAX kernels' `.astype(mxu_dtype)`
    does before each dot."""
    t = t.float()
    if mxu_dtype == "bfloat16":
        return t.to(torch.bfloat16).float()
    if mxu_dtype in ("float32", "tensorfloat"):
        return t
    raise ValueError(f"unknown mxu dtype {mxu_dtype!r}")


def mxu_matmul(a: torch.Tensor, b: torch.Tensor, mxu_dtype: str,
               out_dtype: torch.dtype | None = torch.float32) -> torch.Tensor:
    """`torch.matmul` under a matmul knob of the JAX package.

    "float32" (and "tensorfloat") is a true fp32 matmul.  "bfloat16" is a
    bf16 x bf16 GEMM with fp32 accumulation whose output torch rounds to
    bf16; the JAX package's one-pass bf16 matmul keeps an fp32 output.  On
    the SHT's chain that extra rounding is nearly free: every DFT output
    feeds a Legendre matmul that rounds its operand to bf16 anyway, the
    Legendre analysis feeds the spectral kernel, which stages its input in
    bf16, and the grid-space result is cast to the bf16 activation dtype.
    The result is cast to `out_dtype`; None keeps the GEMM's own dtype."""
    if mxu_dtype == "bfloat16":
        y = torch.matmul(a.to(torch.bfloat16), b.to(torch.bfloat16))
    elif mxu_dtype in ("float32", "tensorfloat"):
        y = torch.matmul(a.float(), b.float())
    else:
        raise ValueError(f"unknown mxu dtype {mxu_dtype!r}")
    return y if out_dtype is None else y.to(out_dtype)


class DerivedCache:
    """Tensors derived from parameters (transposed, cast, padded, packed) for
    the kernels, rebuilt when a source parameter is replaced, moved or
    modified in place.  Serving keeps its weights, so each is built once."""

    def __init__(self):
        self._entries: dict = {}

    def get(self, key, sources, build):
        stamp = tuple(
            (t.data_ptr(), t._version, t.dtype, t.device) for t in sources
        )
        hit = self._entries.get(key)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        with torch.no_grad():
            value = build()
        self._entries[key] = (stamp, value)
        return value
