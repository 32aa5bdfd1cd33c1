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
    bf16 x bf16 GEMM with fp32 accumulation.  With `out_dtype` fp32 it
    keeps an fp32 output, as the JAX package's one-pass bf16 matmul
    (`preferred_element_type`) does: on a card one `torch.bmm(...,
    out_dtype=torch.float32)`, on the CPU an fp32 matmul of the
    bf16-rounded operands (bf16 x bf16 products are exact in fp32: the
    same function).  With `out_dtype` None or bf16 the GEMM's output is
    bf16, which costs nothing where the result feeds a matmul that rounds
    its operand to bf16 anyway (a DFT output into the Legendre matmul, the
    Legendre synthesis into the inverse DFT)."""
    if mxu_dtype == "bfloat16":
        a16, b16 = a.to(torch.bfloat16), b.to(torch.bfloat16)
        if out_dtype != torch.float32:
            y = torch.matmul(a16, b16)
        elif a.is_cuda:
            y = _bmm_fp32_out(a16, b16)
        else:
            y = torch.matmul(a16.float(), b16.float())
    elif mxu_dtype in ("float32", "tensorfloat"):
        y = torch.matmul(a.float(), b.float())
    else:
        raise ValueError(f"unknown mxu dtype {mxu_dtype!r}")
    return y if out_dtype is None else y.to(out_dtype)


def _bmm_fp32_out(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 (..., m, k) and (..., k, n), broadcast over the leading
    dimensions, as one bf16 GEMM with fp32 sums and fp32 output."""
    if a.dim() < 2 or b.dim() < 2:
        raise ValueError("mxu_matmul takes matrices (at least 2-D)")
    batch = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    a3 = a.expand(*batch, *a.shape[-2:]).reshape(-1, *a.shape[-2:])
    b3 = b.expand(*batch, *b.shape[-2:]).reshape(-1, *b.shape[-2:])
    y = _Bf16BmmFp32Out.apply(a3, b3)
    return y.reshape(*batch, a.shape[-2], b.shape[-1])


class _Bf16BmmFp32Out(torch.autograd.Function):
    """bf16 batched product with fp32 output (`torch.bmm(..., out_dtype=)`
    has no derivative).  The gradients are the bf16 GEMMs that autograd
    ran through the bf16-output product before: the cotangent rounded to
    bf16, bf16 output."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g16 = g.to(torch.bfloat16)
        da = torch.bmm(g16, b.transpose(1, 2)) if ctx.needs_input_grad[0] else None
        db = torch.bmm(a.transpose(1, 2), g16) if ctx.needs_input_grad[1] else None
        return da, db


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
