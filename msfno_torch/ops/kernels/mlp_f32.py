"""Host side of the fp32-operand pointwise MLP (csrc/mlp_f32.cuh), which
`grid_mlp`, the fused head and the fused tail launch on fp32 operands: the
arrays of its MlpPtr and MlpInt layouts, and the call of an entry point
that takes them (`grid_mlp_f32`, `grid_encoder_spectral_f32`,
`spectral_decoder_f32`).  No kernel library of its own: the header is part
of those three."""

from __future__ import annotations

import ctypes

import torch

from msfno_torch.ops.kernels import check, kernel_operand, library, stats_scratch

_ENTRIES: dict = {}  # (library handle, entry) -> its bound ctypes function


def mlp_args(x, w1p, b1, w2p, b2=None, skip=None, pe=None, affine=(None, None),
             residual=None, out=None, samples=1, stats=False):
    """The arrays that the fp32 MLP reads: x (rows, C_main) contiguous fp32
    or bf16 (the tail's fp32 grid-field scratch); w1p, w2p the fp32
    `grid_mlp.prepare_weights`; skip, pe, residual as `grid_mlp` takes them;
    affine (A, B), each (samples, C_main) fp32, or Nones; out (rows, C_out)
    fp32 or bf16, allocated by the caller.  The rows are `samples` samples
    (the GEMMs' row segments); `stats` asks for their sums.  Allocates h and
    the statistics' scratch.  Returns (pointer list, integer list, the
    tensors the pointers name, which the caller keeps until the launch is
    enqueued, and (ssum, ssq) or None)."""
    rows, c_main = x.shape
    hidden, c_out = w2p.shape
    dev = x.device

    def rows_of(t):
        return kernel_operand(t.reshape(-1, t.shape[-1])) if t is not None else (None, 0)

    skf, skip_bf16 = rows_of(skip)
    pef, pe_bf16 = rows_of(pe)
    rsf, res_bf16 = rows_of(residual)
    h = torch.empty((rows, hidden), device=dev)
    scratch, groups = [None] * 6, 1
    if stats:
        scratch, groups = stats_scratch(samples, rows // samples, c_out, dev)
    keep = [x, skf, affine[0], affine[1], w1p, b1.float().contiguous(), w2p,
            b2.float().contiguous() if b2 is not None else None, pef, rsf, out, h, *scratch]
    ptrs = [t.data_ptr() if t is not None else None for t in keep]
    ints = [samples, rows // samples, pef.shape[0] if pef is not None else 0, c_main,
            w1p.shape[0] - c_main, hidden, c_out, groups, int(x.dtype == torch.bfloat16),
            skip_bf16, pe_bf16, res_bf16, int(out.dtype == torch.bfloat16)]
    return ptrs, ints, keep, tuple(scratch[4:]) if stats else None


def launch(name: str, entry: str, ptrs, ints, stream: int) -> None:
    """Call `entry` of kernel library `name` with (pointer list, integer
    list, stream) and raise on its CUDA error.  Its argument types are bound
    once."""
    lib = library(name)
    fn = _ENTRIES.get((lib._handle, entry))  # the library now loaded under `name`
    if fn is None:
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _ENTRIES[(lib._handle, entry)] = fn
    status = fn((ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(ints))(*ints),
                stream)
    check(status, name)
