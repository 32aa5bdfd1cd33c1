"""Complex contractions of the spectral filters on real pairs (port of
msfno_tpu/ops/contractions.py; reference MSFNO/Models/sfno/contractions.py).

Activations are the port's (2, ..., C) [re, im] fp32 layout; weights are in
the JAX package's layout with the trailing real pair (..., 2).  Each complex
product is four real einsums with fp32 accumulation, in the JAX package's
contraction order: re = ar br - ai bi, im = ar bi + ai br.
"""

from __future__ import annotations

import torch

from msfno_torch.runtime import mxu_round


def _ceinsum(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Complex einsum over real pairs: `a`, `b` are (2, ...) stacks."""
    f = lambda x, y: torch.einsum(spec, x, y)  # noqa: E731
    return torch.stack([f(a[0], b[0]) - f(a[1], b[1]), f(a[0], b[1]) + f(a[1], b[0])])


def _pair(w: torch.Tensor) -> torch.Tensor:
    """(..., 2) real-pair weight storage -> (2, ...) fp32."""
    return w.float().movedim(-1, 0)


def compl_mul(x: torch.Tensor, w: torch.Tensor, mxu_dtype: str = "float32") -> torch.Tensor:
    """Mode-shared channel mixing (reference compl_mul2d_fwd_c):
    x (2, ..., C_in), w (C_in, C_out, 2) -> (2, ..., C_out), operands rounded
    to `mxu_dtype` (the JAX package's matmul precision of that knob)."""
    return _ceinsum("...i,io->...o", mxu_round(x, mxu_dtype), mxu_round(_pair(w), mxu_dtype))


def compl_contract_dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-mode dense mixing (reference compl_contract2d_fwd_c):
    x (2, ..., L, M, C_in), w (L, M, C_in, C_out, 2) -> (2, ..., L, M, C_out)."""
    return _ceinsum("...lmi,lmio->...lmo", x.float(), _pair(w))


def compl_contract_tril(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Per-mode mixing over the gathered l >= m modes (reference
    compl_contract_fwd_c): x (2, ..., K, C_in), w (K, C_in, C_out, 2) ->
    (2, ..., K, C_out)."""
    return _ceinsum("...ki,kio->...ko", x.float(), _pair(w))


def contract_tt(x: torch.Tensor, g1: torch.Tensor, g2: torch.Tensor,
                g3: torch.Tensor) -> torch.Tensor:
    """Tensor-train compressed per-mode mixing (reference contract_tt,
    "oi,icj,jbct->bot"): out[k, o] = sum_{i,c,j} g1[o, i] g2[i, c, j]
    g3[j, k] x[k, c].  g1's FIRST axis is the output channel and g2's middle
    axis the input channel.

    x (2, ..., K, C); g1 (C, R, 2) [o, i]; g2 (R, C, R, 2) [i, c, j]; g3
    (R, K, 2) [j, k].  x is absorbed into g2 first (a (..., K, R, R) peak
    intermediate), then g3, then g1, as in the JAX package."""
    z = _ceinsum("icj,...kc->...kij", _pair(g2), x.float())
    u = _ceinsum("...kij,jk->...ki", z, _pair(g3))
    return _ceinsum("...ki,oi->...ko", u, _pair(g1))
