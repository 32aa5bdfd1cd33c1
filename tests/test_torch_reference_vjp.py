"""The gradients of the port's grid_mlp and grid_encoder_spectral Functions,
which have no backward kernel in the JAX package either: the VJP of the fp32
reference, held against jax.grad of the JAX public functions (Pallas in
interpret mode on the CPU) for every differentiable input."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import grid_encoder_spectral as tenc
from msfno_torch.ops.kernels import grid_mlp as tmlp
from msfno_torch.ops.sht import RealSHT

torch.set_num_threads(2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def report(name, value):
    """The measured error, for the parity table (pytest -s shows it)."""
    print(f"parity {name} rel_l2={value:.3e}")
    return value


def _grads(jax_fn, torch_fn, ops, names, cotangents):
    """jax.grad and autograd of sum(out_i * cot_i) over the named inputs."""
    import jax
    import jax.numpy as jnp

    def loss_j(*vals):
        outs = jax_fn(**dict(zip(names, vals)))
        outs = outs if isinstance(outs, tuple) else (outs,)
        return sum(jnp.sum(o.astype(jnp.float32) * jnp.asarray(c))
                   for o, c in zip(outs, cotangents))

    gj = jax.grad(loss_j, argnums=tuple(range(len(names))))(
        *[jnp.asarray(ops[k]) for k in names])
    leaves = {k: torch.from_numpy(ops[k]).requires_grad_(True) for k in names}
    outs = torch_fn(**leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    sum((o.float() * torch.from_numpy(c)).sum() for o, c in zip(outs, cotangents)).backward()
    return {k: (leaves[k].grad, g) for k, g in zip(names, gj)}


@pytest.mark.parametrize("site", ["encoder+pe+stats", "inner+b2", "decoder+skip",
                                  "affine+residual"])
def test_grid_mlp_function_matches_jax_grad(site):
    pytest.importorskip("jax")
    from msfno_tpu.ops.pallas.grid_mlp import grid_mlp as jax_grid_mlp

    rng = np.random.default_rng(3)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    ops = dict(x=r(2, 4, 8, 6), w1=0.3 * r(6, 16), b1=0.1 * r(16), w2=0.3 * r(16, 6))
    kw = {}
    if site == "encoder+pe+stats":
        ops["pe"] = 0.1 * r(4, 8, 6)
        kw["stats_rows"] = 32
    elif site == "inner+b2":
        ops["b2"] = 0.1 * r(6)
    elif site == "decoder+skip":
        ops["skip"] = r(2, 4, 8, 3)
        ops["w1"] = 0.3 * r(9, 16)
    else:
        ops["aff_a"], ops["aff_b"] = 1.0 + 0.1 * r(2, 6), 0.1 * r(2, 6)
        ops["residual"] = r(2, 4, 8, 6)
    names = list(ops)
    n_out = 3 if "stats_rows" in kw else 1
    cots = [r(2, 4, 8, 6)] + [r(2, 6) for _ in range(n_out - 1)]

    def call(fn, **t):
        aff = (t.pop("aff_a"), t.pop("aff_b")) if "aff_a" in t else None
        return fn(mxu_dtype="float32", affine=aff, **t, **kw)

    got = _grads(lambda **t: call(jax_grid_mlp, **t), lambda **t: call(tmlp.grid_mlp, **t),
                 ops, names, cots)
    for k, (a, b) in got.items():
        assert report(f"grid_mlp grad[{site}] {k}", rel_l2(a, b)) <= 1e-5


@pytest.mark.parametrize("pe", [True, False])
def test_grid_encoder_spectral_function_matches_jax_grad(pe):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.grid_mlp import grid_encoder_spectral as jax_enc

    rng = np.random.default_rng(4)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    h, w, c = 6, 16, 8
    cs = np.asarray(RealSHT(h, w, lmax=h, mmax=7).merged_analysis, np.float32)
    ops = dict(x=r(2, h, w, 3), w1=0.3 * r(3, 16), b1=0.1 * r(16), w2=0.3 * r(16, c))
    if pe:
        ops["pe"] = 0.1 * r(h, w, c)
    names = list(ops)
    cots = [r(2, h, 14, c), r(2, c), r(2, c)]
    got = _grads(
        lambda **t: jax_enc(t["x"], t["w1"], t["b1"], t["w2"], t.get("pe"), jnp.asarray(cs),
                            mxu_dtype="float32", out_dtype=jnp.float32),
        lambda **t: tenc.grid_encoder_spectral(t["x"], t["w1"], t["b1"], t["w2"], t.get("pe"),
                                               torch.from_numpy(cs), mxu_dtype="float32",
                                               out_dtype="float32"),
        ops, names, cots)
    for k, (a, b) in got.items():
        assert report(f"grid_encoder_spectral grad[pe={pe}] {k}", rel_l2(a, b)) <= 1e-5
