"""spectral_mlp's backward in the PyTorch port: the plain version of the
`spectral_mlp_bwd` kernel against the JAX package's Pallas backward kernel
(`_packed_bwd_call`, interpret mode on the CPU), the autograd Function
against jax.grad of the JAX `spectral_mlp` custom_vjp, and the CUDA kernel
against the plain version on a card."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import spectral_mlp as tk
from msfno_torch.ops.kernels import spectral_mlp_bwd as tb

torch.set_num_threads(2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def report(name, value):
    """The measured error, for the parity table (pytest -s shows it)."""
    print(f"parity {name} rel_l2={value:.3e}")
    return value


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(dims, n=70, seed=0):
    """x2 (N, C_in, 2) and g2 (N, C_out, 2) as the JAX package lays them
    out; weights (in, out, 2)."""
    rng = np.random.default_rng(seed)
    x2 = rng.standard_normal((n, dims[0], 2)).astype(np.float32)
    g2 = rng.standard_normal((n, dims[-1], 2)).astype(np.float32)
    ws = [(0.2 * rng.standard_normal((dims[i], dims[i + 1], 2))).astype(np.float32)
          for i in range(len(dims) - 1)]
    return x2, g2, ws


def _pairs(a2):
    """(N, C, 2) -> the port's (2, N, C) [re, im]."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a2, -1, 0)))


DIMS = {"3 hidden": [16, 32, 32, 32, 16], "1 hidden": [16, 32, 16]}


@pytest.mark.parametrize("mxu,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("slope", [0.0, 0.1])
@pytest.mark.parametrize("layers", list(DIMS))
def test_plain_bwd_matches_jax_kernel(layers, slope, mxu, tol):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.spectral_mlp import _packed_bwd_call

    x2, g2, ws = _case(DIMS[layers])
    flat = []
    for w in ws:
        flat += [jnp.asarray(w[..., 0]), jnp.asarray(w[..., 1])]
    dxr, dxi = _packed_bwd_call(jnp.asarray(x2[..., 0]), jnp.asarray(x2[..., 1]),
                                jnp.asarray(g2[..., 0]), jnp.asarray(g2[..., 1]), *flat,
                                negative_slope=slope, interpret=True, mxu_dtype=mxu)
    dx = tb.spectral_mlp_bwd(_pairs(x2), _pairs(g2), [torch.from_numpy(w) for w in ws],
                             slope, mxu)
    assert dx.shape == (2, 70, 16)
    err = rel_l2(dx, np.stack([np.asarray(dxr), np.asarray(dxi)]))
    assert report(f"spectral_mlp_bwd[{layers},slope={slope},{mxu}]", err) <= tol


def test_mask_words_round_trip():
    """`pack_mask` puts every column of a width that is not a multiple of 128
    in its own bit (the fragment layout), and `unpack_mask` gives it back."""
    rng = np.random.default_rng(3)
    neg = torch.from_numpy(rng.random((5, 272)) < 0.5)
    words = tb.pack_mask(neg)
    assert words.shape == (5, 12) and int(words.max()) < 2 ** 32
    assert torch.equal(tb.unpack_mask(words, 272), neg)
    one = torch.zeros((1, 272), dtype=torch.bool)
    one[0, 128 + 8 * 3 + 2 * 1 + 1] = True  # block 1, q 3, lane quad 1, e 1
    assert tb.pack_mask(one)[0].tolist() == [0] * 5 + [1 << 7] + [0] * 6


@pytest.mark.parametrize("mxu,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("slope", [0.0, 0.1])
@pytest.mark.parametrize("layers", list(DIMS))
def test_layer_mirror_matches_jax_kernel(layers, slope, mxu, tol):
    """The kernel's GEMM sequence (`spectral_mlp_bwd_layers`: one packed GEMM
    per layer, masks packed to bits and unpacked, rounding per layer) against
    the JAX Pallas backward kernel, on a row count that is not a multiple of
    the kernel's 128-row tiles."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.spectral_mlp import _packed_bwd_call

    x2, g2, ws = _case(DIMS[layers], n=200, seed=4)
    flat = []
    for w in ws:
        flat += [jnp.asarray(w[..., 0]), jnp.asarray(w[..., 1])]
    dxr, dxi = _packed_bwd_call(jnp.asarray(x2[..., 0]), jnp.asarray(x2[..., 1]),
                                jnp.asarray(g2[..., 0]), jnp.asarray(g2[..., 1]), *flat,
                                negative_slope=slope, interpret=True, mxu_dtype=mxu)
    dx = tb.spectral_mlp_bwd_layers(_pairs(x2), _pairs(g2), [torch.from_numpy(w) for w in ws],
                                    slope, mxu)
    assert dx.shape == (2, 200, 16)
    err = rel_l2(dx, np.stack([np.asarray(dxr), np.asarray(dxi)]))
    assert report(f"spectral_mlp_bwd_layers[{layers},slope={slope},{mxu}]", err) <= tol


@pytest.mark.parametrize("mxu,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("slope", [0.0, 0.1])
@pytest.mark.parametrize("layers", list(DIMS))
def test_function_matches_jax_grad(layers, slope, mxu, tol):
    """The autograd Function (plain backward on the CPU) against jax.grad of
    the JAX spectral_mlp's custom_vjp, for x and every weight: on the bf16
    path dx comes from the backward kernel's plain version (JAX: the Pallas
    backward kernel), off it from the fp32 reference's VJP, as in JAX."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.spectral_mlp import _spectral_mlp_flat

    x2, g2, ws = _case(DIMS[layers], seed=1)

    def loss_j(x, *w):
        y = _spectral_mlp_flat(x, tuple(w), slope, True, mxu)
        return jnp.sum(y * jnp.asarray(g2))

    gj = jax.grad(loss_j, argnums=tuple(range(len(ws) + 1)))(
        jnp.asarray(x2), *[jnp.asarray(w) for w in ws])
    z = _pairs(x2).requires_grad_(True)
    wt = [torch.from_numpy(w).requires_grad_(True) for w in ws]
    out = tk.spectral_mlp(z, wt, slope, mxu)
    (out * _pairs(g2)).sum().backward()
    assert report(f"spectral_mlp grad[{layers},slope={slope},{mxu}] x",
                  rel_l2(z.grad, np.moveaxis(np.asarray(gj[0]), -1, 0))) <= tol
    for i, (w, g) in enumerate(zip(wt, gj[1:])):
        assert report(f"spectral_mlp grad[{layers},slope={slope},{mxu}] w{i}",
                      rel_l2(w.grad, g)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("dims,n", [([16, 32, 32, 32, 16], 70),
                                    ([256, 512, 512, 512, 256], 1000)])
def test_kernel_matches_plain(cuda, dims, n):
    x2, g2, ws = _case(dims, n=n, seed=5)
    z, g = _pairs(x2).to(cuda), (1e-3 * _pairs(g2)).to(cuda)
    wt = [torch.from_numpy(w).to(cuda) for w in ws]
    before = tb.LAUNCHES
    with torch.inference_mode():
        k = tb.spectral_mlp_bwd(z, g, wt, 0.0, "bfloat16")
        torch.cuda.synchronize()
        p = tb.spectral_mlp_bwd_reference(z, g, wt, 0.0, "bfloat16")
    assert tb.LAUNCHES == before + 1
    assert k.shape == p.shape and k.dtype == torch.float32
    # a one-ulp difference in the recompute can flip a ReLU mask, which
    # changes that row's whole gradient: the bulk of the rows agrees to 1e-3
    rows = lambda t: t.permute(1, 0, 2).reshape(n, -1).double().cpu()  # noqa: E731
    kr, pr = rows(k), rows(p)
    row_err = (kr - pr).norm(dim=1) / pr.norm(dim=1)
    good = row_err <= 1e-2
    assert float(good.double().mean()) >= 0.98
    assert rel_l2(kr[good], pr[good]) <= 1e-3
    assert rel_l2(kr, pr) <= 1e-2
