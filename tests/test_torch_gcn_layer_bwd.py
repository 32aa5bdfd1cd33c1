"""gcn_layer's backward in the PyTorch port: the plain version of the
`gcn_layer_bwd` kernel against the JAX package's Pallas backward kernel
(interpret mode on the CPU), the autograd Function against jax.grad of the
JAX `gcn_layer`, and the CUDA kernel against the plain version on a card."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import gcn_layer as tk
from msfno_torch.ops.kernels import gcn_layer_bwd as tb

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


def _case(b, h, w, c_in, f, residual, seed=0):
    """Forward operands, the forward output y (plain fp32) and a cotangent."""
    rng = np.random.default_rng(seed)
    mask = (rng.standard_normal((b, h, w, 1)) > -0.3).astype(np.float32)
    ops = dict(
        x=rng.standard_normal((b, h, w, c_in)).astype(np.float32),
        w=(0.3 * rng.standard_normal((c_in, f))).astype(np.float32),
        b=(0.1 * rng.standard_normal(f)).astype(np.float32),
        dinv=(1.0 / np.sqrt(1.0 + 8.0 * mask)).astype(np.float32),
        mask=mask,
        residual=(rng.standard_normal((b, h, w, f)).astype(np.float32) if residual
                  else None),
    )
    t = {k: torch.from_numpy(v) if v is not None else None for k, v in ops.items()}
    y = tk.gcn_layer_reference(t["x"], t["w"], t["b"], t["dinv"], t["mask"],
                               t["residual"], mxu_dtype="float32")
    ops["y"] = y.numpy()
    ops["g"] = rng.standard_normal((b, h, w, f)).astype(np.float32)
    return ops


SHAPES = [((1, 7, 16, 1, 16), False),   # conv1: c_in = 1
          ((2, 7, 16, 8, 16), True)]    # residual layer; H = 7: pole rows, uneven tiles


@pytest.mark.parametrize("mxu,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape,residual", SHAPES)
def test_plain_bwd_matches_jax_kernel(shape, residual, mxu, tol):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.gcn_layer import _gcn_layer_bwd_call, _pick_tile_h

    ops = _case(*shape, residual)
    j = {k: jnp.asarray(v) if v is not None else None for k, v in ops.items()}
    dxj, dwj, dbj = _gcn_layer_bwd_call(
        j["g"], j["y"], j["residual"], j["x"], j["dinv"], j["mask"], j["w"].T,
        has_residual=residual, slope=0.01, mxu_dtype=mxu, interpret=True,
        tile_h=_pick_tile_h(shape[1]))
    t = {k: torch.from_numpy(v) if v is not None else None for k, v in ops.items()}
    dxt, dwt, dbt = tb.gcn_layer_bwd(t["g"], t["y"], t["residual"], t["x"], t["w"],
                                     t["dinv"], t["mask"], 0.01, mxu)
    for name, a, b in (("dx", dxt, dxj), ("dw", dwt, dwj), ("db", dbt, np.ravel(dbj))):
        assert a.shape == np.shape(b)
        assert report(f"gcn_layer_bwd[c_in={shape[3]},{mxu}] {name}", rel_l2(a, b)) <= tol


# (B, H, W, C_in, F), residual, strip height, longitude segment, the JAX
# kernel's tile_h: H not a multiple of the strip; one strip per JAX tile; W
# odd, and not a multiple of the segment; a strip taller than H; c_in 1 and
# 16
PASS_CASES = [((1, 7, 15, 16, 16), True, 3, 6, 7),
              ((2, 8, 16, 1, 16), False, 4, 62, 4),
              ((1, 9, 15, 1, 24), True, 4, 4, 3),
              ((2, 6, 17, 16, 16), False, 8, 5, 2)]


@pytest.mark.parametrize("mxu,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape,residual,strip,segment,tile_h", PASS_CASES)
def test_pass_mirror_matches_jax_kernel(shape, residual, strip, segment, tile_h, mxu, tol):
    """The kernel's decomposition (`gcn_layer_bwd_passes`: the dsup strip
    walk with its carried rows and per-row-segment partials, dW split over
    three pixel ranges and added in order, the partials in stats_reduce's
    order) against the Pallas backward (interpret mode), slope 0.01."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.gcn_layer import _gcn_layer_bwd_call

    ops = _case(*shape, residual, seed=7)
    j = {k: jnp.asarray(v) if v is not None else None for k, v in ops.items()}
    ref = _gcn_layer_bwd_call(
        j["g"], j["y"], j["residual"], j["x"], j["dinv"], j["mask"], j["w"].T,
        has_residual=residual, slope=0.01, mxu_dtype=mxu, interpret=True, tile_h=tile_h)
    t = {k: torch.from_numpy(v) if v is not None else None for k, v in ops.items()}
    got = tb.gcn_layer_bwd_passes(t["g"], t["y"], t["residual"], t["x"], t["w"], t["dinv"],
                                  t["mask"], 0.01, mxu, strip=strip, segment=segment,
                                  splits=3)
    for name, a, b in zip(("dx", "dw", "db"), got, (ref[0], ref[1], np.ravel(ref[2]))):
        assert a.shape == np.shape(b)
        assert report(f"gcn_layer_bwd passes[{shape},strip={strip},seg={segment},{mxu}] "
                      f"{name}",
                      rel_l2(a, b)) <= tol


def test_dw_split_ranges():
    """dW's split ranges are whole 64-pixel stages, a range past the end
    empty, and their partials add up to the product."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((200, 8)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((200, 16)).astype(np.float32))
    for splits in (1, 3, 5):  # 5 splits of 64 pixels: the last one is empty
        assert rel_l2(tb.dw_split_k(x, d, splits), x.t() @ d) <= 1e-6
    assert tb.dw_splits(180 * 360, 512, 512, False) == 16
    assert tb.dw_splits(180 * 360, 1, 512, False) == 1


def test_dw_split_ranges_fp32():
    """fp32 operands: dW's split ranges are whole 32-pixel stages of the
    split-precision core (gemm_tf32x3_mn's K), as many splits as make four
    128 x 128 tiles per SM at the 512 -> 512 layer, and the partials of the
    split product add up to the product within the fp32 class."""
    from msfno_torch.ops.kernels.tf32x3 import matmul_tf32x3

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((200, 40)).astype(np.float32))
    d = torch.from_numpy(rng.standard_normal((200, 24)).astype(np.float32))
    want = x.double().t() @ d.double()
    for splits in (1, 3, 7):  # 7 splits of 32 pixels: the last one is empty
        got = tb.dw_split_k(x, d, splits, tb.SPLIT_CHUNK[True], matmul_tf32x3)
        assert rel_l2(got, want) <= 1e-6
    assert tb.dw_splits(180 * 360, 512, 512, True) == 33
    assert tb.dw_splits(180 * 360, 1, 512, True) == 1


# fp32 operands on the split product: C_in and F not multiples of the
# core's 128-wide tiles (40 x 24; 136 x 144: a full and a ragged tile each
# way), dW over several pixel ranges (3, 5)
SPLIT_CASES = [((1, 7, 15, 40, 24), True, 3), ((2, 4, 17, 136, 144), False, 5)]


@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("shape,residual,splits", SPLIT_CASES)
def test_fp32_split_product_passes_match_jax_kernel(shape, residual, splits, mxu):
    """The fp32 kernel's algebra at ragged widths: `gcn_layer_bwd_passes`
    with dx = dsup W^T and dW = x^T dsup as the split-precision product
    (`tf32x3.matmul_tf32x3`, dW in `splits` ranges of whole 32-pixel
    stages) against the Pallas backward (interpret mode) on fp32 operands,
    every output to 1e-5."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.gcn_layer import _gcn_layer_bwd_call, _pick_tile_h

    ops = _case(*shape, residual, seed=11)
    j = {k: jnp.asarray(v) if v is not None else None for k, v in ops.items()}
    ref = _gcn_layer_bwd_call(
        j["g"], j["y"], j["residual"], j["x"], j["dinv"], j["mask"], j["w"].T,
        has_residual=residual, slope=0.01, mxu_dtype=mxu, interpret=True,
        tile_h=_pick_tile_h(shape[1]))
    t = {k: torch.from_numpy(v) if v is not None else None for k, v in ops.items()}
    got = tb.gcn_layer_bwd_passes(t["g"], t["y"], t["residual"], t["x"], t["w"], t["dinv"],
                                  t["mask"], 0.01, mxu, splits=splits)
    for name, a, b in zip(("dx", "dw", "db"), got, (ref[0], ref[1], np.ravel(ref[2]))):
        assert a.shape == np.shape(b)
        assert report(f"gcn_layer_bwd split product[{shape},splits={splits},{mxu}] {name}",
                      rel_l2(a, b)) <= 1e-5


@pytest.mark.parametrize("shape,residual", SHAPES)
def test_function_matches_jax_grad(shape, residual):
    """The autograd Function (plain backward on the CPU) against jax.grad of
    the JAX public gcn_layer: x, w, b and the residual."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.gcn_layer import gcn_layer as jax_gcn_layer

    ops = _case(*shape, residual)
    names = ["x", "w", "b"] + (["residual"] if residual else [])

    def loss_j(*vals):
        kw = dict(zip(names, vals))
        y = jax_gcn_layer(kw["x"], kw["w"], kw["b"], jnp.asarray(ops["dinv"]),
                          jnp.asarray(ops["mask"]), residual=kw.get("residual"),
                          mxu_dtype="float32")
        return jnp.sum(y * jnp.asarray(ops["g"]))

    gj = jax.grad(loss_j, argnums=tuple(range(len(names))))(
        *[jnp.asarray(ops[k]) for k in names])
    leaves = {k: torch.from_numpy(ops[k]).requires_grad_(True) for k in names}
    y = tk.gcn_layer(leaves["x"], leaves["w"], leaves["b"], torch.from_numpy(ops["dinv"]),
                     torch.from_numpy(ops["mask"]), residual=leaves.get("residual"),
                     mxu_dtype="float32")
    (y * torch.from_numpy(ops["g"])).sum().backward()
    for k, g in zip(names, gj):
        assert report(f"gcn_layer grad[c_in={shape[3]}] {k}",
                      rel_l2(leaves[k].grad, g)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,residual", [((2, 7, 16, 8, 16), True),
                                            ((1, 9, 40, 1, 64), False),
                                            ((1, 6, 360, 512, 512), True)])
def test_kernel_matches_plain(cuda, shape, residual):
    ops = _case(*shape, residual, seed=4)
    t = {k: torch.from_numpy(v).to(cuda) if v is not None else None for k, v in ops.items()}
    bf = torch.bfloat16
    args = (t["g"].to(bf), t["y"].to(bf), t["residual"].to(bf) if residual else None,
            t["x"].to(bf), t["w"], t["dinv"].to(bf), t["mask"].to(bf))
    before = tb.LAUNCHES
    with torch.inference_mode():
        k = tb.gcn_layer_bwd(*args)
        torch.cuda.synchronize()
        p = tb.gcn_layer_bwd_reference(*args)
    assert tb.LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert a.shape == b.shape and a.dtype == torch.float32
        # one-ulp bf16 flips of dsup, fp32 sums in another order
        assert rel_l2(a.cpu(), b.cpu()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", [1, 512])
@pytest.mark.parametrize("residual", [False, True])
def test_fp32_kernel_matches_plain(cuda, c_in, residual):
    """fp32 operands: dsup is not rounded, dx and dW are split-precision
    TF32 GEMMs (dW split over pixel ranges, added in a fixed order); every
    output within 1e-5 of the true-fp32 plain version."""
    from msfno_torch.runtime import exact_fp32_matmuls

    exact_fp32_matmuls()
    ops = _case(1, 45, 360, c_in, 512, residual, seed=5)
    t = {k: torch.from_numpy(v).to(cuda) if v is not None else None for k, v in ops.items()}
    args = (t["g"], t["y"], t["residual"], t["x"], t["w"], t["dinv"], t["mask"])
    before = tb.LAUNCHES
    with torch.inference_mode():
        k = tb.gcn_layer_bwd(*args, mxu_dtype="float32")
        torch.cuda.synchronize()
        p = tb.gcn_layer_bwd_reference(*args, mxu_dtype="float32")
    assert tb.LAUNCHES == before + 1
    for a, b in zip(k, p):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert rel_l2(a.cpu(), b.cpu()) <= 1e-5


def _fp32_args(cuda, shape, residual, seed):
    ops = _case(*shape, residual, seed=seed)
    t = {k: torch.from_numpy(v).to(cuda) if v is not None else None for k, v in ops.items()}
    return (t["g"], t["y"], t["residual"], t["x"], t["w"], t["dinv"], t["mask"])


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("shape,residual", [((1, 7, 16, 42, 24), True),
                                            ((2, 9, 40, 136, 144), False),
                                            ((1, 20, 360, 200, 512), True)])
def test_fp32_kernel_ragged_sizes(cuda, shape, residual, mxu):
    """fp32 operands at widths that are not multiples of the split-precision
    core's 128-wide tiles (C_in 42: x's rows are not 16-byte multiples and
    are read by scalar loads), dW in the shape's own split count: every
    output within 1e-5 of the plain version, one launch."""
    from msfno_torch.runtime import exact_fp32_matmuls

    exact_fp32_matmuls()
    args = _fp32_args(cuda, shape, residual, 8)
    before = tb.LAUNCHES
    with torch.inference_mode():
        k = tb.gcn_layer_bwd(*args, mxu_dtype=mxu)
        torch.cuda.synchronize()
        p = tb.gcn_layer_bwd_reference(*args, mxu_dtype="float32")
    assert tb.LAUNCHES == before + 1
    for name, a, b in zip(("dx", "dw", "db"), k, p):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert rel_l2(a.cpu(), b.cpu()) <= 1e-5, name


@pytest.mark.cuda
def test_fp32_backward_follows_weight_update(cuda):
    """W is split into its hi / lo halves on every call: after an in-place
    update of W (as the optimizer makes), given as `w` or as `prepared`,
    dx follows the new W, not a stale split."""
    from msfno_torch.runtime import exact_fp32_matmuls

    exact_fp32_matmuls()
    g, y, res, x, w, dinv, mask = _fp32_args(cuda, (1, 9, 40, 64, 64), True, 9)
    with torch.inference_mode():
        for step in range(3):
            for prepared in (None, w):
                dx, dw, db = tb.gcn_layer_bwd(g, y, res, x, w, dinv, mask, mxu_dtype="float32",
                                              prepared=prepared)
                want = tb.gcn_layer_bwd_reference(g, y, res, x, w, dinv, mask,
                                                  mxu_dtype="float32")
                assert rel_l2(dx.cpu(), want[0].cpu()) <= 1e-5, (step, prepared is None)
            w.mul_(-1.5).add_(0.25)  # in place: same storage, new values


@pytest.mark.cuda
def test_fp32_bad_operands_raise(cuda):
    """A wrong-shape weight or prepared weight raises before any launch,
    and nothing falls back to the plain version."""
    g, y, res, x, w, dinv, mask = _fp32_args(cuda, (1, 7, 16, 16, 16), True, 10)
    before = tb.LAUNCHES
    with pytest.raises(ValueError):
        tb.gcn_layer_bwd(g, y, res, x, w[:, :8], dinv, mask, mxu_dtype="float32")
    with pytest.raises(ValueError):
        tb.gcn_layer_bwd(g, y, res, x, w, dinv, mask, mxu_dtype="float32",
                         prepared=w.t().contiguous()[:, :8])
    with pytest.raises(ValueError):
        tb.gcn_layer_bwd(g, y, res, x, w, dinv, mask, mxu_dtype="float32",
                         prepared=w.to(torch.bfloat16))
    assert tb.LAUNCHES == before
