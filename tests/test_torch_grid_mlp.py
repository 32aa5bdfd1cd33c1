"""grid_mlp of the PyTorch port: its plain version against the JAX
package's Pallas kernel (interpret mode on the CPU) for every option the
serving step uses, and the CUDA kernel against the plain version on a
card."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import grid_mlp as tk
from msfno_torch.ops.kernels import tile_stats_reduce

torch.set_num_threads(2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def report(name, value):
    """The measured error, for the parity table (pytest -s shows it)."""
    print(f"parity {name} rel_l2={value:.3e}")
    return value


def _jax():
    """The JAX side, imported in the tests that use it: the card's machine
    has no JAX, and runs only the cuda tests of this file."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.grid_mlp import grid_mlp

    return jnp, grid_mlp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(name, seed=0, big=False):
    """Operands of one call site, as numpy: encoder (+pe, +stats), inner
    (+b2), decoder (+skip), fold (+affine, +residual, +b2); and "odd", no
    call site: x and the skip of widths that are no multiple of 4, with the
    affine, the residual and b2."""
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)
    b, h, w = (2, 9, 40) if big else (2, 6, 8)
    if name == "encoder":
        c, hid, out = 5, 16, 16
        ops = dict(x=r(b, h, w, c), pe=0.1 * r(h, w, out), stats_rows=h * w)
    elif name == "inner":
        c, hid, out = 16, 32, 16
        ops = dict(x=r(1, h, w, c), b2=0.1 * r(out))
    elif name == "decoder":
        c, hid, out = 16, 16, 5
        ops = dict(x=r(1, h, w, c), skip=r(1, h, w, 5))
        c_skip = 5
    elif name == "fold":
        c, hid, out = 16, 32, 16
        ops = dict(x=r(b, h, w, c), b2=0.1 * r(out),
                   affine=(1.0 + 0.1 * r(b, c), 0.1 * r(b, c)),
                   residual=r(b, h, w, out))
    else:  # odd
        c, hid, out = 6, 24, 10
        ops = dict(x=r(b, h, w, c), skip=r(b, h, w, 5), b2=0.1 * r(out),
                   affine=(1.0 + 0.1 * r(b, c), 0.1 * r(b, c)),
                   residual=r(b, h, w, out))
    k_in = c + (5 if "skip" in ops else 0)
    ops.update(w1=0.3 * r(k_in, hid), b1=0.1 * r(hid), w2=0.3 * r(hid, out))
    return ops


def _call(fn, ops, to, **kw):
    args = {k: (tuple(to(a) for a in v) if isinstance(v, tuple) else
                (to(v) if isinstance(v, np.ndarray) else v))
            for k, v in ops.items()}
    return fn(args.pop("x"), args.pop("w1"), args.pop("b1"), args.pop("w2"),
              **args, **kw)


@pytest.mark.parametrize("name", ["encoder", "inner", "decoder", "fold"])
def test_plain_matches_jax_kernel_fp32(name):
    jnp, jax_grid_mlp = _jax()
    ops = _case(name)
    yj = _call(jax_grid_mlp, ops, jnp.asarray, mxu_dtype="float32")
    yt = _call(tk.grid_mlp, ops, torch.from_numpy, mxu_dtype="float32")
    if "stats_rows" in ops:
        for part, a, b in zip(("y", "ssum", "ssq"), yt, yj):
            assert report(f"grid_mlp[{name}] {part}", rel_l2(a, b)) <= 1e-5
    else:
        assert yt.shape == yj.shape
        assert report(f"grid_mlp[{name}]", rel_l2(yt, yj)) <= 1e-5


def test_bf16_out_and_pe_match_jax_kernel():
    # bf16 pe storage and bf16 output rounding at the write, bf16 operands
    jnp, jax_grid_mlp = _jax()
    ops = _case("encoder", seed=3)
    yj, sj, qj = _call(jax_grid_mlp, {**ops, "pe": jnp.asarray(ops["pe"], jnp.bfloat16)},
                       lambda a: a if not isinstance(a, np.ndarray) else jnp.asarray(a),
                       mxu_dtype="bfloat16", out_dtype=jnp.bfloat16)
    pe_t = torch.from_numpy(ops["pe"]).to(torch.bfloat16)
    yt, st, qt = _call(tk.grid_mlp, {**ops, "pe": pe_t},
                       lambda a: a if not isinstance(a, np.ndarray) else torch.from_numpy(a),
                       mxu_dtype="bfloat16", out_dtype="bfloat16")
    assert yt.dtype == torch.bfloat16
    # one-ulp bf16 flips of the hidden activation or the output
    assert rel_l2(yt.float(), np.asarray(yj, np.float32)) <= 1e-2
    assert rel_l2(st, sj) <= 1e-3 and rel_l2(qt, qj) <= 1e-3


# the kernel's tiles at test size: 32 rows (the last of a sample's 48
# ragged), the inner MLP's hidden width 32 in two passes of 16
MIRROR_TILE, MIRROR_HALF = 32, 16


@pytest.mark.parametrize("mxu,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
@pytest.mark.parametrize("name", ["encoder", "inner", "decoder", "fold"])
def test_tile_mirror_matches_jax_kernel(name, mxu, tol):
    """The kernel's tile chain (`mlp_tiles`: tiles of one sample, the first
    GEMM in hidden passes, per-tile statistics partials added by
    `tile_stats_reduce`) against the Pallas `_grid_mlp_call` (interpret
    mode)."""
    _check_tile_mirror(name, mxu, tol, MIRROR_HALF)


def _check_tile_mirror(name, mxu, tol, half, matmul=torch.matmul):
    """`mlp_tiles` (hidden passes of `half`, products by `matmul`) against
    the Pallas `_grid_mlp_call` (interpret mode) at one call site."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.grid_mlp import _grid_mlp_call

    ops = _case(name, seed=11)
    x = ops["x"].reshape(-1, ops["x"].shape[-1])
    n, c_out = x.shape[0], ops["w2"].shape[1]
    rows = ops.get("stats_rows", 0)
    aff = ops.get("affine")
    def j(k):
        return jnp.asarray(ops[k].reshape(-1, ops[k].shape[-1])) if k in ops else None

    out = _grid_mlp_call(
        jnp.asarray(x), j("skip"), jnp.asarray(ops["w1"]), jnp.asarray(ops["b1"]),
        jnp.asarray(ops["w2"]), j("b2"), j("pe"),
        jnp.asarray(aff[0]) if aff else None, jnp.asarray(aff[1]) if aff else None,
        j("residual"), has_skip="skip" in ops, has_b2="b2" in ops, has_pe="pe" in ops,
        pe_rows=ops["pe"].shape[0] * ops["pe"].shape[1] if "pe" in ops else 0,
        mxu_dtype=mxu, interpret=True, tile_n=8, stats_rows=rows,
        aff_rows=n // aff[0].shape[0] if aff else 0, has_res="residual" in ops)
    yj, sums = (out[0], out[1:]) if rows else (out, ())
    t = lambda k: torch.from_numpy(ops[k]) if k in ops else None  # noqa: E731
    y, part_sum, part_sq = tk.mlp_tiles(
        t("x"), t("w1"), t("b1"), t("w2"), t("b2"), t("skip"), t("pe"), mxu,
        stats_rows=rows or None, residual=t("residual"), tile=MIRROR_TILE, half=half,
        affine=tuple(torch.from_numpy(a) for a in aff) if aff else None, matmul=matmul)
    if rows:
        assert rows % MIRROR_TILE and part_sum.shape[1] == -(-rows // MIRROR_TILE)  # ragged
    assert y.shape == (n, c_out)
    tag = f"{name},{mxu},half={half},{getattr(matmul, '__name__', matmul)}"
    assert report(f"grid_mlp tiles[{tag}]", rel_l2(y, yj)) <= tol
    for part, got, want in zip(("ssum", "ssq"), (part_sum, part_sq), sums):
        assert report(f"grid_mlp tiles[{tag}] {part}",
                      rel_l2(tile_stats_reduce(got), want)) <= tol


@pytest.mark.parametrize("product", ["matmul", "tf32x3"])
@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("name", ["encoder", "inner", "decoder", "fold"])
def test_fp32_tile_mirror_matches_jax_kernel(name, mxu, product):
    """The fp32 kernel's decomposition (csrc/mlp_f32.cuh): the whole hidden
    width in one GEMM, tiles of one sample (ragged), per-tile statistics
    partials added in the fixed order, each product fp32 (`matmul`) or the
    card's split-precision product (`tf32x3.matmul_tf32x3`); "tensorfloat"
    takes the same fp32 kernel."""
    from msfno_torch.ops.kernels.tf32x3 import matmul_tf32x3

    _check_tile_mirror(name, mxu, 1e-5, half=32,
                       matmul=matmul_tf32x3 if product == "tf32x3" else torch.matmul)


@pytest.mark.parametrize("bad", ["residual+stats", "affine+pe"])
def test_invalid_combinations_raise(bad):
    ops = _case("fold")
    x, w1, b1, w2 = (torch.from_numpy(ops[k]) for k in ("x", "w1", "b1", "w2"))
    kw = dict(residual=torch.from_numpy(ops["residual"]), stats_rows=48)
    if bad == "affine+pe":
        kw = dict(affine=tuple(torch.from_numpy(a) for a in ops["affine"]),
                  pe=torch.zeros(6, 8, 16))
    with pytest.raises(ValueError):
        tk.grid_mlp(x, w1, b1, w2, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["encoder", "inner", "decoder", "fold"])
def test_kernel_matches_plain(cuda, name):
    ops = _case(name, seed=5, big=True)
    to = lambda a: torch.from_numpy(a).to(cuda)
    before = tk.LAUNCHES
    with torch.inference_mode():
        yk = _call(tk.grid_mlp, ops, to, mxu_dtype="bfloat16", out_dtype="bfloat16")
        torch.cuda.synchronize()
        yp = _call(tk.grid_mlp_reference, ops, to, mxu_dtype="bfloat16",
                   out_dtype="bfloat16")
    assert tk.LAUNCHES == before + 1
    if isinstance(yk, tuple):
        # stats: block partials added in another order than torch.sum
        assert rel_l2(yk[1].cpu(), yp[1].cpu()) <= 1e-4
        assert rel_l2(yk[2].cpu(), yp[2].cpu()) <= 1e-4
        yk, yp = yk[0], yp[0]
    assert rel_l2(yk.float().cpu(), yp.float().cpu()) <= 1e-2


@pytest.mark.parametrize("name", ["encoder", "inner", "decoder", "fold"])
def test_tensorfloat_is_float32_on_cpu(name):
    ops = _case(name, seed=6)
    a = _call(tk.grid_mlp, ops, torch.from_numpy, mxu_dtype="tensorfloat")
    b = _call(tk.grid_mlp, ops, torch.from_numpy, mxu_dtype="float32")
    for u, v in zip(*((o if isinstance(o, tuple) else (o,)) for o in (a, b))):
        assert torch.equal(u, v)


def test_prepare_weights_fp32():
    """fp32 operands take W1 and W2 as they are (no padding, no rounding),
    then the split-precision B operands of W1^T and W2^T, bit for bit
    `tf32x3.kmajor_split`'s; a bf16 pack is refused for them."""
    from msfno_torch.ops.kernels import check_prepared
    from msfno_torch.ops.kernels.tf32x3 import kmajor_split

    ops = _case("decoder")
    w1, w2 = torch.from_numpy(ops["w1"]), torch.from_numpy(ops["w2"])
    prepared = tk.prepare_weights(w1, w2, 16, "float32")
    w1p, w2p, w1t_x3, w2t_x3 = prepared
    assert torch.equal(w1p, w1) and torch.equal(w2p, w2) and w1p.dtype == torch.float32
    assert torch.equal(w1t_x3, kmajor_split(w1)) and torch.equal(w2t_x3, kmajor_split(w2))
    check_prepared("grid_mlp", prepared, "tensorfloat")
    with pytest.raises(ValueError):
        check_prepared("grid_mlp", tk.prepare_weights(w1, w2, 16), "float32")


@pytest.mark.parametrize("name", ["encoder", "odd"])
def test_prepare_weights_fp32_pads_main_rows(name):
    """W1^T's K on fp32 operands: x's rows padded with zeros to a multiple
    of 4, then the skip's (the kernel's A rows); without a skip, W1 as it
    is."""
    from msfno_torch.ops.kernels.tf32x3 import kmajor_split

    ops = _case(name)
    c_main = ops["x"].shape[-1]
    w1, w2 = torch.from_numpy(ops["w1"]), torch.from_numpy(ops["w2"])
    w1t_x3 = tk.prepare_weights(w1, w2, c_main, "float32")[2]
    lx = -(-c_main // 4) * 4
    want = torch.zeros((lx + w1.shape[0] - c_main, w1.shape[1]))
    want[:c_main], want[lx:] = w1[:c_main], w1[c_main:]
    assert torch.equal(w1t_x3, kmajor_split(want))
    assert w1t_x3.shape[2] >= lx + -(-(w1.shape[0] - c_main) // 4) * 4


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("name,io", [
    ("encoder", "fp32"), ("inner", "fp32"), ("decoder", "fp32"), ("fold", "fp32"),
    # bf16 x, skip, pe and residual as stored, bf16 output
    ("encoder", "bf16"), ("decoder", "bf16"), ("fold", "bf16"), ("inner", "bf16"),
    # x and the skip copied into 16-byte rows, the affine on the copy
    ("odd", "fp32"), ("odd", "bf16"),
])
def test_fp32_kernel_matches_plain(cuda, name, io, mxu):
    # the kernel's split-precision products against true fp32 FMA: the fp32
    # class; row counts no multiple of 128 (720 a sample, 2 samples with
    # statistics); bf16 storage is read as it is on both sides, and a bf16
    # output rounds the same y
    from msfno_torch.runtime import exact_fp32_matmuls

    exact_fp32_matmuls()
    ops = _case(name, seed=5, big=True)
    bf = io == "bf16"

    def to(a):
        t = torch.from_numpy(a).to(cuda)
        return t.to(torch.bfloat16) if bf and t.dim() > 1 else t

    kw = dict(mxu_dtype=mxu, out_dtype="bfloat16" if bf else "float32")
    ops = {k: (tuple(torch.from_numpy(a).to(cuda) for a in v) if k == "affine" else v)
           for k, v in ops.items()}
    w = {k: torch.from_numpy(ops.pop(k)).to(cuda) for k in ("w1", "b1", "w2")}
    before = tk.LAUNCHES
    with torch.inference_mode():
        args = {k: to(v) if isinstance(v, np.ndarray) else v for k, v in ops.items()}
        yk = tk.grid_mlp(args.pop("x"), w["w1"], w["b1"], w["w2"], **args, **kw)
        torch.cuda.synchronize()
        args = {k: to(v) if isinstance(v, np.ndarray) else v for k, v in ops.items()}
        yp = tk.grid_mlp_reference(args.pop("x"), w["w1"], w["b1"], w["w2"], **args, **kw)
    assert tk.LAUNCHES == before + 1
    yk, yp = ((o,) if not isinstance(o, tuple) else o for o in (yk, yp))
    assert yk[0].dtype == yp[0].dtype
    # a bf16 output differs where the fp32 y's sums sit on a rounding boundary
    assert rel_l2(yk[0].float().cpu(), yp[0].float().cpu()) <= (1e-3 if bf else 1e-5)
    for a, b in zip(yk[1:], yp[1:]):
        assert rel_l2(a.cpu(), b.cpu()) <= 1e-5


@pytest.mark.cuda
def test_fp32_mlp_follows_in_place_weight_update(cuda):
    """`Mlp` caches the prepared split of W1^T and W2^T (DerivedCache): a
    weight updated in place between two calls, as an optimizer step does,
    reaches the second call."""
    from msfno_torch.models.sfno.layers import Mlp
    from msfno_torch.runtime import exact_fp32_matmuls

    exact_fp32_matmuls()
    gen = torch.Generator(device=cuda).manual_seed(4)
    mlp = Mlp(16, 32, 16, use_pallas=True, mxu_dtype="float32", device=cuda, gen=gen)
    x = torch.randn((1, 9, 40, 16), device=cuda, generator=gen)

    def plain():
        fc1, fc2 = mlp.fwd["0"], mlp.fwd["2"]
        return tk.grid_mlp_reference(x, fc1.dense(), fc1.bias, fc2.dense(), b2=fc2.bias,
                                     mxu_dtype="float32")

    with torch.no_grad():
        y0 = mlp(x)
        mlp.fwd["0"].weight.mul_(-0.5).add_(0.01)
        y1 = mlp(x)
        torch.cuda.synchronize()
        want = plain()
    assert rel_l2(y1.cpu(), want.cpu()) <= 1e-5
    assert rel_l2(y0.cpu(), want.cpu()) > 1e-2
