"""gcn_layer and the GCN FiLM generator of the PyTorch port: plain versions
against the JAX package (Pallas kernel in interpret mode on the CPU), and the
CUDA kernel against the plain version on a card."""

import numpy as np
import pytest
import torch

from msfno_torch.config import FilmConfig as TFilmConfig
from msfno_torch.convert import from_flax_params
from msfno_torch.models.film.wrapper import FilmWrapper as TFilmWrapper
from msfno_torch.ops.kernels import gcn_layer as tk

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
    import jax

    return jax


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _case(b, h, w, c_in, f, residual, seed=0):
    rng = np.random.default_rng(seed)
    mask = (rng.standard_normal((b, h, w, 1)) > -0.3).astype(np.float32)
    ops = dict(
        x=rng.standard_normal((b, h, w, c_in)).astype(np.float32),
        w=(0.3 * rng.standard_normal((c_in, f))).astype(np.float32),
        b=(0.1 * rng.standard_normal(f)).astype(np.float32),
        dinv=(1.0 / np.sqrt(1.0 + 8.0 * mask)).astype(np.float32),
        mask=mask,
    )
    if residual:
        ops["residual"] = rng.standard_normal((b, h, w, f)).astype(np.float32)
    return ops


def _call(fn, ops, to, **kw):
    t = {k: to(v) for k, v in ops.items()}
    return fn(t["x"], t["w"], t["b"], t["dinv"], t["mask"],
              residual=t.get("residual"), **kw)


@pytest.mark.parametrize(
    "shape,residual",
    [((1, 7, 16, 1, 16), False),   # conv1: c_in = 1, fp32 outer product
     ((2, 7, 16, 8, 16), True)],   # residual layer, odd H: pole rows, edges
)
def test_plain_matches_jax_kernel_fp32(shape, residual):
    _jax()
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.gcn_layer import gcn_layer as jax_gcn_layer

    ops = _case(*shape, residual)
    yj = _call(jax_gcn_layer, ops, jnp.asarray, mxu_dtype="float32")
    yt = _call(tk.gcn_layer, ops, torch.from_numpy, mxu_dtype="float32")
    assert yt.shape == yj.shape
    assert report(f"gcn_layer[c_in={shape[3]}]", rel_l2(yt, yj)) <= 1e-5


def test_box3_pole_and_wrap():
    v = torch.ones(1, 8, 16, 2)
    out = tk.box3(v)
    assert torch.all(out[0, 0] == 6) and torch.all(out[0, -1] == 6)
    assert torch.all(out[0, 3] == 9)
    v = torch.zeros(1, 3, 5, 1)
    v[0, 1, 0] = 1.0
    assert tk.box3(v)[0, 1, 4, 0] == 1.0  # periodic longitude


@pytest.mark.parametrize("kind,pallas", [("gcn_custom", True), ("gcn", False)])
def test_generator_matches_jax(kind, pallas):
    jax = _jax()
    import jax.numpy as jnp
    from msfno_tpu.models.film.wrapper import FilmWrapper as JFilmWrapper
    from msfno_tpu.utils.config import FilmConfig as JFilmConfig

    kw = dict(film_gen_type=kind, model_depth=2, embed_dim=32, mlp_dim=32,
              num_film_features=16, sst_shape=(9, 16), temporal_step=3,
              pallas_gcn=pallas)
    rng = np.random.default_rng(4)
    sst = rng.standard_normal((2, 3, 9, 16)).astype(np.float32)
    sst[..., rng.random((9, 16)) < 0.3] = np.nan
    jw = JFilmWrapper(JFilmConfig(**kw))
    params = jw.init(jax.random.PRNGKey(0), jnp.asarray(sst))["params"]
    # head weights are ones for gcn_custom and zeros for gcn: give the gcn
    # head random weights so its output is not trivially zero
    params = jax.tree_util.tree_map(np.asarray, params)
    head = params["film_gen"]["head_film"]
    head["kernel"] = (0.1 * rng.standard_normal(head["kernel"].shape)).astype(np.float32)
    yj = jw.apply({"params": params}, jnp.asarray(sst))
    tw = TFilmWrapper(TFilmConfig(**kw), device="cpu")
    sd = from_flax_params({"film_gen": params})
    tw.load_state_dict({k[len("film_gen."):]: v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        yt = tw(torch.from_numpy(sst))
    assert yt.shape == (2, 2, 1, 16)
    assert report(f"film generator[{kind}]", rel_l2(yt, yj)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape,residual", [((1, 7, 40, 1, 64), False),
                                            ((2, 13, 40, 64, 96), True),
                                            ((1, 180, 360, 512, 512), True)])
def test_kernel_matches_plain(cuda, shape, residual):
    ops = _case(*shape, residual, seed=6)
    to = lambda a: torch.from_numpy(a).to(cuda).to(torch.bfloat16)
    before = tk.LAUNCHES
    with torch.inference_mode():
        yk = _call(tk.gcn_layer, ops, to, mxu_dtype="bfloat16")
        torch.cuda.synchronize()
        yp = _call(tk.gcn_layer_reference, ops, to, mxu_dtype="bfloat16")
    assert tk.LAUNCHES == before + 1
    # bf16 output rounding on both sides, fp32 sums in another order
    assert rel_l2(yk.float().cpu(), yp.float().cpu()) <= 1e-2


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,residual", [((1, 7, 16, 1, 16), True),
                                            ((2, 9, 16, 8, 24), True),
                                            ((1, 5, 12, 16, 8), False)])
def test_two_pass_mirror_matches_jax_kernel(mxu, shape, residual):
    """The kernel's two passes, t = (x W) d in fp32 then the stencil, against
    the Pallas kernel (interpret mode) on the same operand dtype."""
    _jax()
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.gcn_layer import gcn_layer as jax_gcn_layer

    ops = _case(*shape, residual, seed=2)
    yj = _call(jax_gcn_layer, ops, jnp.asarray, mxu_dtype=mxu, out_dtype="float32")
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    tt = tk.gcn_t_pass(t["x"], t["w"], t["dinv"], mxu)
    assert tt.dtype == torch.float32
    yt = tk.gcn_stencil_pass(tt, t["b"], t["dinv"], t["mask"], t.get("residual"))
    assert report(f"gcn_layer two-pass mirror[c_in={shape[3]}, {mxu}]",
                  rel_l2(yt, yj)) <= 1e-5


@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("c_in,f", [(40, 24), (136, 144)])
@pytest.mark.parametrize("residual", [False, True])
def test_split_product_mirror_matches_jax_kernel(mxu, c_in, f, residual):
    """The card's fp32 passes: t = (x W) d as the split-precision product
    (`tf32x3.matmul_tf32x3`), then the stencil, against the Pallas kernel
    (interpret mode) on fp32 operands: the fp32 class, 1e-5."""
    _jax()
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.gcn_layer import gcn_layer as jax_gcn_layer

    from msfno_torch.ops.kernels.tf32x3 import matmul_tf32x3

    ops = _case(2, 5, 16, c_in, f, residual, seed=12)
    yj = _call(jax_gcn_layer, ops, jnp.asarray, mxu_dtype=mxu, out_dtype="float32")
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    tt = tk.gcn_t_pass(t["x"], t["w"], t["dinv"], mxu, matmul=matmul_tf32x3)
    yt = tk.gcn_stencil_pass(tt, t["b"], t["dinv"], t["mask"], t.get("residual"))
    assert report(f"gcn_layer split-product mirror[{c_in}x{f}, res={residual}, {mxu}]",
                  rel_l2(yt, yj)) <= 1e-5


def test_split_w_on_cpu_is_kmajor_split():
    from msfno_torch.ops.kernels.tf32x3 import kmajor_split

    w = torch.from_numpy(_case(1, 3, 4, 40, 24, False)["w"])
    out = tk.split_w(w)
    assert out.shape == (2, 24, 48) and torch.equal(out, kmajor_split(w))


def _on_card(ops, dev, mxu):
    dt = torch.float32 if mxu == "float32" else torch.bfloat16
    return {k: torch.from_numpy(v).to(dev).to(torch.float32 if k in ("w", "b") else dt)
            for k, v in ops.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("c_in", [1, 512])
@pytest.mark.parametrize("residual", [False, True])
def test_fp32_kernel_matches_plain(cuda, c_in, residual):
    """fp32 operands (the JAX exact, balanced and fp32-kernel tiers'
    generator), fp32 in and out: the kernel's split-precision product
    against the plain version's true fp32 one, 1e-5."""
    from msfno_torch.runtime import exact_fp32_matmuls

    exact_fp32_matmuls()
    ops = _case(1, 45, 360, c_in, 512, residual, seed=7)
    t = _on_card(ops, cuda, "float32")
    before = tk.LAUNCHES
    with torch.inference_mode():
        yk = _call(tk.gcn_layer, t, lambda a: a, mxu_dtype="float32")
        torch.cuda.synchronize()
        yp = _call(tk.gcn_layer_reference, t, lambda a: a, mxu_dtype="float32")
    assert tk.LAUNCHES == before + 1 and yk.dtype == torch.float32
    assert rel_l2(yk.cpu(), yp.cpu()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape,residual", [((1, 5, 3, 16, 32), True),
                                            ((2, 9, 400, 64, 96), True),
                                            ((1, 13, 257, 24, 40), False),
                                            ((1, 7, 100, 20, 36), True),   # c_in % 8 != 0
                                            ((1, 3, 50, 12, 30), True),    # F % 4 != 0
                                            ((1, 11, 33, 1, 20), True)])
def test_kernel_ragged_sizes(cuda, mxu, shape, residual):
    """Odd H, W from 3 to 400, widths that fill no tile."""
    from msfno_torch.runtime import exact_fp32_matmuls

    exact_fp32_matmuls()
    ops = _case(*shape, residual, seed=8)
    t = _on_card(ops, cuda, mxu)
    with torch.inference_mode():
        yk = _call(tk.gcn_layer, t, lambda a: a, mxu_dtype=mxu)
        torch.cuda.synchronize()
        yp = _call(tk.gcn_layer_reference, t, lambda a: a, mxu_dtype=mxu)
    assert yk.shape == yp.shape and yk.dtype == yp.dtype
    assert rel_l2(yk.float().cpu(), yp.float().cpu()) <= (1e-5 if mxu == "float32" else 1e-2)


@pytest.mark.cuda
def test_fp32_kernel_after_w_updated_in_place(cuda):
    """The fp32 GEMM pass splits W on every call: a W that the optimizer
    updates in place between two calls reaches the second call (B = 2,
    ragged row tiles: 2 * 9 * 40 pixels)."""
    from msfno_torch.runtime import exact_fp32_matmuls

    exact_fp32_matmuls()
    ops = _case(2, 9, 40, 64, 96, True, seed=9)
    t = _on_card(ops, cuda, "float32")
    with torch.inference_mode():
        y0 = _call(tk.gcn_layer, t, lambda a: a, mxu_dtype="float32")
        t["w"].mul_(-0.5).add_(0.01)
        y1 = _call(tk.gcn_layer, t, lambda a: a, mxu_dtype="float32")
        torch.cuda.synchronize()
        yp = _call(tk.gcn_layer_reference, t, lambda a: a, mxu_dtype="float32")
    assert rel_l2(y1.cpu(), yp.cpu()) <= 1e-5
    assert rel_l2(y0.cpu(), yp.cpu()) > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("c_in,f", [(512, 512), (40, 24), (136, 144), (73, 256), (7, 33)])
def test_split_w_matches_kmajor_split(cuda, c_in, f):
    """The kernel's transposing split of W is `tf32x3.kmajor_split` bit for
    bit: the same rounding, layout and zero padding."""
    from msfno_torch.ops.kernels.tf32x3 import kmajor_split

    w = torch.from_numpy(_case(1, 3, 4, c_in, f, False, seed=10)["w"])
    w[0, 0], w[-1, -1] = 1.0 + 2.0 ** -11, -(1.0 + 3 * 2.0 ** -11)  # ties, away from zero
    out = tk.split_w(w.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), kmajor_split(w))
