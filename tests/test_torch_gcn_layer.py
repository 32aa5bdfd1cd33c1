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
