"""spectral_decoder's backward in the PyTorch port: the plain version of the
`spectral_decoder_bwd` kernel against the JAX package's Pallas backward
kernel (interpret mode on the CPU), the autograd Function against jax.grad of
the JAX `spectral_decoder`, and the CUDA kernel against the plain version on
a card."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import spectral_decoder as tk
from msfno_torch.ops.kernels import spectral_decoder_bwd as tb
from msfno_torch.ops.sht import InverseRealSHT

torch.set_num_threads(2)

NAMES = ("hm", "skip", "mt", "a", "b", "w1", "b1", "w2", "b2")
OUTS = ("dhm", "dskip", "da", "db", "dw1", "db1", "dw2", "db2")


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


def _case(seed=0, b=2, h=4, w=16, mmax=7, c=8, s=3, hidden=12, c_out=3, b2=True):
    """Operands as numpy (hm (B, H, 2M, C), skip (B, H, W, S) with S != C,
    the merged synthesis matrix mt (W, 2M), the affine, the MLP) and a
    cotangent g (B, H, W, C_out)."""
    rng = np.random.default_rng(seed)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    mt = np.asarray(InverseRealSHT(h, w, lmax=h, mmax=mmax).merged_matrix_t)
    return dict(hm=r(b, h, 2 * mmax, c), skip=r(b, h, w, s), mt=mt,
                a=1.0 + 0.2 * r(b, c), b=0.2 * r(b, c), w1=0.3 * r(c + s, hidden),
                b1=0.1 * r(hidden), w2=0.3 * r(hidden, c_out),
                b2=0.1 * r(c_out) if b2 else None, g=r(b, h, w, c_out))


@pytest.mark.parametrize("mxu,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("b2", [True, False])
def test_plain_bwd_matches_jax_kernel(b2, mxu, tol):
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.spectral_decoder import _spectral_decoder_bwd_call

    ops = _case(b2=b2, seed=1)
    j = {k: jnp.asarray(v) if v is not None else None for k, v in ops.items()}
    outj = _spectral_decoder_bwd_call(
        j["g"], j["hm"], j["skip"], j["a"], j["b"], j["mt"], j["w1"], j["b1"], j["w2"],
        j["b2"], has_b2=b2, mxu_dtype=mxu, interpret=True)
    t = {k: torch.from_numpy(v) if v is not None else None for k, v in ops.items()}
    outt = tb.spectral_decoder_bwd(t["g"], *(t[k] for k in NAMES), mxu_dtype=mxu)
    assert (outt[-1] is None) == (not b2)
    for name, a, b in zip(OUTS, outt, outj):
        if a is None:
            continue
        b = np.reshape(b, a.shape)
        assert report(f"spectral_decoder_bwd[b2={b2},{mxu}] {name}", rel_l2(a, b)) <= tol


@pytest.mark.parametrize("need_weights", [True, False])
@pytest.mark.parametrize("mxu,tol", [("float32", 1e-5), ("bfloat16", 1e-2)])
@pytest.mark.parametrize("b2", [True, False])
def test_tile_mirror_matches_jax_kernel(b2, mxu, tol, need_weights):
    """The kernel's two passes (`decoder_bwd_tiles`: 128-longitude tiles, the
    last one ragged at W = 160, x_raw's fp32 bits for da, then the
    transposed DFT) against the JAX Pallas backward kernel, every output."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.spectral_decoder import _spectral_decoder_bwd_call

    ops = _case(b2=b2, seed=3, b=2, h=3, w=160, mmax=20, c=16, s=5, hidden=24, c_out=4)
    j = {k: jnp.asarray(v) if v is not None else None for k, v in ops.items()}
    outj = _spectral_decoder_bwd_call(
        j["g"], j["hm"], j["skip"], j["a"], j["b"], j["mt"], j["w1"], j["b1"], j["w2"],
        j["b2"], has_b2=b2, mxu_dtype=mxu, interpret=True)
    t = {k: torch.from_numpy(v) if v is not None else None for k, v in ops.items()}
    outt = tb.decoder_bwd_tiles(t["g"], *(t[k] for k in NAMES), mxu_dtype=mxu,
                                need_weights=need_weights)
    assert all(d is None for d in outt[4:]) == (not need_weights)
    assert (outt[-1] is None) == (not (b2 and need_weights))
    for name, a, b in zip(OUTS, outt, outj):
        if a is None:
            continue
        b = np.reshape(b, a.shape)
        tag = f"decoder_bwd_tiles[b2={b2},{mxu},w={need_weights}] {name}"
        assert report(tag, rel_l2(a, b)) <= tol


@pytest.mark.parametrize("need_weights", [True, False])
@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("b2", [True, False])
def test_f32_passes_mirror_matches_jax_kernel(b2, mxu, need_weights):
    """The fp32 kernel's passes (`decoder_bwd_f32_passes`: the folded
    inverse DFT, the MLP's GEMMs, da / db over 128-pixel tiles of each
    sample in the kernels' fixed order, the last tile ragged at W = 160, the
    folded forward DFT for dhm) against the JAX Pallas backward kernel on
    fp32 operands, every output; "tensorfloat" runs the same fp32 kernel."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.spectral_decoder import _spectral_decoder_bwd_call

    ops = _case(b2=b2, seed=3, b=2, h=3, w=160, mmax=20, c=16, s=5, hidden=24, c_out=4)
    j = {k: jnp.asarray(v) if v is not None else None for k, v in ops.items()}
    outj = _spectral_decoder_bwd_call(
        j["g"], j["hm"], j["skip"], j["a"], j["b"], j["mt"], j["w1"], j["b1"], j["w2"],
        j["b2"], has_b2=b2, mxu_dtype=mxu, interpret=True)
    t = {k: torch.from_numpy(v) if v is not None else None for k, v in ops.items()}
    outt = tb.decoder_bwd_f32_passes(t["g"], *(t[k] for k in NAMES),
                                     need_weights=need_weights)
    assert all(d is None for d in outt[4:]) == (not need_weights)
    assert (outt[-1] is None) == (not (b2 and need_weights))
    for name, a, b in zip(OUTS, outt, outj):
        if a is None:
            continue
        b = np.reshape(b, a.shape)
        tag = f"decoder_bwd_f32_passes[b2={b2},{mxu},w={need_weights}] {name}"
        assert report(tag, rel_l2(a, b)) <= 1e-5


@pytest.mark.parametrize("b2", [True, False])
def test_function_matches_jax_grad(b2):
    """The autograd Function (plain backward on the CPU) against jax.grad of
    the JAX public spectral_decoder, for every differentiable input."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from msfno_tpu.ops.pallas.spectral_decoder import spectral_decoder as jax_decoder

    ops = _case(b2=b2, seed=2)
    names = [k for k in NAMES if k != "mt" and ops[k] is not None]

    def loss_j(*vals):
        kw = dict(zip(names, vals))
        y = jax_decoder(kw["hm"], kw["skip"], jnp.asarray(ops["mt"]), kw["a"], kw["b"],
                        kw["w1"], kw["b1"], kw["w2"], kw.get("b2"), mxu_dtype="float32")
        return jnp.sum(y * jnp.asarray(ops["g"]))

    gj = jax.grad(loss_j, argnums=tuple(range(len(names))))(
        *[jnp.asarray(ops[k]) for k in names])
    leaves = {k: torch.from_numpy(ops[k]).requires_grad_(True) for k in names}
    y = tk.spectral_decoder(leaves["hm"], leaves["skip"], torch.from_numpy(ops["mt"]),
                            leaves["a"], leaves["b"], leaves["w1"], leaves["b1"],
                            leaves["w2"], leaves.get("b2"), mxu_dtype="float32")
    (y * torch.from_numpy(ops["g"])).sum().backward()
    for k, g in zip(names, gj):
        assert report(f"spectral_decoder grad[b2={b2}] {k}",
                      rel_l2(leaves[k].grad, g)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    dict(b=2, h=3, w=100, mmax=30, c=32, s=5, hidden=48, c_out=5, b2=True),
    dict(b=1, h=2, w=240, mmax=121, c=256, s=73, hidden=256, c_out=73, b2=False),
    # the widths the wrapper takes at most (those of the forward)
    dict(b=1, h=2, w=300, mmax=100, c=256, s=128, hidden=256, c_out=96, b2=True),
])
def test_kernel_matches_plain(cuda, shape):
    ops = _case(seed=7, **shape)
    t = {k: torch.from_numpy(v).to(cuda) if v is not None else None for k, v in ops.items()}
    before = tb.LAUNCHES
    with torch.inference_mode():
        k = tb.spectral_decoder_bwd(t["g"], *(t[n] for n in NAMES))
        torch.cuda.synchronize()
        p = tb.spectral_decoder_bwd_reference(t["g"], *(t[n] for n in NAMES))
        k_path = tb.spectral_decoder_bwd(t["g"], *(t[n] for n in NAMES), need_weights=False)
    assert tb.LAUNCHES == before + 2
    assert all(d is None for d in k_path[4:])
    for name, a, b, c in zip(OUTS, k, p, k_path):
        if b is None:
            continue
        # one-ulp bf16 flips, fp32 sums in another order
        assert rel_l2(a.cpu(), b.cpu()) <= 1e-2, name
        if c is not None:
            assert torch.equal(a, c), name


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("shape", [
    # widths the bf16 kernel refuses (C, hidden not multiples of 16), bf16 hm
    dict(b=2, h=3, w=100, mmax=30, c=24, s=5, hidden=40, c_out=5, b2=True, hm="bfloat16"),
    # the serving step's widths: 2M = 242, 256 + 73 -> 256 -> 73, ragged W
    dict(b=1, h=2, w=1440, mmax=121, c=256, s=73, hidden=256, c_out=73, b2=False),
    dict(b=2, h=2, w=160, mmax=40, c=64, s=73, hidden=256, c_out=73, b2=True),
])
def test_fp32_kernel_matches_plain(cuda, shape, mxu):
    """The fp32 kernel against the plain fp32 backward, every output, with
    and without the weight gradients: true fp32 FMA on both sides, only the
    sums' order (the folds, the fixed-order reduces) differs."""
    shape = dict(shape)
    hm_dtype = getattr(torch, shape.pop("hm", "float32"))
    ops = _case(seed=7, **shape)
    t = {k: torch.from_numpy(v).to(cuda) if v is not None else None for k, v in ops.items()}
    t["hm"] = t["hm"].to(hm_dtype)
    args = (t["g"], *(t[n] for n in NAMES))
    before = tb.LAUNCHES
    with torch.inference_mode():
        k = tb.spectral_decoder_bwd(*args, mxu_dtype=mxu)
        torch.cuda.synchronize()
        assert tb.LAUNCHES == before + 1
        p = tb.spectral_decoder_bwd_reference(*args, mxu_dtype="float32")
        k_path = tb.spectral_decoder_bwd(*args, mxu_dtype=mxu, need_weights=False)
    assert tb.LAUNCHES == before + 2
    assert all(d is None for d in k_path[4:])
    assert (k[-1] is None) == (not shape["b2"])
    for name, a, b, c in zip(OUTS, k, p, k_path):
        if b is None:
            continue
        assert rel_l2(a.cpu(), b.cpu()) <= 1e-5, name
        if c is not None:
            assert torch.equal(a, c), name
