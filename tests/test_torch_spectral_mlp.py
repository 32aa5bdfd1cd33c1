"""spectral_mlp of the PyTorch port: its plain version against the JAX
package's Pallas kernel (interpret mode on the CPU), and the CUDA kernel
against the plain version on a card."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import spectral_mlp as tk

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
    from msfno_tpu.ops.pallas import spectral_mlp as jk

    return jnp, jk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(lead, c, hidden, n_hidden, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, *lead, c)).astype(np.float32)
    dims = [c] + [hidden] * n_hidden + [c]
    ws = [(0.15 * rng.standard_normal((dims[i], dims[i + 1], 2))).astype(np.float32)
          for i in range(len(dims) - 1)]
    return x, ws


@pytest.mark.parametrize("n_hidden", [3, 1])
def test_plain_matches_jax_kernel_fp32(n_hidden):
    # fp32 vs fp32: the rel-L2 ~1e-5 class of reference parity
    jnp, jk = _jax()
    x, ws = _inputs((2, 5, 7), 32, 64, n_hidden)
    coeffs = jnp.asarray(x[0]) + 1j * jnp.asarray(x[1])
    yj = jk.spectral_mlp(coeffs, [jnp.asarray(w) for w in ws], mxu_dtype="float32")
    yt = tk.spectral_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                         mxu_dtype="float32")
    assert yt.shape == (2, 2, 5, 7, 32)
    assert report(f"spectral_mlp[{n_hidden} hidden] re", rel_l2(yt[0], np.real(yj))) <= 1e-5
    assert report(f"spectral_mlp[{n_hidden} hidden] im", rel_l2(yt[1], np.imag(yj))) <= 1e-5


def test_plain_bf16_matches_jax_packed_kernel():
    # same rounding points as the packed (4-product) Pallas kernel: bf16
    # operands, fp32 accumulation.  Sums in another order can flip a hidden
    # value's bf16 rounding by one ulp, hence 1e-3 and not 1e-5.
    jnp, jk = _jax()
    x, ws = _inputs((40,), 32, 64, 3, seed=1)
    flat = []
    for w in ws:
        flat += [jnp.asarray(w[..., 0]), jnp.asarray(w[..., 1])]
    yr, yi = jk._packed_call(jnp.asarray(x[0]), jnp.asarray(x[1]), *flat,
                             mxu_dtype="bfloat16", interpret=True)
    yt = tk.spectral_mlp(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                         mxu_dtype="bfloat16")
    assert rel_l2(yt[0], yr) <= 1e-3
    assert rel_l2(yt[1], yi) <= 1e-3


def test_pack_weights_layout():
    _, ws = _inputs((1,), 16, 32, 1)
    wt = [torch.from_numpy(w) for w in ws]
    buf, dims, offs = tk.pack_weights(wt)
    assert dims == [16, 32, 16] and offs == [0, 32 * 64]
    p0 = buf[: 32 * 64].reshape(32, 64).float()
    wr = wt[0][..., 0].to(torch.bfloat16).float()
    wi = wt[0][..., 1].to(torch.bfloat16).float()
    assert torch.equal(p0[:16, :32], wr) and torch.equal(p0[16:, :32], -wi)
    assert torch.equal(p0[:16, 32:], wi) and torch.equal(p0[16:, 32:], wr)


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,c,hidden", [(1000, 64, 128), (14520, 256, 512)])
def test_kernel_matches_plain(cuda, n_rows, c, hidden):
    # bf16 operands on both sides; 1e-3 covers one-ulp flips of hidden values
    x, ws = _inputs((n_rows,), c, hidden, 3, seed=2)
    z = torch.from_numpy(x).to(cuda)
    wt = [torch.from_numpy(w).to(cuda) for w in ws]
    before = tk.LAUNCHES
    with torch.inference_mode():
        yk = tk.spectral_mlp(z, wt, mxu_dtype="bfloat16")
        torch.cuda.synchronize()
        yp = tk.spectral_mlp_reference(z, wt, mxu_dtype="bfloat16")
    assert tk.LAUNCHES == before + 1
    assert rel_l2(yk.cpu(), yp.cpu()) <= 1e-3


@pytest.mark.parametrize("mxu,tol", [("float32", 1e-5), ("bfloat16", 1e-3)])
def test_layer_mirror_matches_jax_kernel(mxu, tol):
    """The kernel's algebra: one packed GEMM per layer, the [re | im] hidden
    state handed on rounded to the operand dtype; against the Pallas packed
    kernel (interpret mode) at bf16 and the JAX function at fp32."""
    jnp, jk = _jax()
    x, ws = _inputs((40,), 32, 64, 3, seed=3)
    if mxu == "bfloat16":
        flat = []
        for w in ws:
            flat += [jnp.asarray(w[..., 0]), jnp.asarray(w[..., 1])]
        yr, yi = jk._packed_call(jnp.asarray(x[0]), jnp.asarray(x[1]), *flat,
                                 mxu_dtype="bfloat16", interpret=True)
    else:
        yj = jk.spectral_mlp(jnp.asarray(x[0]) + 1j * jnp.asarray(x[1]),
                             [jnp.asarray(w) for w in ws], mxu_dtype="float32")
        yr, yi = np.real(yj), np.imag(yj)
    yt = tk.spectral_mlp_layers(torch.from_numpy(x), [torch.from_numpy(w) for w in ws],
                                0.0, mxu)
    assert yt.shape == (2, 40, 32)
    assert report(f"spectral_mlp layer mirror[{mxu}] re", rel_l2(yt[0], yr)) <= tol
    assert report(f"spectral_mlp layer mirror[{mxu}] im", rel_l2(yt[1], yi)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,c,hidden", [(1, 16, 16), (127, 16, 48), (129, 48, 112),
                                             (1000, 512, 512), (14521, 16, 512),
                                             (300, 256, 32)])
def test_kernel_ragged_sizes(cuda, n_rows, c, hidden):
    """Row counts that fill no 128-row tile, widths 16 to 512."""
    x, ws = _inputs((n_rows,), c, hidden, 3, seed=4)
    z = torch.from_numpy(x).to(cuda)
    wt = [torch.from_numpy(w).to(cuda) for w in ws]
    with torch.inference_mode():
        yk = tk.spectral_mlp(z, wt, mxu_dtype="bfloat16")
        torch.cuda.synchronize()
        yp = tk.spectral_mlp_reference(z, wt, mxu_dtype="bfloat16")
    assert yk.shape == yp.shape == (2, n_rows, c)
    assert rel_l2(yk.cpu(), yp.cpu()) <= 1e-3


@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
def test_fp32_layer_mirror_matches_jax_karatsuba_kernel(mxu):
    """The fp32 kernel's algebra (the packed 4-product layers, fp32 hidden
    state) against the Pallas Karatsuba kernel that the JAX package runs at
    its default fp32 knob (interpret mode); "tensorfloat" is fp32 there
    too."""
    jnp, jk = _jax()
    x, ws = _inputs((300,), 32, 64, 3, seed=5)
    flat = []
    for w in ws:
        flat += [jnp.asarray(w[..., 0]), jnp.asarray(w[..., 1])]
    yr, yi = jk._karatsuba_call(jnp.asarray(x[0]), jnp.asarray(x[1]), *flat, mxu_dtype=mxu,
                                interpret=True, tile_n=128)
    yt = tk.spectral_mlp_layers(torch.from_numpy(x), [torch.from_numpy(w) for w in ws], 0.0,
                                mxu)
    assert report(f"spectral_mlp fp32 layers vs karatsuba[{mxu}] re", rel_l2(yt[0], yr)) <= 1e-5
    assert report(f"spectral_mlp fp32 layers vs karatsuba[{mxu}] im", rel_l2(yt[1], yi)) <= 1e-5


def test_tensorfloat_is_float32_on_cpu():
    x, ws = _inputs((3, 7), 16, 32, 2, seed=6)
    z, wt = torch.from_numpy(x), [torch.from_numpy(w) for w in ws]
    assert torch.equal(tk.spectral_mlp(z, wt, 0.1, "tensorfloat"),
                       tk.spectral_mlp(z, wt, 0.1, "float32"))


def test_pack_weights_fp32():
    """The fp32 kernel's weight buffer: per layer the hi and lo halves of
    the transposed packed matrix P^T (the split-precision core's K-major
    B), offsets into each half; a bf16 pack is refused for fp32 operands."""
    from msfno_torch.ops.kernels import check_prepared
    from msfno_torch.ops.kernels.tf32x3 import split_tf32

    _, ws = _inputs((1,), 16, 32, 1)
    wt = [torch.from_numpy(w) for w in ws]
    buf, dims, offs = tk.pack_weights(wt, "float32")
    assert buf.dtype == torch.float32 and buf.shape == (2, 2 * 32 * 64)
    assert dims == [16, 32, 16] and offs == [0, 32 * 64]
    for w, off in zip(wt, offs):
        pt = tk.packed_matrix(w, torch.float32).t()
        hi, lo = split_tf32(pt)
        n = pt.numel()
        assert torch.equal(buf[0, off:off + n].reshape(pt.shape), hi)
        assert torch.equal(buf[1, off:off + n].reshape(pt.shape), lo)
    check_prepared("spectral_mlp", (buf,), "tensorfloat")
    with pytest.raises(ValueError):
        check_prepared("spectral_mlp", (tk.pack_weights(wt)[0],), "float32")


@pytest.mark.cuda
@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("n_rows,c,hidden", [(127, 16, 48), (1000, 64, 128),
                                             (14520, 256, 512)])
def test_fp32_kernel_matches_plain(cuda, n_rows, c, hidden, mxu):
    # true fp32 FMA on both sides: the sums' order only
    x, ws = _inputs((n_rows,), c, hidden, 3, seed=2)
    z = torch.from_numpy(x).to(cuda)
    wt = [torch.from_numpy(w).to(cuda) for w in ws]
    before = tk.LAUNCHES
    with torch.inference_mode():
        yk = tk.spectral_mlp(z, wt, 0.01, mxu)
        torch.cuda.synchronize()
        yp = tk.spectral_mlp_reference(z, wt, 0.01, mxu)
    assert tk.LAUNCHES == before + 1
    assert yk.shape == yp.shape == (2, n_rows, c)
    assert rel_l2(yk.cpu(), yp.cpu()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k,bn,seg_rows,splits", [
    (1, 8, 1, 128, 0, 1),            # one row, K below a stage
    (127, 100, 73, 128, 0, 1),       # K = 73: a ragged last stage, scalar A rows
    (1000, 329, 256, 112, 0, 1),     # [dxa | dskip]'s 329 columns on 112-column tiles
    (300, 256, 329, 128, 150, 1),    # two segments of 150 rows, K = 329
    (2000, 512, 1024, 128, 0, 1),    # K = 1024: the spectral_mlp block's deepest
    (257, 130, 200, 128, 0, 3),      # K in three ranges of whole stages
])
def test_tf32x3_core_matches_fp64(cuda, m, n, k, bn, seg_rows, splits):
    """The split-precision core alone (`tf32x3.tf32x3_matmul`, csrc/row_gemm.cuh:
    gemm_tf32x3) at ragged sizes: each entry within the fp32 class of the
    fp64 product, (3 * 2^-22 + k * 2^-24) sum_j |a_ij| |b_jk| (the dropped
    lo * lo, the splits' residues, fp32 sums), and its rel-L2 at most twice
    that of a true fp32 product (TF32 off), plus the split's own 1e-6 (a
    one-term product is exact in fp32, not in three TF32 passes)."""
    from msfno_torch.ops.kernels.tf32x3 import tf32x3_matmul

    rng = np.random.default_rng(m + n + k)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32)).to(cuda)
    parts = tf32x3_matmul(a, b, bn=bn, seg_rows=seg_rows, splits=splits)
    torch.cuda.synchronize()
    assert parts.shape == (splits, m, n)
    got = parts.double().sum(0)
    exact = a.double() @ b.double()
    bound = (3 * 2.0 ** -22 + k * 2.0 ** -24) * (a.double().abs() @ b.double().abs())
    assert bool(((got - exact).abs() <= bound).all())
    assert rel_l2(got.cpu(), exact.cpu()) <= 2 * rel_l2((a @ b).cpu(), exact.cpu()) + 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,c,hidden,n_hidden", [(1, 16, 16, 3), (129, 48, 112, 3),
                                                      (14521, 16, 512, 1), (300, 256, 32, 2),
                                                      (1000, 64, 64, 0)])
def test_fp32_kernel_ragged_sizes(cuda, n_rows, c, hidden, n_hidden):
    """The fp32 kernel (a gemm_tf32x3 launch a layer) at row counts that fill
    no 128-row tile, widths 16 to 512, one to four layers: 1e-5 against the
    true fp32 plain version, whose class its split products are in."""
    x, ws = _inputs((n_rows,), c, hidden, n_hidden, seed=7)
    z = torch.from_numpy(x).to(cuda)
    wt = [torch.from_numpy(w).to(cuda) for w in ws]
    before = tk.LAUNCHES
    with torch.inference_mode():
        yk = tk.spectral_mlp(z, wt, 0.05, "float32")
        torch.cuda.synchronize()
        yp = tk.spectral_mlp_reference(z, wt, 0.05, "float32")
    assert tk.LAUNCHES == before + 1
    assert yk.shape == yp.shape == (2, n_rows, c)
    assert rel_l2(yk.cpu(), yp.cpu()) <= 1e-5
