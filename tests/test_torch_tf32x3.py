"""The split-precision TF32 product of the port's fp32 kernels
(msfno_torch/ops/kernels/tf32x3.py, csrc/row_gemm.cuh:gemm_tf32x3): the
operand split, the product's error class against fp64, the prepared
K-major layouts, and the two kernels' algebra on it (`spectral_mlp_layers`,
`decoder_bwd_f32_passes`) against the JAX package's Pallas kernels in
interpret mode.  All on the CPU; the kernels against these on a card are
the cuda tests of test_torch_spectral_mlp.py and
test_torch_spectral_decoder_bwd.py."""

import numpy as np
import pytest
import torch

from msfno_torch.ops.kernels import spectral_decoder as tk
from msfno_torch.ops.kernels import spectral_decoder_bwd as tb
from msfno_torch.ops.kernels import spectral_mlp as sm
from msfno_torch.ops.kernels.tf32x3 import (K_PAD, kmajor_split, matmul_tf32x3, rna_tf32,
                                            split_tf32, tf32x3_matmul)

torch.set_num_threads(2)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def report(name, value):
    """The measured error, for the parity table (pytest -s shows it)."""
    print(f"parity {name} rel_l2={value:.3e}")
    return value


def _values(seed, shape, spread):
    """fp32 values over 2 * spread binary orders of magnitude, both signs."""
    rng = np.random.default_rng(seed)
    mag = np.exp2(rng.uniform(-spread, spread, shape))
    return torch.from_numpy((mag * rng.choice([-1.0, 1.0], shape)).astype(np.float32))


@pytest.mark.parametrize("spread", [1, 20, 100])
def test_split_hi_is_tf32_and_recovers_x(spread):
    """hi's 13 low significand bits are zero (a tf32 value), so are lo's,
    and hi + lo is x within 2^-22 |x| (hi within half a tf32 ulp, 2^-11 |x|,
    and lo the same rounding of the rest)."""
    x = _values(spread, (4096,), spread)
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    xd = x.double()
    assert ((hi.double() - xd).abs() <= 2.0 ** -11 * xd.abs()).all()
    assert ((hi.double() + lo.double() - xd).abs() <= 2.0 ** -22 * xd.abs()).all()


def test_rna_rounds_ties_away_from_zero():
    """cvt.rna.tf32.f32's rule: nearest, ties away from zero; a value that
    is already tf32 stays."""
    one = 0x3F800000
    cases = {one: one, one + 0x0FFF: one, one + 0x1000: one + 0x2000,  # tie: up
             one + 0x1001: one + 0x2000, one + 0x2000: one + 0x2000,
             one + 0x3000: one + 0x4000}  # the tie of an odd tf32 value: away too
    bits = torch.tensor(list(cases), dtype=torch.int64).to(torch.int32)
    want = torch.tensor(list(cases.values()), dtype=torch.int64).to(torch.int32)
    for sign in (1.0, -1.0):
        x = sign * bits.view(torch.float32)
        assert torch.equal(rna_tf32(x), sign * want.view(torch.float32))


@pytest.mark.parametrize("m,k,n", [(64, 73, 48), (33, 329, 256), (17, 1024, 96)])
def test_product_is_fp32_class(m, k, n):
    """Each entry of the split product is within (3 * 2^-22 + k * 2^-24)
    sum_j |a_ij| |b_jk| of the fp64 product: the dropped lo * lo and the
    splits' residues (2^-22 each), and fp32 sums of k terms.  One TF32 pass
    (hi * hi alone) misses that class; the split product's rel-L2 is that
    of a plain fp32 product."""
    a, b = _values(1, (m, k), 4), _values(2, (k, n), 4)
    exact = a.double() @ b.double()
    bound = (3 * 2.0 ** -22 + k * 2.0 ** -24) * (a.double().abs() @ b.double().abs())
    got = matmul_tf32x3(a, b)
    assert ((got.double() - exact).abs() <= bound).all()
    one_pass = rna_tf32(a) @ rna_tf32(b)
    assert ((one_pass.double() - exact).abs() > bound).any()
    plain = rel_l2(a @ b, exact)
    assert report(f"tf32x3 product [{m}x{k}x{n}] vs fp64", rel_l2(got, exact)) <= 4 * plain
    assert rel_l2(one_pass, exact) > 100 * plain


def test_core_entry_on_cpu_is_the_mirror():
    """`tf32x3_matmul`, the core's own entry point, takes the mirror on a CPU
    tensor, with one partial product."""
    a, b = _values(3, (40, 70), 3), _values(4, (70, 30), 3)
    got = tf32x3_matmul(a, b, bn=112, seg_rows=20, splits=1)
    assert got.shape == (1, 40, 30)
    assert torch.equal(got[0], matmul_tf32x3(a, b))


@pytest.mark.parametrize("k,n", [(329, 256), (73, 256), (256, 329), (1024, 512), (5, 3)])
def test_kmajor_split_layout(k, n):
    """(2, n, k_pad): the hi and lo halves of b^T, each row zero-padded to a
    multiple of K_PAD floats (a 16-byte TMA row stride)."""
    b = _values(k + n, (k, n), 10)
    out = kmajor_split(b)
    k_pad = -(-k // K_PAD) * K_PAD
    assert out.shape == (2, n, k_pad) and out.dtype == torch.float32
    hi, lo = split_tf32(b.t())
    assert torch.equal(out[0, :, :k], hi) and torch.equal(out[1, :, :k], lo)
    assert not out[:, :, k:].any()


def test_prepared_decoder_operands_zero_padded():
    """The tail's fp32 prepare at the serving widths (C 256, S 73, hidden
    256, C_out 73): W1^T as (2, 256, 336), W2 as (2, 256, 80), W1 as (2, 329,
    256), pads zero, the halves those of the weights."""
    from msfno_torch.ops.sht import InverseRealSHT

    rng = np.random.default_rng(5)
    w1 = torch.from_numpy((0.05 * rng.standard_normal((329, 256))).astype(np.float32))
    w2 = torch.from_numpy((0.06 * rng.standard_normal((256, 73))).astype(np.float32))
    mt = torch.as_tensor(np.asarray(InverseRealSHT(4, 32, lmax=4, mmax=5).merged_matrix_t))
    w1t_x3, w2_x3, w1_x3 = tk.prepare(w1, w2, mt, 256, "float32")[4:]
    for got, w, shape in ((w1t_x3, w1, (2, 256, 336)), (w2_x3, w2.t(), (2, 256, 80)),
                          (w1_x3, w1.t(), (2, 329, 256))):
        assert got.shape == shape
        k = w.shape[0]
        assert not got[:, :, k:].any()
        assert torch.equal(got[0, :, :k] + got[1, :, :k], sum(split_tf32(w.t())))


def _jax():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    return jnp


@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
@pytest.mark.parametrize("lead,c,hidden,n_hidden", [((7, 13), 48, 80, 2), ((129,), 16, 32, 0)])
def test_spectral_mlp_layers_on_split_product_match_jax_karatsuba(mxu, lead, c, hidden,
                                                                  n_hidden):
    """The fp32 kernel's algebra (packed 4-product layers, each GEMM the
    split product) against the Pallas Karatsuba kernel that JAX runs for
    both knobs (interpret mode), ragged row counts, to 1e-5: fp32-class
    products on both sides, only the forms and the sums' order differ."""
    jnp = _jax()
    from msfno_tpu.ops.pallas import spectral_mlp as jk

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, int(np.prod(lead)), c)).astype(np.float32)
    dims = [c] + [hidden] * n_hidden + [c]
    ws = [(0.15 * rng.standard_normal((dims[i], dims[i + 1], 2))).astype(np.float32)
          for i in range(len(dims) - 1)]
    flat = []
    for w in ws:
        flat += [jnp.asarray(w[..., 0]), jnp.asarray(w[..., 1])]
    yr, yi = jk._karatsuba_call(jnp.asarray(x[0]), jnp.asarray(x[1]), *flat,
                                negative_slope=0.1, mxu_dtype=mxu, interpret=True, tile_n=128)
    yt = sm.spectral_mlp_layers(torch.from_numpy(x), [torch.from_numpy(w) for w in ws], 0.1,
                                mxu)
    tag = f"spectral_mlp split layers vs karatsuba[{mxu},{lead},{n_hidden} hidden]"
    assert report(tag + " re", rel_l2(yt[0], yr)) <= 1e-5
    assert report(tag + " im", rel_l2(yt[1], yi)) <= 1e-5


OUTS = ("dhm", "dskip", "da", "db", "dw1", "db1", "dw2", "db2")


@pytest.mark.parametrize("mxu", ["float32", "tensorfloat"])
def test_tail_bwd_passes_on_split_product_match_jax(mxu):
    """The fp32 tail backward's passes (`decoder_bwd_f32_passes`: z1, dz1 and
    [dxa | dskip] on the split product; folds, reduces and weight gradients
    in fp32) against the Pallas backward kernel (interpret mode), every
    output, ragged W = 160 (one full 128-pixel tile and one of 32), B = 2,
    the 73-wide skip and cotangent of the serving step (K = C + 73 and K = 73
    not multiples of the core's 32), to 1e-5."""
    jnp = _jax()
    from msfno_tpu.ops.pallas.spectral_decoder import _spectral_decoder_bwd_call
    from msfno_torch.ops.sht import InverseRealSHT

    rng = np.random.default_rng(7)
    r = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    bsz, h, w, mmax, c, s, hidden, c_out = 2, 2, 160, 20, 32, 73, 48, 73
    mt = np.asarray(InverseRealSHT(h, w, lmax=h, mmax=mmax).merged_matrix_t)
    ops = dict(hm=r(bsz, h, 2 * mmax, c), skip=r(bsz, h, w, s), mt=mt,
               a=1.0 + 0.2 * r(bsz, c), b=0.2 * r(bsz, c), w1=0.2 * r(c + s, hidden),
               b1=0.1 * r(hidden), w2=0.2 * r(hidden, c_out), b2=0.1 * r(c_out),
               g=r(bsz, h, w, c_out))
    j = {k: jnp.asarray(v) for k, v in ops.items()}
    outj = _spectral_decoder_bwd_call(
        j["g"], j["hm"], j["skip"], j["a"], j["b"], j["mt"], j["w1"], j["b1"], j["w2"],
        j["b2"], has_b2=True, mxu_dtype=mxu, interpret=True)
    t = {k: torch.from_numpy(v) for k, v in ops.items()}
    outt = tb.decoder_bwd_f32_passes(t["g"], t["hm"], t["skip"], t["mt"], t["a"], t["b"],
                                     t["w1"], t["b1"], t["w2"], t["b2"])
    for name, a, b in zip(OUTS, outt, outj):
        tag = f"decoder_bwd_f32_passes split product[{mxu}] {name}"
        assert report(tag, rel_l2(a, np.reshape(b, a.shape))) <= 1e-5
