"""Least time of one launch of each hand-written kernel, from the work it
must do: a frozen copy of the per-site arithmetic of `chip_smoke.py`
(phase 3: `spectral_mlp_sites`, `grid_mlp_sites`, `gcn_layer_sites`,
`grid_encoder_spectral_sites`, `spectral_decoder_sites`,
`gcn_layer_bwd_sites`, `spectral_decoder_bwd_sites`,
`spectral_mlp_bwd_sites`, and its `bound_ms`), on the bf16 operands of the
serving tier (the FiLM generator's also on fp32 ones), for a batch of B
samples per launch.

A launch's least time is the larger of its bytes over the HBM rate (each
input byte read once, each output byte written once) and its operations
over the published dense peak of their type (H100 SXM data sheet).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
# "fp32_product": the products of matrix products on fp32 operands, whose
# least time on this card is three TF32 tensor-core passes over hi / lo
# splits (fp32-class); "fp32": elementwise fp32 work on the CUDA cores
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "tf32": 495e12, "fp8": 1979e12,
                  "fp32_product": 495e12 / 3}

F32, BF16 = 4, 2


def least_seconds(nbytes: float, ops: dict) -> float:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items())
    return max(t_bytes, t_ops)


def _shapes(cfg: dict) -> dict:
    h, w = cfg["img_size"]
    hs, ws = h // cfg["scale_factor"], w // cfg["scale_factor"]
    film = cfg["film"]
    f32_gen = film["compute_dtype"] == "float32"
    return dict(h=h, w=w, hs=hs, ws=ws, lmax=hs, mmax=ws // 2 + 1, c=cfg["embed_dim"],
                d=int(cfg["mlp_ratio"] * cfg["embed_dim"]), cin=cfg["in_chans"],
                cout=cfg["out_chans"], layers=cfg["spectral_layers"],
                px=film["sst_shape"][0] * film["sst_shape"][1], g=film["embed_dim"],
                # the generator's activations and operands: bf16, or fp32
                # with fp32-class products
                ge=F32 if f32_gen else BF16, gk="fp32_product" if f32_gen else "bf16")


def spectral_mlp_block(s: dict, b: int):
    """The complex spectral MLP of one block: the Karatsuba form's three
    real products a complex layer on bf16 operands, its fp32 sums."""
    dims = [s["c"]] + [s["d"]] * s["layers"] + [s["c"]]
    n = b * s["lmax"] * s["mmax"]
    pairs = list(zip(dims[:-1], dims[1:]))
    products = sum(6 * n * i * o for i, o in pairs)
    adds = sum(n * (i + 2 * o) for i, o in pairs)
    z = 2 * n * s["c"] * F32
    return z * 2 + sum(i * o * 2 for i, o in pairs) * BF16, {"bf16": products, "fp32": adds}


def grid_mlp_inner(s: dict, b: int):
    """An inner block's channel MLP, c -> d -> c on the inner grid, bf16
    in and out, with its output bias."""
    rows = b * s["hs"] * s["ws"]
    c, d = s["c"], s["d"]
    nbytes = rows * c * BF16 + (d + c) * F32 + 2 * c * d * BF16 + rows * c * BF16
    return nbytes, {"bf16": 2 * rows * (c * d + d * c)}


def grid_encoder_spectral_head(s: dict, b: int):
    """The fused head: the encoder MLP cin -> c -> c + pe, then the
    longitude DFT folded (half the dense product's operations)."""
    n, c, two_m = s["h"] * s["w"], s["c"], 2 * s["mmax"]
    flops = b * (2 * n * (s["cin"] * c + c * c) + s["h"] * two_m * s["w"] * c)
    nbytes = (b * n * s["cin"] * F32 + n * c * BF16 + (s["cin"] * c + c + c * c) * F32
              + s["w"] * two_m * F32 + b * s["h"] * two_m * c * BF16)
    return nbytes, {"bf16": flops}


def spectral_decoder_tail(s: dict, b: int):
    """The fused tail: the inverse longitude DFT folded, the norm + FiLM
    affine, the decoder (c + cin) -> c -> cout, fp32 out."""
    n, c, two_m, cin, cout = s["h"] * s["w"], s["c"], 2 * s["mmax"], s["cin"], s["cout"]
    flops = b * (2 * n * ((c + cin) * c + c * cout) + n * two_m * c)
    nbytes = (b * s["h"] * two_m * c * F32 + b * n * cin * F32 + s["w"] * two_m * F32
              + 2 * b * c * F32 + ((c + cin) * c + c + c * cout) * F32 + b * n * cout * F32)
    return nbytes, {"bf16": flops}


def gcn_layer_conv1(s: dict, b: int):
    px, g, e = b * s["px"], s["g"], s["ge"]
    nbytes = px * e * 3 + (g + g) * F32 + px * g * e
    return nbytes, {"fp32": 15 * px * g}


def gcn_layer_conv(s: dict, b: int):
    px, g, e = b * s["px"], s["g"], s["ge"]
    nbytes = px * g * e * 2 + g * g * e + g * F32 + px * e * 2 + px * g * e
    return nbytes, {s["gk"]: 2 * px * g * g, "fp32": 12 * px * g}


def gcn_layer_bwd_site(s: dict, b: int, c_in: int):
    px, g, e = b * s["px"], s["g"], s["ge"]
    need_dx = c_in > 1
    res = px * g * e if c_in > 1 else 0
    nbytes = (px * g * e * 2 + res + px * c_in * e + px * e * 2 + c_in * g * e
              + F32 * px * c_in * need_dx + F32 * (c_in * g + g))
    return nbytes, {s["gk"]: 4 * px * c_in * g, "fp32": 30 * px * g}


def spectral_decoder_bwd_tail(s: dict, b: int):
    """The tail's backward as the film fine-tune calls it (no weight
    gradients): the MLP's recompute, dh1, dxa and dskip, the two DFTs
    folded."""
    n, c, two_m, cin, cout = s["h"] * s["w"], s["c"], 2 * s["mmax"], s["cin"], s["cout"]
    flops = b * (2 * n * (2 * (c + cin) * c + c * cout) + 2 * n * two_m * c)
    inputs = (b * n * cout * F32 + b * s["h"] * two_m * c * F32 + b * n * cin * F32
              + s["w"] * two_m * F32 + 2 * b * c * F32 + ((c + cin) * c + c + c * cout) * F32)
    outputs = b * s["h"] * two_m * c * F32 + b * n * cin * F32
    return inputs + outputs, {"bf16": flops}


def spectral_mlp_bwd_block(s: dict, b: int):
    dims = [s["c"]] + [s["d"]] * s["layers"] + [s["c"]]
    n = b * s["lmax"] * s["mmax"]
    pairs = list(zip(dims[:-1], dims[1:]))
    flops = sum(8 * n * i * o for i, o in pairs[:-1]) + sum(8 * n * i * o for i, o in pairs)
    z = 2 * n * s["c"] * F32
    return 3 * z + sum(i * o * 2 for i, o in pairs) * BF16, {"bf16": flops}


# kernel -> [(site, share of the kernel's launches)] on the fused serving
# tier and its film fine-tune (the generator: conv1 then `depth` layers)
def _sites(cfg: dict) -> dict:
    depth = cfg["film"]["model_depth"]
    one = 1.0 / (depth + 1)
    return {
        "spectral_mlp": [(spectral_mlp_block, 1.0)],
        "grid_mlp": [(grid_mlp_inner, 1.0)],
        "grid_encoder_spectral": [(grid_encoder_spectral_head, 1.0)],
        "spectral_decoder": [(spectral_decoder_tail, 1.0)],
        "gcn_layer": [(gcn_layer_conv1, one), (gcn_layer_conv, 1.0 - one)],
        "gcn_layer_bwd": [(lambda s, b: gcn_layer_bwd_site(s, b, 1), one),
                          (lambda s, b: gcn_layer_bwd_site(s, b, s["g"]), 1.0 - one)],
        "spectral_decoder_bwd": [(spectral_decoder_bwd_tail, 1.0)],
        "spectral_mlp_bwd": [(spectral_mlp_bwd_block, 1.0)],
    }


def launch_least_seconds(cfg: dict, batch: int) -> dict[str, float]:
    """kernel -> least seconds of one of its launches, averaged over its
    sites in the proportion a step launches them."""
    s = _shapes(cfg)
    return {name: sum(share * least_seconds(*site(s, batch)) for site, share in sites)
            for name, sites in _sites(cfg).items()}
