"""Model FLOPs per sample, counted from the configuration's shapes: the
work the model's algorithm needs, whatever route the program takes.

Counted: every matrix product (2 FLOPs a multiply-add; a complex product
as four real ones), and each longitude or 2-D FFT as a real FFT, 5/2 n
log2 n per transformed line and channel.  Not counted: elementwise work
(norms, activations, the GCN's stencil, soft shrinkage).

`*_finetune` counts one film-only optimizer step of the multi-step loss:
the forward of every rolled step, the input-gradient products along every
path from the loss back to the FiLM parameters, and the weight-gradient
products of the trainable (generator) parameters only, the backbone being
frozen.  With S = ms + 1 rolled steps the paths are: each step's decoder
(to its filmed last block), and for steps 1..S-1 the whole net below the
decoder (encoder and blocks) back to the previous step's output; each
step's generator below its head (input gradients of its residual layers)
and its weights.
"""

from __future__ import annotations

import math


def fft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n)


def sfno_gcn_parts(cfg: dict) -> dict[str, float]:
    """Forward FLOPs per sample of the filmed SFNO, by part."""
    h, w = cfg["img_size"]
    hs, ws = h // cfg["scale_factor"], w // cfg["scale_factor"]
    lmax, mmax = hs, ws // 2 + 1
    c, cin, cout = cfg["embed_dim"], cfg["in_chans"], cfg["out_chans"]
    d = int(cfg["mlp_ratio"] * c)
    n_layers, spec = cfg["num_layers"], cfg["spectral_layers"]
    n, n_in = h * w, hs * ws
    film = cfg["film"]
    px = film["sst_shape"][0] * film["sst_shape"][1]
    g, depth = film["embed_dim"], film["model_depth"]

    def sht(nlat, nlon):  # one analysis or synthesis: FFT along rows + Legendre
        return nlat * c * fft_flops(nlon) + 4 * mmax * lmax * nlat * c

    dims = [c] + [d] * spec + [c]
    spectral = 8 * lmax * mmax * sum(i * o for i, o in zip(dims[:-1], dims[1:]))
    return {
        "encoder": 2 * n * (cin * c + c * c),
        "sht_full": 2 * sht(h, w),  # block 0's analysis, the last block's synthesis
        "sht_inner": 2 * (n_layers - 1) * sht(hs, ws),
        "spectral_mlp": n_layers * spectral,
        "inner_skip": (n_layers - 2) * 2 * n_in * c * c,
        "channel_mlp": (n_layers - 1) * 2 * n_in * 2 * c * d,
        "decoder": 2 * n * ((c + cin) * c + c * cout),
        "generator_layers": 2 * px * g + depth * 2 * px * g * g,
        "generator_head": 2 * g * 2 * c,
    }


def sfno_gcn_forward(cfg: dict) -> float:
    return sum(sfno_gcn_parts(cfg).values())


def sfno_gcn_finetune(cfg: dict, ms: int) -> float:
    p = sfno_gcn_parts(cfg)
    steps = ms + 1
    film = cfg["film"]
    px = film["sst_shape"][0] * film["sst_shape"][1]
    g, depth = film["embed_dim"], film["model_depth"]
    below_decoder = sum(p[k] for k in ("encoder", "sht_full", "sht_inner", "spectral_mlp",
                                       "inner_skip", "channel_mlp"))
    generator_input_grads = depth * 2 * px * g * g + p["generator_head"]
    generator_weight_grads = p["generator_layers"] + p["generator_head"]
    return (steps * sfno_gcn_forward(cfg)
            + steps * p["decoder"]
            + (steps - 1) * below_decoder
            + steps * (generator_input_grads + generator_weight_grads))


def afno_forward(cfg: dict) -> float:
    h, w = cfg["img_size"]
    p, cin, cout, dim = cfg["patch_size"], cfg["in_chans"], cfg["out_chans"], cfg["embed_dim"]
    gh, gw = h // p, w // p
    tokens = gh * gw
    kept = gh * min(gh // 2 + 1, gw // 2 + 1)  # every row, h // 2 + 1 columns
    bs = dim // cfg["num_blocks"]
    hidden = int(cfg["mlp_ratio"] * dim)
    block = (2 * dim * fft_flops(tokens)  # rfft2 and irfft2
             + 2 * 4 * 2 * kept * dim * bs  # two block-diagonal complex layers
             + 2 * tokens * 2 * dim * hidden)
    return 2 * tokens * (p * p * cin) * dim + cfg["depth"] * block + 2 * tokens * dim * cout * p * p

