#!/usr/bin/env python3
"""The fp32 tail backward's kernel and plain outputs against an fp64
evaluation of the same gradients, at phase 3's tail/fp32 inputs, on a CUDA
card: which of the two fp32 versions a rel-L2 between them comes from.

    python3 tools/tail_bwd_fp64.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
from msfno_torch.ops.kernels import spectral_decoder as dk  # noqa: E402
from msfno_torch.ops.kernels import spectral_decoder_bwd as db_  # noqa: E402
from msfno_torch.runtime import resolve_device  # noqa: E402

dev = resolve_device()
rn, _ = chip_smoke._randn(dev, 8)
h, w, c = 721, 1440, 256
mt = chip_smoke._serving_transforms()[1]._const("merged_t", dev)
two_m = mt.shape[1]
hm, skip = rn(1, h, two_m, c, scale=0.05), rn(1, h, w, 73)
a, b = 1.0 + rn(1, c, scale=0.1), rn(1, c, scale=0.1)
w1, b1, w2 = rn(c + 73, c, scale=0.05), rn(c, scale=0.1), rn(c, 73, scale=0.06)
gy = rn(1, h, w, 73, scale=1e-6)
args = (gy, hm, skip, mt, a, b, w1, b1, w2)
with torch.inference_mode():
    k = db_.spectral_decoder_bwd(*args, mxu_dtype="float32",
                                 prepared=dk.prepare(w1, w2, mt, c, "float32"))
    p = db_.spectral_decoder_bwd_reference(*args, mxu_dtype="float32")
    d = lambda t: t.double()  # noqa: E731
    x_raw = torch.matmul(d(mt), d(hm).reshape(h, two_m, c)).reshape(-1, c)
    xin = torch.cat([x_raw * d(a) + d(b), d(skip).reshape(-1, 73)], -1)
    z1 = xin @ d(w1) + d(b1)
    g = d(gy).reshape(-1, 73)
    dz = (g @ d(w2).t()) * db_.gelu_grad(z1)
    dx = dz @ d(w1).t()
    dxa = dx[:, :c]
    dhm = torch.matmul(d(mt).t(), (dxa * d(a)).reshape(h, w, c))
    ref = (dhm, dx[:, c:], (dxa * x_raw).sum(0), dxa.sum(0), xin.t() @ dz, dz.sum(0),
           torch.nn.functional.gelu(z1).t() @ g)
    names = ("dhm", "dskip", "da", "db", "dw1", "db1", "dw2")
    out = {}
    for n, kk, pp, rr in zip(names, k, p, ref):
        rr = rr.reshape(-1)
        err = lambda t: float((d(t).reshape(-1) - rr).norm() / rr.norm())  # noqa: E731
        out[n] = {"kernel_vs_fp64": err(kk), "plain_vs_fp64": err(pp)}
print(json.dumps({"phase": "tail_bwd_fp32_vs_fp64", "rel_l2": out}))
