#!/usr/bin/env python3
"""Smoke run of the PyTorch port (msfno_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the ten CUDA kernels from msfno_torch/csrc, one nvcc per source,
     and print ptxas' registers and spills of every instantiation of the
     split-precision fp32 core (row_gemm.cuh:gemm_tf32x3) and of the GCN
     backward's mma.sync dW (gcn_layer_bwd.cu:dw_mma), failing on a C7520
     line (wgmmas serialized) or a spill there;
  3. each kernel against its plain PyTorch version at the shapes of the
     serving step (grid_mlp also with the inner MLP's fold of
     `fuse_inner_mlp`) and of the fine-tune step (the three backward kernels,
     every output; gcn_layer and gcn_layer_bwd also on the fp32 operands of
     the JAX exact and balanced tiers, within 1e-5; bounds of the head, the
     tail and its backward with the DFTs folded, the least work), and the
     two longitude-DFT kernels at the shapes of the
     net's transforms (fp32 and bf16 operands, fp32 and bf16 inputs), with
     times (CUDA events), the bound, the error and, for the DFT kernels, the
     time of one PyTorch call of the same function (`dft_library_call`);
  4. the full-width filmed SFNO (721x1440x73, 12 blocks, embed 256, GCN FiLM
     generator over a (1, 28, 180, 360) SST history; seeded random weights)
     on both serving paths, `serving_config()` (fused head and tail) and
     `serving_config(fuse_encoder_dft=False, fuse_decoder_tail=False)`,
     each held against the fp32 plain path (rel-L2 <= 3e-2);
  5. a 4-step rollout with per-step SST on each path: finite outputs and
     exactly 12 spectral_mlp, 11 grid_mlp, 1 grid_encoder_spectral, 1
     spectral_decoder and 7 gcn_layer launches per step on the fused path,
     12 / 13 / 0 / 0 / 7 on the unfused one;
  6. the median time per chained step of both paths, timed in turns;
  7. the FiLM fine-tune step at full width through `Trainer`
     (`finetune_config()`, `finetune_train_config()`: film-only, bf16 frozen
     backbone, Adam) with multi_step_training 0 and 1: the film gradient
     and the loss of one step against the fp32 plain path (rel-L2 <= 5e-2 /
     1e-1, loss within 3e-2), a check of descent (5 steps at lr 1e-3 on one
     batch: the loss falls, stays finite, the film parameters move, the
     frozen weights stay bit-identical), exactly 7 / 1 / 0 gcn_layer_bwd /
     spectral_decoder_bwd / spectral_mlp_bwd launches per step with 0 and
     14 / 2 / 12 with 1 (forward launches 1x and 2x the fused serving
     step's), the median ms per train step and the peak memory;
  8. the SHT entry point with lon_dft="pallas" at full width (721x1440x256
     equiangular, lmax 120, mmax 121, rescale 1e5), RealSHT then
     InverseRealSHT with fp32 and with bf16 operands: exactly 1
     dft_analysis and 1 dft_synthesis launch per round trip, held against
     lon_dft="matmul" (rel-L2 <= 1e-5 / 2e-2) and "fft", with the round
     trip's time beside the other two paths';
  9. one full-width step of the other spectral configurations on the
     serving knobs (`serving_config(...)`: the planar FFT, the tensor-train
     linear filter and layer norm with the modulus ComplexReLU at 12 blocks;
     the dense linear filter on the SHT and on the FFT at 2 blocks, whose
     per-block weights are 3.8 and 7.6 GB) against its `exact_config` twin
     (rel-L2 <= 3e-2, finite), with the launches the JAX gates give them.
 10. one full-width step of the JAX exact tier (`SFNOConfig(film=FilmConfig(
     film_gen_type="gcn_custom"))` at its defaults) and of the balanced tier
     (`balanced_config()`): fp32 activations, the generator's gcn_layer on
     fp32 operands (exactly 7 launches, no other kernel), against the
     `exact_config` twin (exact: step rel-L2 <= 1e-4, gamma / beta <= 1e-5;
     balanced: step <= 3e-2), with the ms per step;
 11. the fp32-kernel tier (`fp32_kernel_config()`: the exact tier with every
     kernel on, JAX's `--use-pallas --pallas-grid-mlp --grid-mlp-mxu-dtype
     float32`), fused and unfused, built through the registry
     (`get_model("sfno", "film", cfg=...)`): one step against its
     `exact_config` twin (1e-4, gamma / beta 1e-5), exactly 12 / 11 / 1 / 1
     / 7 launches a step (unfused 12 / 13 / 0 / 0 / 7) in the step and in a
     2-step `running` forecast, finite outputs, and the median ms per step
     of both paths and of the exact tier, timed in turns;
 12. the fp32-kernel tier's FiLM fine-tune step at full width through
     `Trainer` (`fp32_kernel_config(output_dtype="float32")`,
     `finetune_train_config(multi_step_training=0|1, bf16_frozen_params=
     False)`): the loss (1e-5 relative) and the film gradient at the
     modulation and at the generator's parameters (1e-4) of one step
     against its `exact_config` twin with the same weights, the check of
     descent of phase 7, exactly 12 / 11 / 1 / 1 / 7 forward launches per
     rollout step and 7 / 1 / 0 gcn_layer_bwd / spectral_decoder_bwd /
     spectral_mlp_bwd launches per train step with 0 (14 / 2 / 0 with 1),
     the median ms per train step and the peak memory.
Phase 3 also holds every forward kernel and the tail's backward on the fp32
operands of that tier (sites "*/fp32") to 1e-5; at the fp32 sites of the
GCN layer and its backward, the head, the tail and grid_mlp (each of its
four) it records the CUDA kernels one call launches (`route`, by
torch.profiler in a child process: `chip_smoke.py --routes`) and fails if
the fp32 FMA GEMM (`gemm_f32`) is among them or the split-precision one
is not.  Bounds count the products
of matrix products on fp32 operands at 495 / 3 TFLOP/s, three TF32
tensor-core passes (their least time on this card: `PEAK_OPS_PER_S`), and
elementwise fp32 work at 67 TFLOP/s.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  Without a CUDA device it exits with 1 and
prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
# dense, H100 SXM data sheet.  "fp32_product": the products of matrix
# products on fp32 operands.  Their least time on this card is three TF32
# tensor-core passes over hi / lo splits (495 / 3 TFLOP/s, fp32-class:
# csrc/row_gemm.cuh:gemm_tf32x3), whatever route a kernel takes; "fp32":
# elementwise fp32 work, on the CUDA cores' FMA rate.
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12, "fp32_product": 495e12 / 3}
STEPS = 4
TOL = {"spectral_mlp": 1e-3, "grid_mlp": 1e-2, "gcn_layer": 1e-2,
       "grid_encoder_spectral": 1e-2, "spectral_decoder": 1e-2, "gcn_layer_bwd": 1e-2,
       "spectral_decoder_bwd": 1e-2, "spectral_mlp_bwd": 1e-3,
       # bf16 x bf16 products are exact in fp32: only the sum order differs
       "dft_analysis": 1e-5, "dft_synthesis": 1e-5}
REPLACES = {
    "spectral_mlp": "msfno_tpu/ops/pallas/spectral_mlp.py:286",
    "grid_mlp": "msfno_tpu/ops/pallas/grid_mlp.py:179",
    "gcn_layer": "msfno_tpu/ops/pallas/gcn_layer.py:129",
    "grid_encoder_spectral": "msfno_tpu/ops/pallas/grid_mlp.py:455",
    "spectral_decoder": "msfno_tpu/ops/pallas/spectral_decoder.py:107",
    "gcn_layer_bwd": "msfno_tpu/ops/pallas/gcn_layer.py:291",
    "spectral_decoder_bwd": "msfno_tpu/ops/pallas/spectral_decoder.py:287",
    "spectral_mlp_bwd": "msfno_tpu/ops/pallas/spectral_mlp.py:392",
    "dft_analysis": "msfno_tpu/ops/pallas/dft.py:64",
    "dft_synthesis": "msfno_tpu/ops/pallas/dft.py:115",
}
# launches of each kernel's call sites in one serving step, per path: the
# fused head and tail take the place of grid_mlp's encoder and decoder sites
_COMMON = {"spectral_mlp": {"block": 12}, "gcn_layer": {"conv1": 1, "conv": 6}}
SITE_COUNTS = {
    "fused": {**_COMMON, "grid_mlp": {"inner": 11},
              "grid_encoder_spectral": {"head": 1}, "spectral_decoder": {"tail": 1}},
    "unfused": {**_COMMON, "grid_mlp": {"encoder": 1, "inner": 11, "decoder": 1},
                "grid_encoder_spectral": {}, "spectral_decoder": {}},
}
PER_STEP = {path: {name: sum(sites.values()) for name, sites in kernels.items()}
            for path, kernels in SITE_COUNTS.items()}
# the same for the fp32-kernel tier (phase 11): every forward kernel on the
# fp32-operand sites of phase 3
_COMMON_F32 = {"spectral_mlp": {"block/fp32": 12},
               "gcn_layer": {"conv1/fp32": 1, "conv/fp32": 6}}
FP32_SITE_COUNTS = {
    "fused": {**_COMMON_F32, "grid_mlp": {"inner/fp32": 11},
              "grid_encoder_spectral": {"head/fp32": 1}, "spectral_decoder": {"tail/fp32": 1}},
    "unfused": {**_COMMON_F32, "grid_mlp": {"encoder/fp32": 1, "inner/fp32": 11,
                                            "decoder/fp32": 1},
                "grid_encoder_spectral": {}, "spectral_decoder": {}},
}
FP32_PER_STEP = {path: {name: sum(sites.values()) for name, sites in kernels.items()}
                 for path, kernels in FP32_SITE_COUNTS.items()}
# the backward kernels' fp32-operand sites in one train step of that tier
# with multi_step_training=1 (phase 12)
FP32_TRAIN_SITES = {"gcn_layer_bwd": {"conv1/fp32": 2, "conv/fp32": 12},
                    "spectral_decoder_bwd": {"tail/fp32": 2}}
# the phase 3 sites that the lon_dft="pallas" round trips of phase 8 launch:
# x fp32 in; the synthesis reads the Legendre GEMM's output, fp32 or bf16
DFT_MAIN = {"dft_analysis": {"trans_down/float32/fp32-in": 1, "trans_down/bfloat16/fp32-in": 1},
            "dft_synthesis": {"itrans_up/float32/fp32-in": 1,
                              "itrans_up/bfloat16/bf16-in": 1}}


def log(*args):
    print(*args, flush=True)


# the split-precision core's epilogue and A functors, as ptxas' mangled
# names spell them
TF3_PARTS = ("ComplexRows", "F32Matrix", "MlpInput", "HiddenF32", "OutF32", "TcStore",
             "Z1Store", "DzStore", "DxStore", "HiddenGelu", "OutStore", "OutStats", "TScale",
             "EncRows", "GmInput", "GmHidden")


def ptxas_tf32x3(logs: dict) -> dict:
    """ptxas' report (nvcc -Xptxas -v) of every instantiation of the
    split-precision core (csrc/row_gemm.cuh:gemm_tf32x3) and of the GCN
    backward's split-precision dW (csrc/gcn_layer_bwd.cu:dw_mma, mma.sync)
    in the libraries built in this run: registers, stack, spill stores and
    loads, and the C7520 lines (ptxas serialized the function's wgmmas)
    that name one.  Raises on such a line, and on a function that
    spills."""
    funcs, c7520, func = {}, [], None
    for lib, text in logs.items():
        for line in text.splitlines():
            m = re.search(r"(?:Compiling entry function '|Function properties for )([\w$]+)", line)
            if m:
                func = m.group(1)
            if "C7520" in line and "gemm_tf32x3" in line:
                c7520.append(line.strip())
            if not func or ("gemm_tf32x3" not in func and "dw_mma" not in func):
                continue
            if "dw_mma" in func:
                key = f"{lib}: dw_mma<{'true' if 'dw_mmaILb1E' in func else 'false'}>"
            else:
                tail = func.split("gemm_tf32x3", 1)[1]
                bn = re.match(r"ILi(\d+)E", tail)
                parts = sorted((tail.index(p), p) for p in TF3_PARTS if p in tail)
                key = f"{lib}: gemm_tf32x3<{bn.group(1) if bn else '?'}, " \
                      f"{', '.join(p for _, p in parts)}>"
            rec = funcs.setdefault(key, {})
            if m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                              r"(\d+) bytes spill loads", line):
                rec.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
            if m := re.search(r"Used (\d+) registers", line):
                rec["registers"] = int(m.group(1))
    rec = {"phase": "ptxas_gemm_tf32x3", "libraries": sorted(logs),
           "functions": funcs, "c7520": c7520}
    log(json.dumps(rec))
    if c7520:
        raise AssertionError(f"ptxas serialized gemm_tf32x3's wgmmas: {c7520}")
    spills = [k for k, r in funcs.items() if r.get("spill_stores") or r.get("spill_loads")]
    if spills:
        raise AssertionError(f"ptxas spilled in {spills}")
    return rec


def rel_l2(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, ops: dict) -> tuple[float, str]:
    """Least time for the work: moving `nbytes` once at the HBM rate, or the
    operations at their type's peak, whichever is larger."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = sum(n / PEAK_OPS_PER_S[kind] for kind, n in ops.items()) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def launched_kernels(fn) -> list:
    """The CUDA kernels that one call of `fn` launches, by name
    (torch.profiler; namespaces and argument lists dropped)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = set()
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            name = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
            names.add(name.removeprefix("void "))
    return sorted(names)


def check_site(name, site, kernel_fn, plain_fn, work, iters, time_fn=None, compare=None,
               library_fn=None, tol=None):
    """Kernel against plain version on the same inputs; times and bound.
    `time_fn`, when given, is the call the main path makes (timed in place
    of `kernel_fn`, which may compute more outputs for the check);
    `compare(out_k, out_p) -> (error, extra record)` replaces the largest
    rel-L2 over the outputs as the error held to the tolerance;
    `library_fn`, when given, is one PyTorch call that computes the same
    function, timed as `library_ms`; `tol` replaces the kernel's TOL."""
    import torch

    with torch.inference_mode():
        out_k = kernel_fn()
        torch.cuda.synchronize()
        out_p = plain_fn()
        # grid_mlp with statistics and the backward kernels return tuples:
        # every output is held to the tolerance
        pairs = [(a.float(), b.float()) for a, b in zip(*(
            (o if isinstance(o, tuple) else (o,)) for o in (out_k, out_p)))
            if a is not None and b is not None]
        errs = [rel_l2(a, b) for a, b in pairs]
        err, extra = (max(errs), {}) if compare is None else compare(out_k, out_p)
        max_abs = max(float((a - b).abs().max()) for a, b in pairs)
        del out_k, out_p, pairs
        ms = cuda_ms(time_fn or kernel_fn, iters)
        plain = cuda_ms(plain_fn, max(1, iters // 4), warmup=1)
        library = cuda_ms(library_fn, iters) if library_fn is not None else None
    b_ms, by = bound_ms(*work)
    tol = TOL[name] if tol is None else tol
    rec = dict(kernel=name, site=site, rel_l2=err, rel_l2_each=errs, max_abs_err=max_abs,
               tol=tol, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by,
               library_ms=library, **extra)
    log(json.dumps(rec))
    if not err <= tol:
        raise AssertionError(f"{name}[{site}] disagrees with its plain version: "
                             f"rel-L2 {err:.3e} > {tol}")
    return rec


def _randn(dev, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0, dtype=torch.float32):
        return (scale * torch.randn(shape, device=dev, generator=g)).to(dtype)

    return rn, g


def spectral_mlp_sites(dev):
    """spectral_mlp at one block's shapes: 120 x 121 modes,
    256 -> 512 -> 512 -> 512 -> 256."""
    from msfno_torch.ops.kernels import spectral_mlp as sk

    rn, _ = _randn(dev, 1)
    dims = [256, 512, 512, 512, 256]
    z = rn(2, 1, 120, 121, 256)
    ws = [rn(dims[i], dims[i + 1], 2, scale=0.05) for i in range(4)]
    n = 120 * 121
    # the least work is the TPU kernel's Karatsuba form (`_karatsuba_call`):
    # three real products a complex layer, on the operand type, and the fp32
    # sums hr + hi, k1 - k3 and k1 + k2; the CUDA kernels run the packed
    # 4-product form, 4/3 of these products
    products = sum(6 * n * dims[i] * dims[i + 1] for i in range(4))
    adds = sum(n * (dims[i] + 2 * dims[i + 1]) for i in range(4))
    recs = []
    for mxu, kind in (("bfloat16", "bf16"), ("float32", "fp32")):
        packed = sk.pack_weights(ws, mxu)
        ops = {"fp32_product" if kind == "fp32" else "bf16": products, "fp32": adds}
        # each weight value once in the operand type (the packed matrix holds
        # it twice, and the fp32 pack as hi and lo halves)
        work = (nbytes(z) * 2 + sum(w.numel() for w in ws) * (2 if kind == "bf16" else 4), ops)
        recs.append(check_site(
            "spectral_mlp", "block" + ("/fp32" if kind == "fp32" else ""),
            lambda: sk.spectral_mlp(z, ws, 0.0, mxu, packed=packed),
            lambda: sk.spectral_mlp_reference(z, ws, 0.0, mxu), work,
            20 if kind == "bf16" else 5, tol=FP32_TOL if kind == "fp32" else None))
    return recs


def _grid_mlp_ops(rn, h, h_inner, w):
    """grid_mlp's operands at its sites (see grid_mlp_sites), h latitude
    rows of w longitudes (the inner MLP: h_inner rows of w / 6), and the
    fp32-kernel tier's sites "*/fp32": the same shapes, fp32 activations,
    pe and outputs (its compute dtype)."""
    import torch

    bf = torch.bfloat16
    wi = w // 6
    sites = {
        "encoder": dict(x=rn(1, h, w, 73), w1=rn(73, 256, scale=0.1), b1=rn(256, scale=0.1),
                        w2=rn(256, 256, scale=0.06), pe=rn(h, w, 256, scale=0.02, dtype=bf),
                        stats_rows=h * w, out_dtype="bfloat16"),
        "inner": dict(x=rn(1, h_inner, wi, 256, dtype=bf), w1=rn(256, 512, scale=0.06),
                      b1=rn(512, scale=0.1), w2=rn(512, 256, scale=0.04),
                      b2=rn(256, scale=0.1), out_dtype="bfloat16"),
        "decoder": dict(x=rn(1, h, w, 256, dtype=bf), skip=rn(1, h, w, 73),
                        w1=rn(329, 256, scale=0.05), b1=rn(256, scale=0.1),
                        w2=rn(256, 73, scale=0.06), out_dtype="float32"),
        "inner_fold": dict(x=rn(1, h_inner, wi, 256, dtype=bf), w1=rn(256, 512, scale=0.06),
                           b1=rn(512, scale=0.1), w2=rn(512, 256, scale=0.04),
                           b2=rn(256, scale=0.1),
                           affine=(1.0 + rn(1, 256, scale=0.1), rn(1, 256, scale=0.1)),
                           residual=rn(1, h_inner, wi, 256, dtype=bf), out_dtype="bfloat16"),
    }
    f32 = lambda v: v.float() if isinstance(v, torch.Tensor) else v  # noqa: E731
    for site in list(sites):
        sites[site + "/fp32"] = {
            k: (tuple(map(f32, v)) if isinstance(v, tuple) else f32(v))
            for k, v in sites[site].items()}
        sites[site + "/fp32"]["out_dtype"] = "float32"
    return sites


def grid_mlp_sites(dev):
    """grid_mlp at its three call sites: encoder (+pe, +stats), inner block
    MLP (+b2), big-skip decoder (+skip); and the inner MLP with the folded
    norm + FiLM affine and the residual of `fuse_inner_mlp=True`
    ("inner_fold", which no serving path of SITE_COUNTS launches); each
    also on fp32 operands ("*/fp32")."""
    import torch

    from msfno_torch.ops.kernels import grid_mlp as mk

    rn, _ = _randn(dev, 2)
    sites = _grid_mlp_ops(rn, 721, 120, 1440)
    recs = []
    for site, ops in sites.items():
        mxu, kind = ("float32", "fp32") if site.endswith("/fp32") else ("bfloat16", "bf16")
        x, w1, b1, w2 = ops.pop("x"), ops.pop("w1"), ops.pop("b1"), ops.pop("w2")
        c_main = x.shape[-1]
        prepared = mk.prepare_weights(w1, w2, c_main, mxu)
        rows = x.numel() // c_main
        out_bytes = rows * w2.shape[1] * (2 if ops["out_dtype"] == "bfloat16" else 4)
        flops = 2 * rows * (w1.shape[0] * w1.shape[1] + w2.shape[0] * w2.shape[1])
        work = (nbytes(x, ops.get("skip"), ops.get("pe"), b1, ops.get("b2"),
                       ops.get("residual"), *ops.get("affine", ()))
                + (w1.numel() + w2.numel()) * prepared[0].element_size() + out_bytes,
                {"fp32_product" if kind == "fp32" else kind: flops})
        recs.append(check_site(
            "grid_mlp", site,
            lambda: mk.grid_mlp(x, w1, b1, w2, mxu_dtype=mxu, prepared=prepared, **ops),
            lambda: mk.grid_mlp_reference(x, w1, b1, w2, mxu_dtype=mxu, **ops),
            work, 10 if kind == "bf16" else 4, tol=FP32_TOL if kind == "fp32" else None))
        del x, w1, b1, w2, prepared
        sites[site] = None
        torch.cuda.empty_cache()
    return recs


# fp32-operand sites (the JAX exact and balanced tiers' generator, the
# fp32-kernel tier): fp32-class products (true fp32 FMA, or three TF32
# passes over hi / lo splits), so the plain version is matched to fp32
# rounding
FP32_TOL = 1e-5


def gcn_layer_sites(dev):
    """gcn_layer at the generator's shapes: conv1 (c_in = 1, fp32 outer
    product) and a 512 -> 512 layer with its residual, on bf16 operands and
    activations (the serving tier) and on fp32 ones (sites "*/fp32": the
    exact and balanced tiers)."""
    import torch

    from msfno_torch.ops.kernels import gcn_layer as gk

    rn, g = _randn(dev, 3)
    recs = []
    for dt in (torch.bfloat16, torch.float32):
        mask = (torch.rand((1, 180, 360, 1), device=dev, generator=g) > 0.3).to(dt)
        dinv = (torch.rsqrt(1.0 + 8.0 * mask.float())).to(dt)
        f32 = dt == torch.float32
        mxu = "float32" if f32 else "bfloat16"
        for site, c_in in (("conv1", 1), ("conv", 512)):
            x = rn(1, 180, 360, c_in, dtype=dt)
            wt = rn(c_in, 512, scale=1.0 / c_in ** 0.5)
            b = rn(512, scale=0.1)
            res = rn(1, 180, 360, 512, dtype=dt) if c_in > 1 else None
            wk = wt.to(dt) if c_in > 1 else None
            px = 180 * 360
            if c_in == 1:
                ops = {"fp32": 15 * px * 512}
            elif f32:
                ops = {"fp32_product": 2 * px * c_in * 512, "fp32": 12 * px * 512}
            else:
                ops = {"bf16": 2 * px * c_in * 512, "fp32": 12 * px * 512}
            work = (nbytes(x, wk if c_in > 1 else wt, b, dinv, mask, res)
                    + px * 512 * dt.itemsize, ops)
            recs.append(check_site(
                "gcn_layer", site + ("/fp32" if f32 else ""),
                lambda: gk.gcn_layer(x, wt, b, dinv, mask, residual=res, mxu_dtype=mxu,
                                     prepared=wk),
                lambda: gk.gcn_layer_reference(x, wt, b, dinv, mask, residual=res,
                                               mxu_dtype=mxu),
                work, 10, tol=FP32_TOL if f32 else None))
            del x, wt, b, res, wk
    return recs


def _serving_transforms():
    from msfno_torch.config import serving_config
    from msfno_torch.models.sfno.sfnonet import build_transforms

    return build_transforms(serving_config())


def grid_encoder_spectral_sites(dev):
    """grid_encoder_spectral at the fused head: x (1, 721, 1440, 73) fp32
    -> 73 -> 256 -> 256 + pe (bf16) -> f (1, 721, 242, 256) bf16 + stats."""
    import torch

    from msfno_torch.ops.kernels import grid_encoder_spectral as ek

    rn, _ = _randn(dev, 4)
    h, w, c = 721, 1440, 256
    cs = _serving_transforms()[0]._const("merged", dev)  # (1440, 242)
    x, pe = rn(1, h, w, 73), rn(h, w, c, scale=0.02, dtype=torch.bfloat16)
    w1, b1, w2 = rn(73, c, scale=0.1), rn(c, scale=0.1), rn(c, c, scale=0.06)
    prepared = ek.prepare(w1, w2, cs)
    n, two_m = h * w, cs.shape[1]
    # the least work folds the DFT (half the dense product's operations), as
    # phase 3's DFT sites count it; the bf16 kernel runs the dense product
    flops = 2 * n * (73 * c + c * c) + h * two_m * w * c
    work = (nbytes(x, pe, w1, b1, w2, cs) + h * two_m * c * 2, {"bf16": flops})
    recs = [check_site(
        "grid_encoder_spectral", "head",
        lambda: ek.grid_encoder_spectral(x, w1, b1, w2, pe, cs, prepared=prepared),
        lambda: ek.grid_encoder_spectral_reference(x, w1, b1, w2, pe, cs), work, 10)]
    # the fp32-kernel tier: fp32 pe and f (its DFT pass is dft_analysis's
    # fp32 fold)
    pe = pe.float()
    prepared = ek.prepare(w1, w2, cs, "float32")
    work = (nbytes(x, pe, w1, b1, w2, cs) + h * two_m * c * 4, {"fp32_product": flops})
    recs.append(check_site(
        "grid_encoder_spectral", "head/fp32",
        lambda: ek.grid_encoder_spectral(x, w1, b1, w2, pe, cs, "float32", "float32",
                                         prepared=prepared),
        lambda: ek.grid_encoder_spectral_reference(x, w1, b1, w2, pe, cs, "float32",
                                                   "float32"), work, 4, tol=FP32_TOL))
    return recs


def spectral_decoder_sites(dev):
    """spectral_decoder at the fused tail: hm (1, 721, 242, 256) fp32, the
    folded affine, skip (1, 721, 1440, 73) -> 329 -> 256 -> 73, fp32 out."""
    from msfno_torch.ops.kernels import spectral_decoder as dk

    rn, _ = _randn(dev, 5)
    h, w, c = 721, 1440, 256
    mt = _serving_transforms()[1]._const("merged_t", dev)  # (1440, 242)
    two_m = mt.shape[1]
    hm, skip = rn(1, h, two_m, c, scale=0.05), rn(1, h, w, 73)
    a, b = 1.0 + rn(1, c, scale=0.1), rn(1, c, scale=0.1)
    w1, b1, w2 = rn(c + 73, c, scale=0.05), rn(c, scale=0.1), rn(c, 73, scale=0.06)
    prepared = dk.prepare(w1, w2, mt, c)
    n = h * w
    # the least work folds the inverse DFT (half the dense product's
    # operations); the bf16 kernel runs the dense product
    flops = 2 * n * ((c + 73) * c + c * 73) + n * two_m * c
    work = (nbytes(hm, skip, mt, a, b, w1, b1, w2) + n * 73 * 4, {"bf16": flops})
    recs = [check_site(
        "spectral_decoder", "tail",
        lambda: dk.spectral_decoder(hm, skip, mt, a, b, w1, b1, w2, prepared=prepared),
        lambda: dk.spectral_decoder_reference(hm, skip, mt, a, b, w1, b1, w2), work, 10)]
    # the fp32-kernel tier (its inverse DFT is dft_synthesis's fp32 fold)
    prepared = dk.prepare(w1, w2, mt, c, "float32")
    work = (nbytes(hm, skip, mt, a, b, w1, b1, w2) + n * 73 * 4, {"fp32_product": flops})
    recs.append(check_site(
        "spectral_decoder", "tail/fp32",
        lambda: dk.spectral_decoder(hm, skip, mt, a, b, w1, b1, w2, mxu_dtype="float32",
                                    prepared=prepared),
        lambda: dk.spectral_decoder_reference(hm, skip, mt, a, b, w1, b1, w2,
                                              mxu_dtype="float32"), work, 4, tol=FP32_TOL))
    return recs


def gcn_layer_bwd_sites(dev):
    """gcn_layer_bwd at the generator's shapes, every output (dx, dW, db):
    conv1 (c_in = 1; the path asks for no dx there) and a 512 -> 512 layer
    with its residual, g in bf16 as the bf16 layer output's cotangent; and
    the same on fp32 operands and activations (sites "*/fp32")."""
    import torch

    from msfno_torch.ops.kernels import gcn_layer_bwd as gb

    rn, g = _randn(dev, 6)
    recs = []
    for dt in (torch.bfloat16, torch.float32):
        mask = (torch.rand((1, 180, 360, 1), device=dev, generator=g) > 0.3).to(dt)
        dinv = (torch.rsqrt(1.0 + 8.0 * mask.float())).to(dt)
        f32 = dt == torch.float32
        mxu = "float32" if f32 else "bfloat16"
        for site, c_in in (("conv1", 1), ("conv", 512)):
            x = rn(1, 180, 360, c_in, dtype=dt)
            wt = rn(c_in, 512, scale=1.0 / c_in ** 0.5)
            res = rn(1, 180, 360, 512, dtype=dt) if c_in > 1 else None
            y = (rn(1, 180, 360, 512) + (res.float() if res is not None else 0.0)).to(dt)
            gy = rn(1, 180, 360, 512, scale=1e-3, dtype=dt)
            wk = wt.to(dt)
            px = 180 * 360
            need_dx = c_in > 1
            ops = {"fp32_product" if f32 else "bf16": 4 * px * c_in * 512, "fp32": 30 * px * 512}
            work = (nbytes(gy, y, res, x, dinv, mask, wk) + 4 * px * c_in * need_dx
                    + 4 * (c_in * 512 + 512), ops)
            recs.append(check_site(
                "gcn_layer_bwd", site + ("/fp32" if f32 else ""),
                lambda: gb.gcn_layer_bwd(gy, y, res, x, wt, dinv, mask, mxu_dtype=mxu,
                                         prepared=wk),
                lambda: gb.gcn_layer_bwd_reference(gy, y, res, x, wt, dinv, mask,
                                                   mxu_dtype=mxu),
                work, 10, tol=FP32_TOL if f32 else None,
                time_fn=lambda: gb.gcn_layer_bwd(gy, y, res, x, wt, dinv, mask,
                                                 mxu_dtype=mxu, need_dx=need_dx,
                                                 prepared=wk)))
            del x, wt, res, y, gy, wk
    return recs


def spectral_decoder_bwd_sites(dev):
    """spectral_decoder_bwd at the fused tail's shapes, every output (dhm,
    dskip, da, db, dW1, db1, dW2), on bf16 operands ("tail") and on fp32
    ones ("tail/fp32", the fp32-kernel tier); timed as the film fine-tune
    step calls it, without the weight gradients, and its bound counts that
    call's least work: the two DFTs folded (half the dense products'
    operations), the MLP's recompute, dh1, dxa and dskip, 5.17e11 FLOP (not
    the 7.31e11 with dW1 and dW2; the kernel source states both).  The fp32
    site also records the film-only call's peak of device memory above its
    inputs."""
    import torch

    from msfno_torch.ops.kernels import spectral_decoder as dk
    from msfno_torch.ops.kernels import spectral_decoder_bwd as db_

    rn, _ = _randn(dev, 8)
    h, w, c = 721, 1440, 256
    mt = _serving_transforms()[1]._const("merged_t", dev)
    two_m = mt.shape[1]
    hm, skip = rn(1, h, two_m, c, scale=0.05), rn(1, h, w, 73)
    a, b = 1.0 + rn(1, c, scale=0.1), rn(1, c, scale=0.1)
    w1, b1, w2 = rn(c + 73, c, scale=0.05), rn(c, scale=0.1), rn(c, 73, scale=0.06)
    gy = rn(1, h, w, 73, scale=1e-6)
    n = h * w
    flops = 2 * n * (2 * (c + 73) * c + c * 73) + 2 * n * two_m * c
    args = (gy, hm, skip, mt, a, b, w1, b1, w2)
    recs = []
    for mxu, kind in (("bfloat16", "bf16"), ("float32", "fp32")):
        prepared = dk.prepare(w1, w2, mt, c, mxu)
        work = (nbytes(gy, hm, skip, mt, a, b, w1, b1, w2) + nbytes(hm, skip),
                {"fp32_product" if kind == "fp32" else kind: flops})
        call = lambda need: db_.spectral_decoder_bwd(  # noqa: E731
            *args, mxu_dtype=mxu, need_weights=need, prepared=prepared)
        rec = check_site(
            "spectral_decoder_bwd", "tail" + ("/fp32" if kind == "fp32" else ""),
            lambda: call(True), lambda: db_.spectral_decoder_bwd_reference(*args, mxu_dtype=mxu),
            work, 5 if kind == "bf16" else 4, time_fn=lambda: call(False),
            tol=FP32_TOL if kind == "fp32" else None)
        if kind == "fp32":
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            with torch.inference_mode():
                call(False)
            torch.cuda.synchronize()
            rec["call_peak_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
            log(json.dumps({"kernel": rec["kernel"], "site": rec["site"],
                            "call_peak_gib": rec["call_peak_gib"]}))
        recs.append(rec)
        del prepared
    return recs


def spectral_mlp_bwd_sites(dev):
    """spectral_mlp_bwd at one block's shapes: 120 x 121 modes,
    256 -> 512 -> 512 -> 512 -> 256, the cotangent of its output."""
    from msfno_torch.ops.kernels import spectral_mlp as sk
    from msfno_torch.ops.kernels import spectral_mlp_bwd as sb

    rn, _ = _randn(dev, 9)
    dims = [256, 512, 512, 512, 256]
    z = rn(2, 1, 120, 121, 256)
    gz = rn(2, 1, 120, 121, 256, scale=1e-3)
    ws = [rn(dims[i], dims[i + 1], 2, scale=0.05) for i in range(4)]
    packed = sk.pack_weights(ws)
    n = 120 * 121
    flops = (sum(8 * n * dims[i] * dims[i + 1] for i in range(3))
             + sum(8 * n * dims[i] * dims[i + 1] for i in range(4)))
    work = (nbytes(z, gz) + nbytes(z) + sum(w.numel() * 2 for w in ws), {"bf16": flops})

    def by_rows(out_k, out_p):
        """A one-ulp difference in the recompute can flip a ReLU mask and
        change that mode row's whole gradient (rel-L2 ~ sqrt of the flipped
        share): the rows that agree within 1e-2, at least 98% of them, are
        held to the tolerance, and all rows together to 1e-2."""
        rows = lambda t: t.reshape(2, n, -1).permute(1, 0, 2).reshape(n, -1).double()  # noqa: E731
        kr, pr = rows(out_k), rows(out_p)
        row_err = (kr - pr).norm(dim=1) / pr.norm(dim=1)
        good = row_err <= 1e-2
        share = float(good.double().mean())
        err_good = rel_l2(kr[good], pr[good])
        err_all = rel_l2(kr, pr)
        ok = share >= 0.98 and err_all <= 1e-2
        return (err_good if ok else float("inf")), dict(
            rel_l2_all_rows=err_all, share_rows_within_1e_2=share)

    return [check_site(
        "spectral_mlp_bwd", "block",
        lambda: sb.spectral_mlp_bwd(z, gz, ws, 0.0, "bfloat16", packed=packed),
        lambda: sb.spectral_mlp_bwd_reference(z, gz, ws, 0.0, "bfloat16"), work, 20,
        compare=by_rows)]


# the longitude-DFT sites: the net's transforms at full width (trans_down /
# itrans_up on the 721x1440 equiangular grid, trans / itrans on the 120x240
# Gauss grid) and the spectral losses' SHT on the 73-channel output grid;
# (latitude rows, longitudes, channels), lmax 120 and mmax 121 everywhere
DFT_SITES = {
    "dft_analysis": {"trans_down": (721, 1440, 256), "trans": (120, 240, 256),
                     "loss_sht": (721, 1440, 73)},
    "dft_synthesis": {"itrans_up": (721, 1440, 256), "itrans": (120, 240, 256),
                      "loss_sht": (721, 1440, 73)},
}
DFT_MMAX = 121


def _dtype_tag(dt) -> str:
    import torch

    return "fp32" if dt == torch.float32 else "bf16"


def dft_library_call(merged_t, x, mxu):
    """One PyTorch call that computes a DFT kernel's function on the same
    inputs (fp32 output), for `library_ms`: fp32 operands, torch.matmul with
    TF32 off; bf16 operands, one torch.bmm of the bf16 merged matrix
    (expanded over the rows) against bf16 x with fp32 output
    (`aten::bmm.dtype`: bf16 products, fp32 sums).  The cast of an fp32 x is
    part of the call.  Returns (the call, None) or (None, why the card's
    PyTorch refuses it)."""
    import torch

    from msfno_torch.runtime import mxu_matmul

    if mxu != "bfloat16":
        return (lambda: mxu_matmul(merged_t, x, mxu, out_dtype=None)), None
    a = merged_t.to(torch.bfloat16).expand(x.shape[0], -1, -1)

    def call():
        return torch.bmm(a, x.to(torch.bfloat16), out_dtype=torch.float32)

    try:
        y = call()
    except (RuntimeError, TypeError) as e:
        return None, f"{type(e).__name__}: {e}"
    if y.dtype != torch.float32:
        return None, f"torch.bmm(out_dtype=torch.float32) returned {y.dtype}"
    return call, None


def dft_sites(dev, name):
    """One DFT kernel at each of its sites, with fp32 and bf16 operands and
    fp32 and bf16 inputs; the library call is `dft_library_call`.  The
    bound counts the operations of the even/odd fold (half the dense
    2 * rows * m_out * k_in * c, for both operand types) and each input and
    output byte once."""
    import torch

    from msfno_torch.ops.kernels import dft_analysis as ak
    from msfno_torch.ops.kernels import dft_synthesis as sk
    from msfno_torch.ops.sht import InverseRealSHT, RealSHT

    analysis = name == "dft_analysis"
    rn, _ = _randn(dev, 10 if analysis else 11)
    recs = []
    for site, (rows, w, c) in DFT_SITES[name].items():
        t = (RealSHT if analysis else InverseRealSHT)(rows, w, lmax=120, mmax=DFT_MMAX)
        mod = ak if analysis else sk
        p, q, _ = t._dft_kernel_operands(mod, ("cmat", "smat") if analysis else ("ci", "si"),
                                         dev)
        merged_t = t._const("merged_t", dev)  # (2M, W) or (W, 2M)
        k_in, m_out = (w, 2 * DFT_MMAX) if analysis else (2 * DFT_MMAX, w)
        base = rn(rows, k_in, c)
        for mxu in ("float32", "bfloat16"):
            for dt in (torch.float32, torch.bfloat16):
                x = base.to(dt)
                at = mod.prepare(p, q, mxu)  # what the transform caches
                kind = "bf16" if mxu == "bfloat16" else "fp32_product"
                work = (nbytes(x, p, q) + rows * m_out * c * 4,
                        {kind: rows * m_out * k_in * c})
                kern = ak.dft_analysis if analysis else sk.dft_synthesis
                plain = ak.dft_analysis_plain if analysis else sk.dft_synthesis_plain
                library_fn, why = dft_library_call(merged_t, x, mxu)
                rec = check_site(
                    name, f"{site}/{mxu}/{_dtype_tag(dt)}-in",
                    lambda: kern(x, p, q, mxu, prepared=at), lambda: plain(x, p, q, mxu), work,
                    10, library_fn=library_fn)
                if why is not None:
                    rec["library_error"] = why
                    log(json.dumps({"site": rec["site"], "library_error": why}))
                recs.append(rec)
                del x, at, library_fn
        del base, t
    return recs


SITES = {"spectral_mlp": spectral_mlp_sites, "grid_mlp": grid_mlp_sites,
         "gcn_layer": gcn_layer_sites, "grid_encoder_spectral": grid_encoder_spectral_sites,
         "spectral_decoder": spectral_decoder_sites, "gcn_layer_bwd": gcn_layer_bwd_sites,
         "spectral_decoder_bwd": spectral_decoder_bwd_sites,
         "spectral_mlp_bwd": spectral_mlp_bwd_sites,
         "dft_analysis": lambda dev: dft_sites(dev, "dft_analysis"),
         "dft_synthesis": lambda dev: dft_sites(dev, "dft_synthesis")}


def kernel_checks(dev):
    """Phase 3: every kernel at the serving step's shapes."""
    import torch

    recs = []
    for sites in SITES.values():
        recs += sites(dev)
        torch.cuda.empty_cache()
    return recs


# phase 3's route checks: (kernel, site) -> (a CUDA kernel that one
# main-path call must launch, one that it must not): on fp32 operands conv1
# (c_in = 1) has no product; the other GCN layers' forward GEMM pass, their
# backward's dx and dW, the head's, the tail's and grid_mlp's MLPs (at each
# of grid_mlp's sites) run on the split-precision core, none on the fp32 FMA
# GEMM
ROUTES = {("gcn_layer", "conv/fp32"): ("gemm_tf32x3", "gemm_f32"),
          ("gcn_layer_bwd", "conv1/fp32"): ("gcn_bwd_dsup", "gemm_f32"),
          ("gcn_layer_bwd", "conv/fp32"): ("gemm_tf32x3", "gemm_f32"),
          ("grid_encoder_spectral", "head/fp32"): ("gemm_tf32x3", "gemm_f32"),
          ("spectral_decoder", "tail/fp32"): ("gemm_tf32x3", "gemm_f32"),
          **{("grid_mlp", site): ("gemm_tf32x3", "gemm_f32")
             for site in ("encoder/fp32", "inner/fp32", "decoder/fp32", "inner_fold/fp32")}}


def route_calls(dev) -> dict:
    """One main-path call of each ROUTES site, at a few latitude rows (the
    kernels a call launches do not depend on the row count): gcn_layer and
    gcn_layer_bwd on fp32 operands at 512 -> 512 and the backward at conv1
    (no dx, as the path asks), the head and the tail on fp32 operands at
    1440 longitudes (73 -> 256 -> 256 + pe + statistics; 256 + 73 -> 256 ->
    73), grid_mlp on fp32 operands at its four sites (phase 3's shapes)."""
    import torch

    from msfno_torch.ops.kernels import gcn_layer as gk
    from msfno_torch.ops.kernels import gcn_layer_bwd as gb
    from msfno_torch.ops.kernels import grid_encoder_spectral as ek
    from msfno_torch.ops.kernels import grid_mlp as mk
    from msfno_torch.ops.kernels import spectral_decoder as dk

    rn, g = _randn(dev, 9)
    mask = (torch.rand((1, 16, 360, 1), device=dev, generator=g) > 0.3).float()
    dinv = torch.rsqrt(1.0 + 8.0 * mask)
    calls = {}
    for site, c_in in (("conv1/fp32", 1), ("conv/fp32", 512)):
        x, wt = rn(1, 16, 360, c_in), rn(c_in, 512, scale=1.0 / c_in ** 0.5)
        res = rn(1, 16, 360, 512) if c_in > 1 else None
        y, gy = rn(1, 16, 360, 512), rn(1, 16, 360, 512, scale=1e-3)
        calls[("gcn_layer_bwd", site)] = (
            lambda gy=gy, y=y, res=res, x=x, wt=wt, c_in=c_in: gb.gcn_layer_bwd(
                gy, y, res, x, wt, dinv, mask, mxu_dtype="float32", need_dx=c_in > 1))
        if c_in > 1:
            b = rn(512, scale=0.1)
            calls[("gcn_layer", site)] = lambda x=x, wt=wt, b=b, res=res: gk.gcn_layer(
                x, wt, b, dinv, mask, residual=res, mxu_dtype="float32")
    cs = _serving_transforms()[0]._const("merged", dev)
    xe, pe = rn(1, 4, cs.shape[0], 73), rn(4, cs.shape[0], 256, scale=0.02)
    w1e, b1e, w2e = rn(73, 256, scale=0.1), rn(256, scale=0.1), rn(256, 256, scale=0.06)
    prep_e = ek.prepare(w1e, w2e, cs, "float32")
    calls[("grid_encoder_spectral", "head/fp32")] = lambda: ek.grid_encoder_spectral(
        xe, w1e, b1e, w2e, pe, cs, "float32", "float32", prepared=prep_e)
    for site, ops in _grid_mlp_ops(rn, 4, 16, 1440).items():
        if site.endswith("/fp32"):
            x, w1, b1, w2 = ops.pop("x"), ops.pop("w1"), ops.pop("b1"), ops.pop("w2")
            prep = mk.prepare_weights(w1, w2, x.shape[-1], "float32")
            calls[("grid_mlp", site)] = (
                lambda x=x, w1=w1, b1=b1, w2=w2, prep=prep, ops=ops: mk.grid_mlp(
                    x, w1, b1, w2, mxu_dtype="float32", prepared=prep, **ops))
    mt = _serving_transforms()[1]._const("merged_t", dev)
    c = 256
    hm, skip = rn(1, 4, mt.shape[1], c, scale=0.05), rn(1, 4, mt.shape[0], 73)
    a, b = 1.0 + rn(1, c, scale=0.1), rn(1, c, scale=0.1)
    w1, b1, w2 = rn(c + 73, c, scale=0.05), rn(c, scale=0.1), rn(c, 73, scale=0.06)
    prepared = dk.prepare(w1, w2, mt, c, "float32")
    calls[("spectral_decoder", "tail/fp32")] = lambda: dk.spectral_decoder(
        hm, skip, mt, a, b, w1, b1, w2, mxu_dtype="float32", prepared=prepared)
    return calls


def routes_main() -> int:
    """`python3 chip_smoke.py --routes`: one JSON line of the CUDA kernels
    that each ROUTES site's call launches (`launched_kernels`).  Phase 3 runs
    it as a child process, so that the profiler's tracing never attaches to
    the process whose later phases are timed."""
    import torch

    from msfno_torch.runtime import resolve_device

    dev = resolve_device()
    with torch.inference_mode():
        routes = {f"{k}:{s}": launched_kernels(fn) for (k, s), fn in route_calls(dev).items()}
    print(json.dumps(routes))
    return 0


def check_routes(recs) -> None:
    """Phase 3's route check: the CUDA kernels of each ROUTES site's call,
    from `python3 chip_smoke.py --routes` in a child process, logged and set
    on the site's record; raises unless each site launched its kernel and
    not the one it must not."""
    import os

    child = subprocess.run([sys.executable, os.path.abspath(__file__), "--routes"],
                           capture_output=True, text=True, timeout=600)
    if child.returncode != 0:
        raise AssertionError(f"route check failed:\n{child.stderr[-3000:]}")
    routes = json.loads(child.stdout.strip().splitlines()[-1])
    for rec in recs:
        key = (rec["kernel"], rec["site"])
        if key not in ROUTES:
            continue
        rec["route"] = names = routes[f"{key[0]}:{key[1]}"]
        log(json.dumps({"phase": "route", "kernel": key[0], "site": key[1],
                        "cuda_kernels": names}))
        want, banned = ROUTES[key]
        if not any(want in n for n in names) or any(banned in n for n in names):
            raise AssertionError(f"{key[0]}[{key[1]}] did not take its route ({want}, no "
                                 f"{banned}): {names}")


# backward launches per fine-tune train step (film-only, film_layers=1; the
# fused tail folds the filmed norm1): the generator's 7 layers per rollout
# step, the tail once per scored step, the 12 blocks once per step that the
# gradient crosses (only with multi_step_training=1)
TRAIN_BWD = {0: {"gcn_layer_bwd": 7, "spectral_decoder_bwd": 1, "spectral_mlp_bwd": 0},
             1: {"gcn_layer_bwd": 14, "spectral_decoder_bwd": 2, "spectral_mlp_bwd": 12}}
# the film gradient against the fp32 plain path: at the FiLM modulation
# (gamma, beta), and at the generator's parameters with its activations in
# fp32 (GRAD_TOL); with the bench's bf16 generator, whose backward recovers
# the activation derivative from sign(y - residual) of bf16-stored values as
# the JAX package's kernel does, a few percent of those derivatives flip in
# the residual layers, and the generator's parameter gradient drifts by
# ~25% (GEN_GRAD_TOL; tests/test_torch_gcn_bwd_drift.py isolates the cause)
GRAD_TOL = {0: 5e-2, 1: 1e-1}
GEN_GRAD_TOL = 0.35
DESCENT_STEPS = 5


def film_grads(tr, state, era5, sst):
    """(loss, the gradient at the FiLM modulation (gamma, beta of every
    rollout step), the gradient of the film generator's parameters) of one
    step's loss, both flattened."""
    import torch

    mods = []
    hook = tr.model.film_gen.register_forward_hook(lambda m, i, out: mods.append(out))
    try:
        loss, _ = tr._rollout_loss(era5, sst, state.film_scale)
    finally:
        hook.remove()
    names = sorted(state.trainable)
    grads = torch.autograd.grad(loss, mods + [state.trainable[n] for n in names])
    flat = lambda gs: torch.cat([g.detach().float().reshape(-1) for g in gs])  # noqa: E731
    return float(loss.detach()), flat(grads[:len(mods)]), flat(grads[len(mods):])


def finetune(dev, ms: int):
    """Phase 7 for one configuration: the bench's fine-tune step
    (`finetune_config()`, `finetune_train_config(multi_step_training=ms)`)
    at full width.  Returns its record (with the step's launch counts)."""
    import torch

    from msfno_torch.config import exact_config, finetune_config, finetune_train_config
    from msfno_torch.data.synthetic import gen_batch
    from msfno_torch.training.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    tcfg = finetune_train_config(multi_step_training=ms, learning_rate=1e-3)
    tr = Trainer(finetune_config(), tcfg, device=dev)
    fp32_weights = {k: v.detach().clone() for k, v in tr.model.state_dict().items()}
    state = tr.init_state()
    batch = gen_batch(tr.cfg, 1, ms, seed=11)
    era5, sst = tr._device_batch(batch)

    # the film gradient and loss of one step against the fp32 plain path
    # (exact_config: fp32 knobs, fp32 frozen weights, no kernels)
    loss_k, dmod_k, dgen_k = film_grads(tr, state, era5, sst)
    plain = Trainer(exact_config(finetune_config()),
                    finetune_train_config(multi_step_training=ms, bf16_frozen_params=False),
                    device=dev)
    plain.model.load_state_dict(fp32_weights)
    pstate = plain.init_state()
    loss_p, dmod_p, dgen_p = film_grads(plain, pstate, era5, sst)
    del plain, pstate
    torch.cuda.empty_cache()
    # the same kernel path with the generator's activations in fp32, through
    # the gcn_layer / gcn_layer_bwd kernels' fp32-operand path at full
    # width: isolates the bf16 generator's own drift
    gen32 = finetune_config(film=dataclasses.replace(
        finetune_config().film, compute_dtype="float32"))
    tr32 = Trainer(gen32, tcfg, device=dev)
    tr32.model.load_state_dict(fp32_weights)
    del fp32_weights
    _, dmod_32, dgen_32 = film_grads(tr32, tr32.init_state(), era5, sst)
    del tr32
    torch.cuda.empty_cache()
    mod_err, gen_err = rel_l2(dmod_k, dmod_p), rel_l2(dgen_k, dgen_p)
    gen32_err = rel_l2(dgen_32, dgen_p)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    rec = dict(phase="finetune", multi_step_training=ms, loss=loss_k, loss_fp32_plain=loss_p,
               loss_rel_err=loss_err, loss_tol=3e-2, film_modulation_grad_rel_l2=mod_err,
               film_generator_fp32_activations_grad_rel_l2=gen32_err,
               film_grad_tol=GRAD_TOL[ms], film_generator_grad_rel_l2=gen_err,
               film_generator_grad_tol=GEN_GRAD_TOL)
    log(json.dumps(rec))
    if not (mod_err <= GRAD_TOL[ms] and gen32_err <= GRAD_TOL[ms] and gen_err <= GEN_GRAD_TOL
            and loss_err <= 3e-2):
        raise AssertionError(f"fine-tune ms={ms} vs fp32 plain path: film gradient rel-L2 "
                             f"{mod_err:.3e} at the modulation, {gen32_err:.3e} / {gen_err:.3e} "
                             f"at the generator's parameters (fp32 / bf16 generator "
                             f"activations); loss {loss_err:.3e}")

    want = {name: n * (ms + 1) for name, n in PER_STEP["fused"].items()}
    want.update(TRAIN_BWD[ms])
    rec = descent_check(tr, state, era5, sst, want, f"fine-tune ms={ms}")
    rec["multi_step_training"] = ms
    del tr, state
    torch.cuda.empty_cache()
    return rec


def descent_check(tr, state, era5, sst, want, label):
    """DESCENT_STEPS optimizer steps of `tr` on this one batch at its lr
    (1e-3): the loss falls, stays finite, the film parameters move and the
    frozen weights stay bit-identical.  The launch counts of the first step,
    read just around it, must be `want` (every other kernel: none); CUDA
    events around each step.  Returns the record."""
    import numpy as np
    import torch

    from msfno_torch.ops.kernels import launch_counts, reset_launch_counts

    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    film0 = {k: p.detach().clone() for k, p in state.trainable.items()}
    losses, times, counts = [], [], None
    for i in range(DESCENT_STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        if i == 0:
            reset_launch_counts()
        start.record()
        state, m = tr._train_step(state, era5, sst)
        end.record()
        torch.cuda.synchronize()
        if i == 0:
            counts = launch_counts()
        else:  # the first step warms up
            times.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
    with torch.no_grad():
        final = float(tr._rollout_loss(era5, sst, state.film_scale)[0])
    frozen_same = all(torch.equal(p, frozen0[k]) for k, p in state.frozen.items())
    film_moved = any(not torch.equal(p, film0[k]) for k, p in state.trainable.items())
    finite = all(np.isfinite(v) for v in losses + [final])
    want = {name: want.get(name, 0) for name in counts}
    rec = dict(phase="descent_check", label=label, lr=tr.tcfg.learning_rate, losses=losses,
               loss_after_last_step=final, finite=finite, film_params_changed=film_moved,
               frozen_bit_identical=frozen_same, launches_per_train_step=counts,
               train_step_ms=times, median_train_step_ms=statistics.median(times),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(json.dumps(rec))
    if not (final < losses[0] and finite and film_moved and frozen_same):
        raise AssertionError(f"{label} descent check failed: {rec}")
    if counts != want:
        raise AssertionError(f"{label}: launches {counts} (want {want})")
    return rec


# phase 12: the fp32-kernel tier's FiLM fine-tune step against the fp32
# plain path: fp32 throughout, so the exact tier's limits (loss, and the
# film gradient at the modulation and at the generator's parameters)
FP32_TRAIN_BWD = {0: {"gcn_layer_bwd": 7, "spectral_decoder_bwd": 1},
                  1: {"gcn_layer_bwd": 14, "spectral_decoder_bwd": 2}}
FP32_TRAIN_LOSS_TOL, FP32_TRAIN_GRAD_TOL = 1e-5, 1e-4


def fp32_tier_finetune(dev, ms: int):
    """Phase 12 for one configuration: `fp32_kernel_config(output_dtype=
    "float32")` + `finetune_train_config(multi_step_training=ms,
    bf16_frozen_params=False)` at full width through `Trainer` (a seeded
    random film head, as phase 11's): the loss and the film gradient of one
    step against `exact_config` of the same model with the same weights,
    then `descent_check` with the tier's launches (the forward kernels'
    fp32 sites (ms + 1) times, gcn_layer_bwd and spectral_decoder_bwd on
    fp32 operands, no spectral_mlp_bwd: off bf16 its backward is the
    reference VJP in both packages).  Returns its record."""
    import torch

    from msfno_torch.config import exact_config, finetune_train_config, fp32_kernel_config
    from msfno_torch.data.synthetic import gen_batch
    from msfno_torch.training.trainer import Trainer

    torch.cuda.reset_peak_memory_stats()
    cfg = fp32_kernel_config(output_dtype="float32")
    tcfg = finetune_train_config(multi_step_training=ms, bf16_frozen_params=False,
                                 learning_rate=1e-3)
    tr = Trainer(cfg, tcfg, device=dev)
    _random_film_head(tr.model, dev)
    if not (tr.model.fuse_dft and tr.model.blocks[-1].fuse_tail):
        raise AssertionError("fp32-kernel tier: the fused head and tail do not engage")
    state = tr.init_state()
    era5, sst = tr._device_batch(gen_batch(tr.cfg, 1, ms, seed=12))
    loss_k, dmod_k, dgen_k = film_grads(tr, state, era5, sst)
    plain = Trainer(exact_config(cfg), tcfg, device=dev)
    plain.model.load_state_dict(tr.model.state_dict())
    loss_p, dmod_p, dgen_p = film_grads(plain, plain.init_state(), era5, sst)
    del plain
    torch.cuda.empty_cache()
    mod_err, gen_err = rel_l2(dmod_k, dmod_p), rel_l2(dgen_k, dgen_p)
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    rec = dict(phase="fp32_tier_finetune", multi_step_training=ms, loss=loss_k,
               loss_exact_config=loss_p, loss_rel_err=loss_err, loss_tol=FP32_TRAIN_LOSS_TOL,
               film_modulation_grad_rel_l2=mod_err, film_generator_grad_rel_l2=gen_err,
               film_grad_tol=FP32_TRAIN_GRAD_TOL)
    log(json.dumps(rec))
    if not (loss_err <= FP32_TRAIN_LOSS_TOL and mod_err <= FP32_TRAIN_GRAD_TOL
            and gen_err <= FP32_TRAIN_GRAD_TOL):
        raise AssertionError(f"fp32-kernel tier fine-tune ms={ms} vs exact_config: loss "
                             f"{loss_err:.3e}, film gradient rel-L2 {mod_err:.3e} at the "
                             f"modulation, {gen_err:.3e} at the generator's parameters")
    want = {name: n * (ms + 1) for name, n in FP32_PER_STEP["fused"].items()}
    want.update(FP32_TRAIN_BWD[ms])
    rec.update(descent_check(tr, state, era5, sst, want, f"fp32-kernel tier fine-tune ms={ms}"))
    rec["phase"] = "fp32_tier_finetune"
    del tr, state, era5, sst
    torch.cuda.empty_cache()
    return rec


def sht_round_trip(dev, smi):
    """Phase 8: RealSHT -> InverseRealSHT at full width on each longitude
    path, with fp32 and with bf16 operands; the launch counts of each round
    trip, read just around it.  Returns the phase's record."""
    import torch

    from msfno_torch.ops.kernels import launch_counts, reset_launch_counts
    from msfno_torch.ops.sht import InverseRealSHT, RealSHT

    rn, _ = _randn(dev, 12)
    x = rn(1, 721, 1440, 256)
    tol = {"float32": 1e-5, "bfloat16": 2e-2}
    rec = dict(phase="sht_round_trip", card=smi, shape=list(x.shape), lmax=120, mmax=DFT_MMAX,
               launches={}, rel_l2_vs_matmul={}, rel_l2_vs_fft={}, tol=tol, ms={})
    for mxu in ("float32", "bfloat16"):
        kw = dict(lmax=120, mmax=DFT_MMAX, grid="equiangular", spectral_rescale=1e5,
                  mxu_dtype=mxu)
        ys, times = {}, {}
        for lon in ("pallas", "matmul", "fft"):
            fwd, inv = RealSHT(721, 1440, lon_dft=lon, **kw), InverseRealSHT(721, 1440,
                                                                               lon_dft=lon, **kw)
            with torch.inference_mode():
                reset_launch_counts()
                ys[lon] = inv(fwd(x))
                torch.cuda.synchronize()
                counts = launch_counts()
                times[lon] = cuda_ms(lambda: inv(fwd(x)), 5)
            want = {name: 0 for name in counts}
            if lon == "pallas":
                want.update(dft_analysis=1, dft_synthesis=1)
            if counts != want:
                raise AssertionError(f"round trip lon_dft={lon} {mxu}: launches {counts} "
                                     f"(want {want})")
            rec["launches"][f"{lon}/{mxu}"] = {k: v for k, v in counts.items() if v}
        rec["ms"][mxu] = times
        err_m = rel_l2(ys["pallas"], ys["matmul"])
        err_f = rel_l2(ys["pallas"], ys["fft"])
        rec["rel_l2_vs_matmul"][mxu], rec["rel_l2_vs_fft"][mxu] = err_m, err_f
        finite = bool(torch.isfinite(ys["pallas"]).all())
        del ys
        if not (err_m <= tol[mxu] and err_f <= tol[mxu] and finite):
            raise AssertionError(f"lon_dft='pallas' round trip ({mxu}) vs matmul {err_m:.3e}, "
                                 f"vs fft {err_f:.3e} (tol {tol[mxu]}), finite {finite}")
    log(json.dumps(rec))
    return rec


# phase 9: the other spectral configurations on the serving knobs; the
# dense linear filters at 2 blocks (per-block weights 7260 x 256 x 256 x 2
# and 120 x 121 x 256 x 256 x 2 fp32: 3.8 and 7.6 GB)
SPECTRAL_CONFIGS = {
    "fft": dict(spectral_transform="fft"),
    "linear_tt": dict(filter_type="linear", compression="tt"),
    "layer_norm_modulus": dict(normalization_layer="layer_norm", complex_activation="modulus"),
    "linear_sht_2_blocks": dict(filter_type="linear", num_layers=2),
    "linear_fft_2_blocks": dict(filter_type="linear", spectral_transform="fft", num_layers=2),
}


def gate_launches(cfg) -> dict:
    """The kernel launches of one step that the JAX package's gates give
    these configurations: no fused head or tail (non-linear SHT with
    instance norm only), no spectral_mlp (non-linear SHT with the "real"
    activation only), grid_mlp for the encoder, the channel MLP of every
    block but the last and the decoder, the GCN generator's layers."""
    return {"grid_mlp": cfg.num_layers + 1, "gcn_layer": 1 + cfg.film.model_depth}


def spectral_configs(dev, smi):
    """Phase 9: one full-width step of each configuration against its
    exact_config twin with the same weights.  Returns the records."""
    import torch

    from msfno_torch.config import exact_config, serving_config
    from msfno_torch.models import FourierNeuralOperatorNetFilmed
    from msfno_torch.ops.kernels import launch_counts, reset_launch_counts

    recs = []
    for name, change in SPECTRAL_CONFIGS.items():
        cfg = serving_config(**change)
        net = FourierNeuralOperatorNetFilmed(cfg, device=dev, seed=0)
        x0, sst, _ = model_inputs(cfg, dev, 1)
        with torch.inference_mode():
            reset_launch_counts()
            y_k = net(x0, sst)
            torch.cuda.synchronize()
            counts = launch_counts()
            step_ms = cuda_ms(lambda: net(x0, sst), 2, warmup=0)
        weights = net.state_dict()
        del net
        plain = FourierNeuralOperatorNetFilmed(exact_config(cfg), device=dev, seed=1)
        plain.load_state_dict(weights)
        del weights
        with torch.inference_mode():
            y_p = plain(x0, sst)
        del plain
        err, finite = rel_l2(y_k, y_p), bool(torch.isfinite(y_k).all())
        want = {k: 0 for k in counts}
        want.update(gate_launches(cfg))
        rec = dict(phase="spectral_config", config=name, change=change, card=smi,
                   num_layers=cfg.num_layers, shape=list(y_k.shape), rel_l2_vs_exact=err,
                   tol=3e-2, finite=finite, launches={k: v for k, v in counts.items() if v},
                   step_ms=step_ms, peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(json.dumps(rec))
        del y_k, y_p, x0, sst
        torch.cuda.empty_cache()
        if not (err <= 3e-2 and finite):
            raise AssertionError(f"{name}: serving knobs vs exact_config rel-L2 {err:.3e}, "
                                 f"finite {finite}")
        if counts != want:
            raise AssertionError(f"{name}: launches {counts} (want {want})")
        recs.append(rec)
    return recs


# phase 10: the JAX exact and balanced tiers (`__graft_entry__._flagship_cfg()`
# and `(balanced=True)`): fp32 activations, the generator's gcn_layer on fp32
# operands, no other kernel; the exact tier's generator output (gamma, beta)
# and step against the plain path, the balanced tier's step within the
# bf16-matmul class (JAX's own balanced-vs-exact figure is 0.9%)
TIER_TOL = {"exact": 1e-4, "balanced": 3e-2}
TIER_FILM_TOL = 1e-5


def tier_configs() -> dict:
    from msfno_torch.config import FilmConfig, SFNOConfig, balanced_config

    return {"exact": SFNOConfig(film=FilmConfig(film_gen_type="gcn_custom")),
            "balanced": balanced_config()}


def _step_and_film(net, x0, sst):
    """One step of `net` and its FiLM generator's output."""
    import torch

    mods = []
    hook = net.film_gen.register_forward_hook(lambda m, i, out: mods.append(out))
    try:
        with torch.inference_mode():
            y = net(x0, sst)
    finally:
        hook.remove()
    return y, mods[0]


def jax_tiers(dev, smi):
    """Phase 10: one full-width step of each tier against its exact_config
    twin with the same weights, exactly 7 gcn_layer launches and no other
    kernel, and the ms per step.  Returns the records by tier."""
    import torch

    from msfno_torch.config import exact_config
    from msfno_torch.models import FourierNeuralOperatorNetFilmed
    from msfno_torch.ops.kernels import launch_counts, reset_launch_counts

    recs = {}
    for name, cfg in tier_configs().items():
        net = FourierNeuralOperatorNetFilmed(cfg, device=dev, seed=0)
        _random_film_head(net, dev)
        x0, sst, _ = model_inputs(cfg, dev, 1)
        reset_launch_counts()
        y_k, film_k = _step_and_film(net, x0, sst)
        torch.cuda.synchronize()
        counts = launch_counts()
        with torch.inference_mode():
            step_ms = cuda_ms(lambda: net(x0, sst), 3, warmup=1)
        weights = net.state_dict()
        del net
        plain = FourierNeuralOperatorNetFilmed(exact_config(cfg), device=dev, seed=1)
        plain.load_state_dict(weights)
        del weights
        y_p, film_p = _step_and_film(plain, x0, sst)
        del plain
        err, film_err = rel_l2(y_k, y_p), rel_l2(film_k, film_p)
        finite = bool(torch.isfinite(y_k).all())
        want = {k: 0 for k in counts}
        want["gcn_layer"] = 1 + cfg.film.model_depth
        rec = dict(phase="jax_tier", tier=name, card=smi, shape=list(y_k.shape),
                   rel_l2_vs_exact_config=err, tol=TIER_TOL[name],
                   film_rel_l2_vs_exact_config=film_err,
                   film_tol=TIER_FILM_TOL if name == "exact" else None, finite=finite,
                   launches={k: v for k, v in counts.items() if v}, step_ms=step_ms,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(json.dumps(rec))
        del y_k, y_p, film_k, film_p, x0, sst
        torch.cuda.empty_cache()
        if not (err <= TIER_TOL[name] and finite
                and (name != "exact" or film_err <= TIER_FILM_TOL)):
            raise AssertionError(f"{name} tier vs exact_config: step rel-L2 {err:.3e}, "
                                 f"gamma/beta {film_err:.3e}, finite {finite}")
        if counts != want:
            raise AssertionError(f"{name} tier: launches {counts} (want {want})")
        recs[name] = rec
    return recs


def _random_film_head(net, dev):
    """A seeded random film head: the init's all-ones head makes every gamma
    and beta the same sum, which hides the generator's error."""
    import torch

    head = net.film_gen.film_gen.head_film.weight
    with torch.no_grad():
        head.copy_(torch.randn(head.shape, device=dev,
                               generator=torch.Generator(device=dev).manual_seed(5))
                   / head.shape[1] ** 0.5)


FP32_TIER_STEPS = 2  # steps of the `running` forecast of phase 11


def fp32_kernel_tier(dev, smi):
    """Phase 11: the fp32-kernel tier, fused and unfused, through the
    registry's wrapper: one step against the exact_config twin with the
    same weights, the exact launch counts in that step and in a
    FP32_TIER_STEPS-step `running` forecast, then the ms per step of both
    paths and of the JAX exact tier (same weights), timed in turns.
    Returns the records by path and the timing record."""
    import numpy as np
    import torch

    from msfno_torch.config import exact_config, fp32_kernel_config
    from msfno_torch.models import FourierNeuralOperatorNetFilmed
    from msfno_torch.models.registry import get_model
    from msfno_torch.ops.kernels import launch_counts, reset_launch_counts

    cfgs = {"fused": fp32_kernel_config(),
            "unfused": fp32_kernel_config(fuse_encoder_dft=False, fuse_decoder_tail=False)}
    wraps, recs = {}, {}
    x0, sst, sst_seq = model_inputs(cfgs["fused"], dev, FP32_TIER_STEPS)
    for path, cfg in cfgs.items():
        wrap = get_model("sfno", "film", cfg=cfg, device=dev, seed=0)
        net = wrap.module
        if path == "fused":
            _random_film_head(net, dev)
            if not (net.fuse_dft and net.blocks[-1].fuse_tail):
                raise AssertionError("fp32-kernel tier: the fused head and tail do not engage")
        else:
            net.load_state_dict(wraps["fused"].module.state_dict())
        wraps[path] = wrap
        reset_launch_counts()
        y_k, film_k = _step_and_film(net, x0, sst)
        torch.cuda.synchronize()
        counts = launch_counts()
        reset_launch_counts()
        with torch.inference_mode():
            outs = list(wrap.running(x0, lead_time_h=6 * FP32_TIER_STEPS, sst_seq=sst_seq))
        torch.cuda.synchronize()
        counts_run = launch_counts()
        plain = FourierNeuralOperatorNetFilmed(exact_config(cfg), device=dev, seed=1)
        plain.load_state_dict(net.state_dict())
        y_p, film_p = _step_and_film(plain, x0, sst)
        del plain
        err, film_err = rel_l2(y_k, y_p), rel_l2(film_k, film_p)
        finite = bool(torch.isfinite(y_k).all()) and all(bool(np.isfinite(o).all())
                                                         for o in outs)
        want = {k: 0 for k in counts}
        want.update(FP32_PER_STEP[path])
        want_run = {k: v * FP32_TIER_STEPS for k, v in want.items()}
        rec = dict(phase="fp32_kernel_tier", path=path, card=smi, shape=list(y_k.shape),
                   rel_l2_vs_exact_config=err, tol=TIER_TOL["exact"],
                   film_rel_l2_vs_exact_config=film_err, film_tol=TIER_FILM_TOL,
                   finite=finite, launches={k: v for k, v in counts.items() if v},
                   running_steps=len(outs),
                   launches_running={k: v for k, v in counts_run.items() if v},
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
        log(json.dumps(rec))
        del y_k, y_p, film_k, film_p, outs
        torch.cuda.empty_cache()
        if not (err <= TIER_TOL["exact"] and film_err <= TIER_FILM_TOL and finite):
            raise AssertionError(f"fp32-kernel tier ({path}) vs exact_config: step rel-L2 "
                                 f"{err:.3e}, gamma/beta {film_err:.3e}, finite {finite}")
        if counts != want or counts_run != want_run:
            raise AssertionError(f"fp32-kernel tier ({path}): launches {counts} a step, "
                                 f"{counts_run} in {FP32_TIER_STEPS} running steps "
                                 f"(want {want} a step)")
        recs[path] = rec
    # the ms per step: chained steps, CUDA events around each, in turns
    # with the JAX exact tier on the same weights
    nets = {path: w.module for path, w in wraps.items()}
    nets["exact_tier"] = FourierNeuralOperatorNetFilmed(tier_configs()["exact"], device=dev,
                                                        seed=1)
    nets["exact_tier"].load_state_dict(nets["fused"].state_dict())
    times = {path: [] for path in nets}
    order = ("fused", "unfused", "exact_tier", "exact_tier", "unfused", "fused")
    with torch.inference_mode():
        for path in order:
            state = x0
            for i in range(4):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state = nets[path](state, sst)
                end.record()
                torch.cuda.synchronize()
                if i:  # the first step of a chain warms up
                    times[path].append(start.elapsed_time(end))
    timing = dict(phase="fp32_kernel_tier_step_time", card=smi, order=list(order),
                  median_ms={p: statistics.median(t) for p, t in times.items()}, ms=times,
                  peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    log(json.dumps(timing))
    del nets, wraps, state, x0, sst, sst_seq
    torch.cuda.empty_cache()
    return recs, timing


def model_inputs(cfg, dev, steps):
    import torch

    from msfno_torch.data.synthetic import synthetic_land_mask

    g = torch.Generator(device=dev).manual_seed(7)
    h, w = cfg.img_size
    x0 = torch.randn((1, h, w, cfg.in_chans), device=dev, generator=g)
    hs, ws = cfg.film.sst_shape
    sst = torch.randn((1, cfg.film.temporal_step, hs, ws), device=dev, generator=g)
    land = torch.as_tensor(synthetic_land_mask(hs, ws), device=dev)
    sst[..., land] = float("nan")
    noise = 0.01 * torch.randn((steps,) + tuple(sst.shape), device=dev, generator=g)
    return x0, sst, sst[None] + noise  # per-step SST; NaN stays NaN


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from msfno_torch.config import exact_config, serving_config
    from msfno_torch.inference.rollout import RolloutConfig, rollout
    from msfno_torch.models import FourierNeuralOperatorNetFilmed
    from msfno_torch.ops.kernels import build, launch_counts, reset_launch_counts
    from msfno_torch.runtime import resolve_device

    t_start = time.time()
    # phase 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                    "python": sys.version.split()[0]}))
    dev = resolve_device()  # CUDA, with TF32 off: "float32" means true fp32

    # phase 2, with ptxas' report of the split-precision core
    t0 = time.time()
    logs = build(verbose=True)
    log(json.dumps({"phase": "build", "seconds": time.time() - t0}))
    ptxas_tf32x3(logs)

    # phase 3
    recs = kernel_checks(dev)
    check_routes(recs)

    # phase 4: both serving paths at full width against the fp32 plain path
    nets = {"fused": FourierNeuralOperatorNetFilmed(serving_config(), device=dev, seed=0)}
    unfused_cfg = serving_config(fuse_encoder_dft=False, fuse_decoder_tail=False)
    nets["unfused"] = FourierNeuralOperatorNetFilmed(unfused_cfg, device=dev, seed=0)
    nets["unfused"].load_state_dict(nets["fused"].state_dict())
    if not (nets["fused"].fuse_dft and nets["fused"].blocks[-1].fuse_tail
            and not nets["unfused"].fuse_dft and not nets["unfused"].blocks[-1].fuse_tail):
        raise AssertionError("the fused head and tail engage on the fused path only")
    x0, sst, sst_seq = model_inputs(serving_config(), dev, STEPS)
    plain = FourierNeuralOperatorNetFilmed(exact_config(serving_config()), device=dev, seed=0)
    plain.load_state_dict(nets["fused"].state_dict())
    with torch.inference_mode():
        y_p = plain(x0, sst)
    del plain
    torch.cuda.empty_cache()
    for path, net in nets.items():
        with torch.inference_mode():
            y_k = net(x0, sst)
        step_err = rel_l2(y_k, y_p)
        finite = bool(torch.isfinite(y_k).all())
        log(json.dumps({"phase": "step_vs_fp32_plain", "path": path, "rel_l2": step_err,
                        "tol": 3e-2, "shape": list(y_k.shape), "finite": finite}))
        if not (step_err <= 3e-2 and finite):
            raise AssertionError(f"{path} kernel path vs fp32 plain path: rel-L2 {step_err:.3e}")
        del y_k
    del y_p

    # phase 5: the main path of each configuration, a rollout through the
    # user entry point, with the launch counts read around it
    counts = {}
    for path, net in nets.items():
        reset_launch_counts()
        outs = list(rollout(net, x0, RolloutConfig(steps=STEPS), sst_seq=sst_seq))
        counts[path] = launch_counts()
        finite = all(bool(np.isfinite(o).all()) for o in outs)
        log(json.dumps({"phase": "rollout", "path": path, "steps": len(outs),
                        "shape": list(outs[0].shape), "dtype": str(outs[0].dtype),
                        "finite": finite, "launches": counts[path]}))
        want = {name: 0 for name in counts[path]}  # the backward kernels: none
        want.update({k: v * STEPS for k, v in PER_STEP[path].items()})
        if counts[path] != want or not finite or len(outs) != STEPS:
            raise AssertionError(f"{path} rollout: launches {counts[path]} (want {want}), "
                                 f"finite {finite}")

    # phase 6: chained steps, CUDA events around each, the two paths in
    # turns (fused, unfused, unfused, fused)
    times = {path: [] for path in nets}
    with torch.inference_mode():
        for path in ("fused", "unfused", "unfused", "fused"):
            state = x0
            for i in range(6):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state = nets[path](state, sst_seq[i % STEPS])
                end.record()
                torch.cuda.synchronize()
                if i:  # the first step of a chain warms up
                    times[path].append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(json.dumps({"phase": "step_time", "card": smi,
                    "median_ms": {p: statistics.median(t) for p, t in times.items()},
                    "ms": times, "peak_mem_gib": peak,
                    "seconds_total": time.time() - t_start}))
    del nets, x0, sst, sst_seq, state
    torch.cuda.empty_cache()

    # phase 7: the fine-tune step at full width, film-only, with
    # multi_step_training 0 and 1
    tuned = {ms: finetune(dev, ms) for ms in (0, 1)}
    log(json.dumps({"phase": "train_step_time", "card": smi,
                    "median_ms": {f"multi_step_training={ms}": r["median_train_step_ms"]
                                  for ms, r in tuned.items()},
                    "peak_mem_gib": {f"multi_step_training={ms}": r["peak_mem_gib"]
                                     for ms, r in tuned.items()},
                    "seconds_total": time.time() - t_start}))

    # phase 8: the SHT entry point on the lon_dft="pallas" path
    torch.cuda.empty_cache()
    trip = sht_round_trip(dev, smi)
    torch.cuda.empty_cache()

    # phase 9: the other spectral configurations at full width
    torch.cuda.reset_peak_memory_stats()
    spectral_configs(dev, smi)
    torch.cuda.empty_cache()

    # phase 10: the JAX exact and balanced tiers at full width
    tiers = jax_tiers(dev, smi)
    torch.cuda.reset_peak_memory_stats()

    # phase 11: the fp32-kernel tier at full width, fused and unfused
    f32_tier, f32_times = fp32_kernel_tier(dev, smi)
    log(json.dumps({"phase": "step_time_fp32_kernel_tier_vs_exact_tier", "card": smi,
                    "median_ms": f32_times["median_ms"],
                    "exact_tier_phase_10_ms": tiers["exact"]["step_ms"]}))

    # phase 12: the fp32-kernel tier's fine-tune step at full width, with
    # multi_step_training 0 and 1
    f32_tuned = {ms: fp32_tier_finetune(dev, ms) for ms in (0, 1)}
    log(json.dumps({"phase": "train_step_time_fp32_kernel_tier", "card": smi,
                    "median_ms": {f"multi_step_training={ms}": r["median_train_step_ms"]
                                  for ms, r in f32_tuned.items()},
                    "peak_mem_gib": {f"multi_step_training={ms}": r["peak_mem_gib"]
                                     for ms, r in f32_tuned.items()},
                    "seconds_total": time.time() - t_start}))
    log(json.dumps({"phase": "done", "seconds_total": time.time() - t_start}))

    kernels = []
    for name in SITES:
        mine = [r for r in recs if r["kernel"] == name]
        train = tuned[1]["launches_per_train_step"]
        if name in DFT_MAIN:
            # the DFT kernels' main path is the lon_dft="pallas" round trip,
            # once with fp32 and once with bf16 operands; no net selects it
            per = DFT_MAIN[name]
            launches = {"launches": sum(c.get(name, 0) for c in trip["launches"].values()),
                        "launches_serving_rollout": counts["fused"][name]}
            what = ("the two lon_dft='pallas' SHT round trips of phase 8 at 721x1440x256 "
                    "(fp32 and bf16 operands; sum over their launches)")
        elif name in TRAIN_BWD[1]:
            # the backward kernels' main path is the fine-tune step
            per = {"gcn_layer_bwd": {"conv1": 2, "conv": 12}, "spectral_decoder_bwd": {"tail": 2},
                   "spectral_mlp_bwd": {"block": 12}}[name]
            launches = {"launches": train[name],
                        "launches_multi_step_0": tuned[0]["launches_per_train_step"][name]}
            launches.update({f"launches_fp32_kernel_tier_train_step_multi_step_{ms}":
                             r["launches_per_train_step"][name] for ms, r in f32_tuned.items()})
            what = "one fine-tune train step with multi_step_training=1 (sum over its launches)"
        else:
            per = SITE_COUNTS["fused"][name]
            launches = {"launches": counts["fused"][name],
                        "launches_unfused_path": counts["unfused"][name],
                        "launches_train_step_multi_step_1": train[name]}
            if name == "gcn_layer":
                launches.update({f"launches_jax_{t}_tier_step": r["launches"].get(name, 0)
                                 for t, r in tiers.items()})
            launches.update({f"launches_fp32_kernel_tier_{p}_step": r["launches"].get(name, 0)
                             for p, r in f32_tier.items()})
            what = f"one 6-hour step of the fused path (sum over its launches), {STEPS}-step " \
                   "rollout counts"
        # the fp32-operand sites, summed over one fused step of the
        # fp32-kernel tier (forward kernels) or over its train step with
        # multi_step_training=1 (backward kernels)
        for key, f32_per in (("fp32_kernel_tier_step", FP32_SITE_COUNTS["fused"].get(name)),
                             ("fp32_kernel_tier_train_step_multi_step_1",
                              FP32_TRAIN_SITES.get(name))):
            if not f32_per:
                continue
            f32_sites = [r for r in mine if f32_per.get(r["site"], 0)]
            f32_tot = lambda k: sum(f32_per[r["site"]] * r[k] for r in f32_sites)  # noqa: E731
            launches[key] = dict(
                sites=f32_per, ms=f32_tot("ms"), plain_ms=f32_tot("plain_ms"),
                bound_ms=f32_tot("bound_ms"), rel_l2=max(r["rel_l2"] for r in f32_sites),
                tol=FP32_TOL,
                routes={r["site"]: r["route"] for r in f32_sites if r.get("route") is not None})
        main_sites = [r for r in mine if per.get(r["site"], 0)]
        has_library = name in DFT_MAIN and all(r["library_ms"] is not None for r in main_sites)
        tot = lambda key: sum(per[r["site"]] * r[key] for r in main_sites)  # noqa: E731
        by_bytes = sum(per[r["site"]] * r["bound_ms"] for r in main_sites
                       if r["bound_by"] == "bytes")
        kernels.append(dict(
            name=name, route="cuda", source=f"msfno_torch/csrc/{name}.cu",
            replaces=REPLACES[name], **launches,
            max_abs_err=max(r["max_abs_err"] for r in mine),
            rel_l2=max(r["rel_l2"] for r in mine), tol=TOL[name],
            ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
            bound_by="bytes" if by_bytes >= tot("bound_ms") / 2 else "operations",
            library_ms=tot("library_ms") if has_library else None, per=what,
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(routes_main() if sys.argv[1:] == ["--routes"] else main())
