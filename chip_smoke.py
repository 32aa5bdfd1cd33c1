#!/usr/bin/env python3
"""Smoke run of the PyTorch port (msfno_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises, and the script exits non-zero):
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the five CUDA kernels from msfno_torch/csrc, one nvcc per source;
  3. each kernel against its plain PyTorch version at the shapes of the
     serving step, with times (CUDA events), the bound and the error;
  4. the full-width filmed SFNO (721x1440x73, 12 blocks, embed 256, GCN FiLM
     generator over a (1, 28, 180, 360) SST history; seeded random weights)
     on both serving paths, `serving_config()` (fused head and tail) and
     `serving_config(fuse_encoder_dft=False, fuse_decoder_tail=False)`,
     each held against the fp32 plain path (rel-L2 <= 3e-2);
  5. a 4-step rollout with per-step SST on each path: finite outputs and
     exactly 12 spectral_mlp, 11 grid_mlp, 1 grid_encoder_spectral, 1
     spectral_decoder and 7 gcn_layer launches per step on the fused path,
     12 / 13 / 0 / 0 / 7 on the unfused one;
  6. the median time per chained step of both paths, timed in turns.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}.  Without a CUDA device it exits with 1 and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
PEAK_OPS_PER_S = {"bf16": 989e12, "fp32": 67e12}  # dense, H100 SXM data sheet
STEPS = 4
TOL = {"spectral_mlp": 1e-3, "grid_mlp": 1e-2, "gcn_layer": 1e-2,
       "grid_encoder_spectral": 1e-2, "spectral_decoder": 1e-2}
REPLACES = {
    "spectral_mlp": "msfno_tpu/ops/pallas/spectral_mlp.py:286",
    "grid_mlp": "msfno_tpu/ops/pallas/grid_mlp.py:179",
    "gcn_layer": "msfno_tpu/ops/pallas/gcn_layer.py:129",
    "grid_encoder_spectral": "msfno_tpu/ops/pallas/grid_mlp.py:455",
    "spectral_decoder": "msfno_tpu/ops/pallas/spectral_decoder.py:107",
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


def log(*args):
    print(*args, flush=True)


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


def check_site(name, site, kernel_fn, plain_fn, work, iters):
    """Kernel against plain version on the same inputs; times and bound."""
    import torch

    with torch.inference_mode():
        out_k = kernel_fn()
        torch.cuda.synchronize()
        out_p = plain_fn()
        if isinstance(out_k, tuple):  # grid_mlp with statistics
            errs = [rel_l2(a.float(), b.float()) for a, b in zip(out_k, out_p)]
            err, max_abs = max(errs), float((out_k[0].float() - out_p[0].float()).abs().max())
        else:
            err = rel_l2(out_k.float(), out_p.float())
            max_abs = float((out_k.float() - out_p.float()).abs().max())
        ms = cuda_ms(kernel_fn, iters)
        plain = cuda_ms(plain_fn, max(1, iters // 4), warmup=1)
    b_ms, by = bound_ms(*work)
    rec = dict(kernel=name, site=site, rel_l2=err, max_abs_err=max_abs, tol=TOL[name],
               ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=by)
    log(json.dumps(rec))
    if not err <= TOL[name]:
        raise AssertionError(f"{name}[{site}] disagrees with its plain version: "
                             f"rel-L2 {err:.3e} > {TOL[name]}")
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
    packed = sk.pack_weights(ws)
    n = 120 * 121
    flops = sum(8 * n * dims[i] * dims[i + 1] for i in range(4))
    work = (nbytes(z) * 2 + sum(w.numel() * 2 for w in ws), {"bf16": flops})
    return [check_site(
        "spectral_mlp", "block",
        lambda: sk.spectral_mlp(z, ws, 0.0, "bfloat16", packed=packed),
        lambda: sk.spectral_mlp_reference(z, ws, 0.0, "bfloat16"), work, 20)]


def grid_mlp_sites(dev):
    """grid_mlp at its three call sites: encoder (+pe, +stats), inner block
    MLP (+b2), big-skip decoder (+skip)."""
    import torch

    from msfno_torch.ops.kernels import grid_mlp as mk

    rn, _ = _randn(dev, 2)
    bf = torch.bfloat16
    h, w = 721, 1440
    sites = {
        "encoder": dict(x=rn(1, h, w, 73), w1=rn(73, 256, scale=0.1), b1=rn(256, scale=0.1),
                        w2=rn(256, 256, scale=0.06), pe=rn(h, w, 256, scale=0.02, dtype=bf),
                        stats_rows=h * w, out_dtype="bfloat16"),
        "inner": dict(x=rn(1, 120, 240, 256, dtype=bf), w1=rn(256, 512, scale=0.06),
                      b1=rn(512, scale=0.1), w2=rn(512, 256, scale=0.04),
                      b2=rn(256, scale=0.1), out_dtype="bfloat16"),
        "decoder": dict(x=rn(1, h, w, 256, dtype=bf), skip=rn(1, h, w, 73),
                        w1=rn(329, 256, scale=0.05), b1=rn(256, scale=0.1),
                        w2=rn(256, 73, scale=0.06), out_dtype="float32"),
    }
    recs = []
    for site, ops in sites.items():
        x, w1, b1, w2 = ops.pop("x"), ops.pop("w1"), ops.pop("b1"), ops.pop("w2")
        c_main = x.shape[-1]
        prepared = mk.prepare_weights(w1, w2, c_main)
        rows = x.numel() // c_main
        out_bytes = rows * w2.shape[1] * (2 if ops["out_dtype"] == "bfloat16" else 4)
        flops = 2 * rows * (w1.shape[0] * w1.shape[1] + w2.shape[0] * w2.shape[1])
        work = (nbytes(x, ops.get("skip"), ops.get("pe"), b1, ops.get("b2"))
                + (w1.numel() + w2.numel()) * 2 + out_bytes, {"bf16": flops})
        recs.append(check_site(
            "grid_mlp", site,
            lambda: mk.grid_mlp(x, w1, b1, w2, mxu_dtype="bfloat16", prepared=prepared, **ops),
            lambda: mk.grid_mlp_reference(x, w1, b1, w2, mxu_dtype="bfloat16", **ops),
            work, 10))
        del x, w1, b1, w2, prepared, ops
    return recs


def gcn_layer_sites(dev):
    """gcn_layer at the generator's shapes: conv1 (c_in = 1, fp32 outer
    product) and a 512 -> 512 layer with its residual."""
    import torch

    from msfno_torch.ops.kernels import gcn_layer as gk

    rn, g = _randn(dev, 3)
    bf = torch.bfloat16
    mask = (torch.rand((1, 180, 360, 1), device=dev, generator=g) > 0.3).to(bf)
    dinv = (torch.rsqrt(1.0 + 8.0 * mask.float())).to(bf)
    recs = []
    for site, c_in in (("conv1", 1), ("conv", 512)):
        x = rn(1, 180, 360, c_in, dtype=bf)
        wt = rn(c_in, 512, scale=1.0 / c_in ** 0.5)
        b = rn(512, scale=0.1)
        res = rn(1, 180, 360, 512, dtype=bf) if c_in > 1 else None
        wk = wt.to(bf) if c_in > 1 else None
        px = 180 * 360
        ops = ({"bf16": 2 * px * c_in * 512, "fp32": 12 * px * 512} if c_in > 1
               else {"fp32": 15 * px * 512})
        work = (nbytes(x, wk if c_in > 1 else wt, b, dinv, mask, res) + px * 512 * 2, ops)
        recs.append(check_site(
            "gcn_layer", site,
            lambda: gk.gcn_layer(x, wt, b, dinv, mask, residual=res, prepared=wk),
            lambda: gk.gcn_layer_reference(x, wt, b, dinv, mask, residual=res),
            work, 10))
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
    flops = 2 * n * (73 * c + c * c + two_m * c)
    work = (nbytes(x, pe, w1, b1, w2, cs) + h * two_m * c * 2, {"bf16": flops})
    return [check_site(
        "grid_encoder_spectral", "head",
        lambda: ek.grid_encoder_spectral(x, w1, b1, w2, pe, cs, prepared=prepared),
        lambda: ek.grid_encoder_spectral_reference(x, w1, b1, w2, pe, cs), work, 10)]


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
    flops = 2 * n * (two_m * c + (c + 73) * c + c * 73)
    work = (nbytes(hm, skip, mt, a, b, w1, b1, w2) + n * 73 * 4, {"bf16": flops})
    return [check_site(
        "spectral_decoder", "tail",
        lambda: dk.spectral_decoder(hm, skip, mt, a, b, w1, b1, w2, prepared=prepared),
        lambda: dk.spectral_decoder_reference(hm, skip, mt, a, b, w1, b1, w2), work, 10)]


SITES = {"spectral_mlp": spectral_mlp_sites, "grid_mlp": grid_mlp_sites,
         "gcn_layer": gcn_layer_sites, "grid_encoder_spectral": grid_encoder_spectral_sites,
         "spectral_decoder": spectral_decoder_sites}


def kernel_checks(dev):
    """Phase 3: every kernel at the serving step's shapes."""
    import torch

    recs = []
    for sites in SITES.values():
        recs += sites(dev)
        torch.cuda.empty_cache()
    return recs


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

    # phase 2
    t0 = time.time()
    build()
    log(json.dumps({"phase": "build", "seconds": time.time() - t0}))

    # phase 3
    recs = kernel_checks(dev)

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
        want = {k: v * STEPS for k, v in PER_STEP[path].items()}
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

    kernels = []
    for name in SITES:
        mine = [r for r in recs if r["kernel"] == name]
        per = SITE_COUNTS["fused"][name]
        tot = lambda key: sum(per.get(r["site"], 0) * r[key] for r in mine)
        by_bytes = sum(per.get(r["site"], 0) * r["bound_ms"] for r in mine
                       if r["bound_by"] == "bytes")
        kernels.append(dict(
            name=name, route="cuda", source=f"msfno_torch/csrc/{name}.cu",
            replaces=REPLACES[name], launches=counts["fused"][name],
            launches_unfused_path=counts["unfused"][name],
            max_abs_err=max(r["max_abs_err"] for r in mine),
            rel_l2=max(r["rel_l2"] for r in mine), tol=TOL[name],
            ms=tot("ms"), plain_ms=tot("plain_ms"), bound_ms=tot("bound_ms"),
            bound_by="bytes" if by_bytes >= tot("bound_ms") / 2 else "operations",
            library_ms=None,
            per=f"one 6-hour step of the fused path (sum over its launches), {STEPS}-step "
                "rollout counts",
        ))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
