#!/usr/bin/env python3
"""Where the time of one serving step, or of one fine-tune train step, of
the PyTorch port goes, on a CUDA card.

    python3 tools/profile_torch_step.py [--steps N] [--trace FILE]
    python3 tools/profile_torch_step.py --tier fp32 [--steps N] [--trace FILE]
    python3 tools/profile_torch_step.py --train [--tier fp32] [--steps N] [--trace FILE]

Serving: builds the full-width filmed SFNO of
`msfno_torch.config.serving_config()` (the fused head and tail) and the same
net with both unfused, with the same seeded random weights.  For each path it
runs two warm-up steps, then profiles N chained steps with torch.profiler
(CPU + CUDA activity).  Prints, per path, one JSON line per kernel or op
sorted by device time (ms per step), the hand-written kernels' ms and calls
per step, and the wall and device-busy time per step with the device's idle
share; then both paths' median step times from CUDA events, timed in turns
(fused, unfused, unfused, fused) in the same process, and the card's name
and power limit.

--tier fp32: the same for the fp32-kernel tier (`fp32_kernel_config()`,
the JAX exact tier with every kernel on fp32 operands), fused and unfused.
Its grid_mlp, head and tail share the fp32 MLP's GEMM kernels
(csrc/mlp_f32.cuh), so their device time is reported together as
"fp32_mlp"; the folded DFT passes by direction, "dft_fold_analysis" (the
head's DFT, and in a train step the tail backward's dhm) and
"dft_fold_synthesis" (the tail's inverse DFT, and in a train step the tail
backward's recompute of it).

--train: the same for the FiLM fine-tune train step (`Trainer._train_step`
of `finetune_config()` / `finetune_train_config()`: film-only, bf16 frozen
backbone, Adam; with --tier fp32, `fp32_kernel_config(output_dtype=
"float32")` / `finetune_train_config(bf16_frozen_params=False)`, the
fp32-kernel tier with its fp32 frozen weights) with multi_step_training 0
and 1, each on one fixed synthetic batch: two warm-up steps, N profiled
steps, then the median train step times from CUDA events in turns (0, 1,
1, 0).

With --trace, writes the first path's Chrome trace to FILE.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def breakdown(prof, steps: int, wall: float, path: str) -> None:
    """Print the device-side rows of a profile, the kernels' share and the
    idle share, per step."""
    import torch

    from msfno_torch.ops.kernels import KERNELS

    rows = []
    for ev in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): op-level rows
        # would count their kernels a second time
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, ev.key, ev.count / steps))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    for ms, key, count in rows[:30]:
        print(json.dumps({"path": path, "op": key[:90], "ms_per_step": ms,
                          "calls_per_step": count,
                          "share_of_busy": ms / busy if busy else None}))
    # a kernel's library may hold more than one CUDA kernel: spectral_mlp's
    # cast pass and per-layer GEMMs, its backward's casts and the recompute
    # and transposed GEMMs, grid_mlp's tile kernel, gcn_layer's GEMM and
    # stencil passes, gcn's backward dsup pass, dx and split-K dW GEMMs
    # (StoreEpi) and dW reduce (sum_rows: the tail's backward runs its GEMMs
    # only for weight gradients, which the fine-tune step does not ask for),
    # the head's MLP pass and DFT pass (the DIRECT analysis_wgmma, bf16 f),
    # the tail's t pre-pass and tile kernel, the tail backward's pre-pass,
    # tile kernel and transposed DFT (the DIRECT analysis_wgmma, fp32 dhm);
    # on fp32 operands, spectral_mlp's gemm_tf32x3 layers, the fp32 MLP's
    # two gemm_f32 launches that grid_mlp, the head and the tail share
    # ("fp32_mlp"), the tail backward's three gemm_tf32x3 passes (z1, dz1,
    # [dxa | dskip]; gcn_layer_bwd's fp32 GEMMs are the gemm_f32 ones with
    # the plain F32Store epilogue); the folded DFT passes, whose kernels the head, the
    # tail and the tail's backward share, by direction ("dft_fold_*"); the
    # partials' reduces that several kernels share (tile_reduce,
    # stats_reduce: a few us a call) count under none.  The keys are regular
    # expressions; the namespace keeps cuBLAS's names out
    ns = re.escape("(anonymous namespace)::")
    direct = re.escape("analysis_wgmma<__nv_bfloat16, ")  # + the output type, ", 0, true>"
    kernel_keys = {"spectral_mlp": (ns + "stage_input", ns + "HiddenEpi,", ns + "OutEpi,",
                                    ns + "HiddenF32>", ns + "OutF32>"),
                   "grid_mlp": (ns + "mlp_tiles<",),
                   "fp32_mlp": (ns + "MlpHidden>", ns + "MlpOut>"),
                   "dft_fold_analysis": (ns + "fold_rows<true",),
                   "dft_fold_synthesis": (ns + "fold_rows<false",),
                   "grid_encoder_spectral": (ns + "enc_mlp<",
                                             direct + re.escape("__nv_bfloat16, 0, true>")),
                   "spectral_decoder": (ns + "spectral_decoder_tiles<", ns + "scale_to_bf16"),
                   "gcn_layer": (ns + "gcn_stencil", ns + "TEpi,",
                                 ns + "gemm_f32<false, false.*F32Store>"),
                   "gcn_layer_bwd": (ns + "gcn_bwd_", ns + "StoreEpi,", ns + "sum_rows",
                                     ns + "gemm_f32<false, true.*F32Store>",
                                     ns + "gemm_f32<true, false.*F32Store>"),
                   "spectral_decoder_bwd": ("decoder_bwd_", "hm_to_bf16",
                                            direct + re.escape("float, 0, true>"),
                                            ns + "Z1Store>", ns + "DzStore>", ns + "DxStore>"),
                   "spectral_mlp_bwd": (ns + "stage_grad_rows", ns + "RecomputeEpi,",
                                        ns + "ChainEpi,", ns + "InputGradEpi,")}
    for name in (*KERNELS, "fp32_mlp", "dft_fold_analysis", "dft_fold_synthesis"):
        keys = kernel_keys.get(name, (f"{name}_kernel",))
        mine = [r for r in rows if any(re.search(k, r[1]) for k in keys)]
        print(json.dumps({"path": path, "kernel": name,
                          "ms_per_step": sum(r[0] for r in mine),
                          "calls_per_step": sum(r[2] for r in mine)}))
    print(json.dumps({"path": path, "wall_ms_per_step": wall,
                      "device_busy_ms_per_step": busy,
                      "device_idle_share": 1.0 - busy / wall if wall else None}))


def profile_path(net, sst_seq, steps: int, path: str):
    """torch.profiler over `steps` chained serving steps; prints the
    breakdown and returns the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x0 = torch.zeros((1, *net.cfg.img_size, net.cfg.in_chans), device=sst_seq.device)
    with torch.inference_mode():
        state = x0
        for i in range(2):
            state = net(state, sst_seq[i % steps])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(steps):
                state = net(state, sst_seq[i])
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
    breakdown(prof, steps, wall, path)
    return prof


def profile_train(trainer, state, batch, steps: int, path: str):
    """torch.profiler over `steps` train steps on one batch; prints the
    breakdown and returns the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    era5, sst = trainer._device_batch(batch)
    for _ in range(2):
        state, _ = trainer._train_step(state, era5, sst)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = trainer._train_step(state, era5, sst)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    breakdown(prof, steps, wall, path)
    return prof


def train_main(args, card) -> int:
    import torch

    from msfno_torch.config import finetune_config, finetune_train_config, fp32_kernel_config
    from msfno_torch.data.synthetic import gen_batch
    from msfno_torch.training.trainer import Trainer

    fp32 = args.tier == "fp32"
    cfg = fp32_kernel_config(output_dtype="float32") if fp32 else finetune_config()
    runs = {}
    for ms in (0, 1):
        tcfg = finetune_train_config(multi_step_training=ms, **(
            {"bf16_frozen_params": False} if fp32 else {}))
        tr = Trainer(cfg, tcfg)
        runs[ms] = (tr, tr.init_state(), gen_batch(tr.cfg, 1, ms, seed=11))
    for ms, (tr, state, batch) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        prof = profile_train(tr, state, batch, args.steps, f"train ms={ms}")
        print(json.dumps({"path": f"train ms={ms}",
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}))
        if args.trace and ms == 0:
            prof.export_chrome_trace(args.trace)
    times = {ms: [] for ms in runs}
    for ms in (0, 1, 1, 0):
        tr, state, batch = runs[ms]
        era5, sst = tr._device_batch(batch)
        for i in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, _ = tr._train_step(state, era5, sst)
            end.record()
            torch.cuda.synchronize()
            if i:
                times[ms].append(start.elapsed_time(end))
    print(json.dumps({"card": card, "tier": args.tier,
                      "median_train_step_ms": {f"multi_step_training={ms}": statistics.median(t)
                                               for ms, t in times.items()},
                      "train_step_ms": {f"multi_step_training={ms}": t
                                        for ms, t in times.items()}}))
    return 0


def main() -> int:
    import torch

    from chip_smoke import model_inputs
    from msfno_torch.config import fp32_kernel_config, serving_config
    from msfno_torch.models import FourierNeuralOperatorNetFilmed
    from msfno_torch.runtime import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--tier", choices=("serving", "fp32"), default="serving",
                    help="the serving tier (bf16) or the fp32-kernel tier")
    ap.add_argument("--train", action="store_true",
                    help="profile the fine-tune train step instead of the serving step")
    args = ap.parse_args()
    make_cfg = fp32_kernel_config if args.tier == "fp32" else serving_config
    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.train:
        return train_main(args, card)
    nets = {"fused": FourierNeuralOperatorNetFilmed(make_cfg(), device=dev, seed=0)}
    nets["unfused"] = FourierNeuralOperatorNetFilmed(
        make_cfg(fuse_encoder_dft=False, fuse_decoder_tail=False), device=dev)
    nets["unfused"].load_state_dict(nets["fused"].state_dict())
    x0, _, sst_seq = model_inputs(make_cfg(), dev, args.steps)
    for path, net in nets.items():
        prof = profile_path(net, sst_seq, args.steps, path)
        if args.trace and path == "fused":
            prof.export_chrome_trace(args.trace)
    times = {path: [] for path in nets}
    with torch.inference_mode():
        for path in ("fused", "unfused", "unfused", "fused"):
            state = x0
            for i in range(6):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state = nets[path](state, sst_seq[i % args.steps])
                end.record()
                torch.cuda.synchronize()
                if i:
                    times[path].append(start.elapsed_time(end))
    print(json.dumps({"card": card, "tier": args.tier,
                      "median_step_ms": {p: statistics.median(t) for p, t in times.items()},
                      "step_ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
