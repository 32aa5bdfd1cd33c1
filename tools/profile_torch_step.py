#!/usr/bin/env python3
"""Where the time of one serving step, or of one fine-tune train step, of
the PyTorch port goes, on a CUDA card.

    python3 tools/profile_torch_step.py [--steps N] [--trace FILE]
    python3 tools/profile_torch_step.py --tier fp32 [--steps N] [--trace FILE]
    python3 tools/profile_torch_step.py --train [--tier fp32] [--store] [--steps N] [--trace FILE]

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
Each kernel's gemm_tf32x3 and gemm_f32 launches count as its own (the
fp32 MLP of csrc/mlp_f32.cuh as grid_mlp's, the head's and the tail's,
told apart by their A and h types: GmInput / GmHidden, EncRows, F32Matrix);
the folded DFT passes by direction, "dft_fold_analysis" (the
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

--train --store: the train steps fed from a full-width ERA5 / SST npy store
(chip_smoke.write_store, in a temporary directory removed at the end) through
ERA5Dataset and PrefetchLoader (chip_smoke.store_loader): two warm-up steps,
then one epoch of steps profiled as `Trainer.train` runs them (the batch to
the device, the step, the previous step's loss read back), so the wall time
and the device's idle share include the loader; the timing in turns then
runs in memory on the loader's first batch.

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
    # on fp32 operands, spectral_mlp's gemm_tf32x3 layers, grid_mlp's copies
    # into 16-byte rows (pad_rows<GmRows>) and two gemm_tf32x3 launches (A
    # GmInput, GmHidden), gcn_layer's W split and gemm_tf32x3 (TScale), the
    # head's copy of x into 16-byte rows (pad_rows<EncRows>) and two
    # gemm_tf32x3 launches (EncRows or MlpInput, F32Matrix with OutStats; its
    # fold counts under dft_fold_analysis), the tail's skip copy and two
    # gemm_tf32x3 launches (F32Matrix with HiddenGelu, with OutStore; its
    # fold counts under dft_fold_synthesis), the tail backward's three
    # gemm_tf32x3 passes (z1, dz1, [dxa | dskip]),
    # gcn_layer_bwd's W split, dx (gemm_tf32x3 with the plain TcStore) and
    # dW (dw_mma); the folded DFT passes, whose kernels the head, the
    # tail and the tail's backward share, by direction ("dft_fold_*"); the
    # partials' reduces that several kernels share (tile_reduce,
    # stats_reduce: a few us a call) count under none.  The keys are regular
    # expressions; the namespace keeps cuBLAS's names out
    ns = re.escape("(anonymous namespace)::")
    direct = re.escape("analysis_wgmma<__nv_bfloat16, ")  # + the output type, ", 0, true>"
    kernel_keys = {"spectral_mlp": (ns + "stage_input", ns + "HiddenEpi,", ns + "OutEpi,",
                                    ns + "HiddenF32>", ns + "OutF32>"),
                   "grid_mlp": (ns + "mlp_tiles<", ns + "pad_rows<" + ns + "GmRows>",
                                ns + "GmInput<", ns + "GmHidden,"),
                   "dft_fold_analysis": (ns + "fold_rows<true",),
                   "dft_fold_synthesis": (ns + "fold_rows<false",),
                   "grid_encoder_spectral": (ns + "enc_mlp<",
                                             direct + re.escape("__nv_bfloat16, 0, true>"),
                                             ns + "pad_rows<" + ns + "EncRows>",
                                             ns + "EncRows,",
                                             ns + "MlpInput, " + ns + "HiddenGelu>",
                                             ns + "F32Matrix<float>, " + ns + "OutStats>"),
                   "spectral_decoder": (ns + "spectral_decoder_tiles<", ns + "scale_to_bf16",
                                        ns + "skip_into_rows",
                                        ns + "F32Matrix<float>, " + ns + "HiddenGelu>",
                                        ns + "F32Matrix<float>, " + ns + "OutStore>"),
                   "gcn_layer": (ns + "gcn_stencil", ns + "TEpi,", ns + "TScale>",
                                 ns + "tf32_split_transposed",
                                 ns + "gemm_f32<false, .*F32Store>"),
                   "gcn_layer_bwd": (ns + "gcn_bwd_", ns + "StoreEpi,", ns + "sum_rows",
                                     ns + "tf32_split_rows", ns + "dw_mma<",
                                     ns + "gemm_tf32x3<128, .*TcStore>"),
                   "spectral_decoder_bwd": ("decoder_bwd_", "hm_to_bf16",
                                            direct + re.escape("float, 0, true>"),
                                            ns + "Z1Store>", ns + "DzStore>", ns + "DxStore>"),
                   "spectral_mlp_bwd": (ns + "stage_grad_rows", ns + "RecomputeEpi,",
                                        ns + "ChainEpi,", ns + "InputGradEpi,")}
    for name in (*KERNELS, "dft_fold_analysis", "dft_fold_synthesis"):
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


def profile_train_store(trainer, state, loader, path: str):
    """torch.profiler over one epoch of train steps fed by `loader`, each as
    `Trainer.train` runs it; prints the breakdown and returns the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import loader_steps

    for _, batch in zip(range(2), loader.epoch(1)):
        state, _ = trainer._train_step(state, *trainer._device_batch(batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, steps = loader_steps(trainer, state, loader)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    breakdown(prof, steps, wall, path)
    return prof


def train_main(args, card, store=None) -> int:
    import torch

    from chip_smoke import store_loader, store_normalizers
    from msfno_torch.config import finetune_config, finetune_train_config, fp32_kernel_config
    from msfno_torch.data.synthetic import gen_batch
    from msfno_torch.training.trainer import Trainer

    fp32 = args.tier == "fp32"
    cfg = fp32_kernel_config(output_dtype="float32") if fp32 else finetune_config()
    runs = {}
    for ms in (0, 1):
        tcfg = finetune_train_config(multi_step_training=ms, **(
            {"bf16_frozen_params": False} if fp32 else {}))
        if store is None:
            tr = Trainer(cfg, tcfg)
            runs[ms] = (tr, tr.init_state(), gen_batch(tr.cfg, 1, ms, seed=11), None)
            continue
        norm, sst_norm = store_normalizers(store)
        tr = Trainer(cfg, tcfg, normalizer=norm, sst_normalizer=sst_norm)
        loader = store_loader(store, cfg, ms, seed=tcfg.seed)
        runs[ms] = (tr, tr.init_state(), next(iter(loader.epoch(0))), loader)
    for ms, (tr, state, batch, loader) in runs.items():
        torch.cuda.reset_peak_memory_stats()
        path = f"train ms={ms}" + (" from the store" if loader is not None else "")
        if loader is None:
            prof = profile_train(tr, state, batch, args.steps, path)
        else:
            prof = profile_train_store(tr, state, loader, path)
        print(json.dumps({"path": path,
                          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}))
        if args.trace and ms == 0:
            prof.export_chrome_trace(args.trace)
    times = {ms: [] for ms in runs}
    for ms in (0, 1, 1, 0):
        tr, state, batch, _ = runs[ms]
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
    ap.add_argument("--store", action="store_true",
                    help="with --train: feed the steps from a full-width npy store")
    args = ap.parse_args()
    make_cfg = fp32_kernel_config if args.tier == "fp32" else serving_config
    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    if args.store and not args.train:
        ap.error("--store profiles train steps: give --train")
    if args.train and args.store:
        import shutil
        import tempfile

        from chip_smoke import write_store

        root = tempfile.mkdtemp(prefix="msfno_store_")
        try:
            write_store(root, make_cfg())
            return train_main(args, card, store=root)
        finally:
            shutil.rmtree(root)
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
