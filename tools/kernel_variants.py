#!/usr/bin/env python3
"""A/B of compile-time variants of one CUDA kernel at the serving step's
shapes, on one card, in one process.

    python3 tools/kernel_variants.py gcn_layer_bwd base DS_ROWS=12 DS_ROWS=6,DS_FB=32,DS_PPT=4 base

Each variant is "base" (the source as it stands) or comma-separated
NAME=VALUE overrides of the kernel source's <NAME>_OVERRIDE macros
(msfno_torch/csrc/<kernel>.cu).  Every variant is built with nvcc into
msfno_torch/_build/variants/, loaded in place of the kernel's library and
timed at the call sites of chip_smoke.py (CUDA events, the kernel against
its plain version).  Prints ptxas' register and spill report per variant
(with any C7520 line: wgmmas serialized) and
one JSON line per (variant, site) with the card's name and power limit: the
kernel's, the plain version's and (where chip_smoke.py has one) the library
call's time and the bound.  The ring depth of grid_mlp, or the DFT kernels'
tiles, for example:

    python3 tools/kernel_variants.py grid_mlp base GM_STAGES=2 base
    python3 tools/kernel_variants.py dft_analysis base DFT_STAGES=3 base
Repeat "base" at the end to see the run-to-run spread.  With --profile,
after each site's check the call that the main path makes runs PROFILE_CALLS
more times under torch.profiler, and one JSON line per (site, CUDA kernel)
gives its launches a call and mean device time: how a wrapper call's time
splits over the launches it makes, site by site.

    python3 tools/kernel_variants.py --profile gcn_layer_bwd base

The tool reaches the sites through chip_smoke.check_site, so a copy of it
run from an unpacked older tree splits that tree's kernels the same way.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

PROFILE_CALLS = 5

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _profiled(check_site, card: str, var: str):
    """chip_smoke.check_site, followed by PROFILE_CALLS calls of the site's
    main-path call (`time_fn`, else `kernel_fn`) under torch.profiler: one
    JSON line per CUDA kernel those calls launched, by its name without
    namespaces and arguments (its template arguments tell an MLP's copy,
    GEMM 1, GEMM 2 and reduces apart: grid_mlp's `pad_rows<GmRows>`,
    `gemm_tf32x3<128, GmInput<false, false>, HiddenGelu>`,
    `gemm_tf32x3<.., GmHidden, OutStore>` or `<.., OutStats>`,
    `tile_reduce`, `stats_reduce`)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def run(name, site, kernel_fn, plain_fn, work, iters, time_fn=None, **kw):
        rec = check_site(name, site, kernel_fn, plain_fn, work, iters, time_fn=time_fn, **kw)
        with torch.inference_mode(), profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_CALLS):
                (time_fn or kernel_fn)()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA or not ev.count:
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            kernel = ev.key.replace("(anonymous namespace)::", "").split("(")[0]
            print(json.dumps({"variant": var, "site": site,
                              "cuda_kernel": kernel.removeprefix("void ")[:160],
                              "launches_per_call": ev.count / PROFILE_CALLS,
                              "mean_us": dev_us / ev.count, "card": card}))
        return rec

    return run


def main(argv) -> int:
    import torch

    import chip_smoke
    from msfno_torch.ops import kernels
    from msfno_torch.runtime import resolve_device

    profile = "--profile" in argv
    argv = [a for a in argv if a != "--profile"]
    name, variants = argv[0], argv[1:] or ["base"]
    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, var in enumerate(variants):
        defs = [] if var == "base" else [
            f"-D{kv.split('=')[0]}_OVERRIDE={kv.split('=')[1]}" for kv in var.split(",")]
        lib = out_dir / f"lib{name}-v{i}.so"
        cmd = kernels._compile_command(name, lib, verbose=True) + defs
        procs.append((var, lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for var, lib, proc in procs:
        log, _ = proc.communicate()
        report = [ln.strip() for ln in log.splitlines()
                  if "registers" in ln or "spill" in ln or "C7520" in ln]
        print(json.dumps({"variant": var, "rc": proc.returncode, "ptxas": report}))
        if proc.returncode != 0:
            print(log[-3000:])
            return 1
    check_site = chip_smoke.check_site
    for var, lib, _ in procs:
        kernels._LIBS[name] = ctypes.CDLL(str(lib))
        if profile:
            chip_smoke.check_site = _profiled(check_site, card, var)
        recs = chip_smoke.SITES[name](dev)
        for rec in recs:
            print(json.dumps({"variant": var, "site": rec["site"], "ms": rec["ms"],
                              "plain_ms": rec["plain_ms"], "library_ms": rec["library_ms"],
                              "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                              "rel_l2": rec["rel_l2"], "card": card}))
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
