#!/usr/bin/env python3
"""What a split-precision GEMM spends on each part of csrc/mlp_f32.cuh's
MlpInput A operand (the per-sample affine, the 73-wide skip) on one card:
the fp32 tail backward's z1 pass (csrc/spectral_decoder_bwd.cu, z1 = [a
x_raw + b | skip] @ W1 + b1 on row_gemm.cuh:gemm_tf32x3) at the serving
shapes of chip_smoke.py's site, film-only call, with its MlpInput switched
to drop the affine, the skip (K = 256: eight stages), or both.  A
diagnostic, not a check: the variants compute another function, so only
their times mean anything.  Builds patched copies of the sources under
msfno_torch/_build/diag/ and prints one JSON line per (round, variant)
with the z1 pass's mean device ms (torch.profiler) and the card's name and
power limit.

    python3 tools/diag_mlp_input.py
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VARIANTS = {"base": [], "no_affine": ["-DDIAG_AFF=0"], "no_skip": ["-DDIAG_SKIP=0"],
            "neither": ["-DDIAG_AFF=0", "-DDIAG_SKIP=0"]}
Z1_INPUT = "const MlpInput xin{xg, ptrs[Q_SKIP], aff_a, aff_b, c, s, 0, skip_bf16};"
PATCHED = ("#ifndef DIAG_AFF\n#define DIAG_AFF 1\n#endif\n#ifndef DIAG_SKIP\n#define DIAG_SKIP 1\n"
           "#endif\n  const MlpInput xin{xg, DIAG_SKIP ? ptrs[Q_SKIP] : nullptr, DIAG_AFF ? "
           "aff_a : nullptr, DIAG_AFF ? aff_b : nullptr, c, DIAG_SKIP ? s : 0, 0, skip_bf16};")
Z1_K = "k1_pad, n_px, hidden, c + s, 1, rps,"


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from msfno_torch.ops import kernels
    from msfno_torch.ops.kernels import spectral_decoder as dk
    from msfno_torch.ops.kernels import spectral_decoder_bwd as db_
    from msfno_torch.runtime import resolve_device

    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    diag = kernels.BUILD_DIR / "diag"
    shutil.rmtree(diag, ignore_errors=True)
    shutil.copytree(kernels.CSRC_DIR, diag / "csrc")
    src = diag / "csrc" / "spectral_decoder_bwd.cu"
    text = src.read_text()
    if Z1_INPUT not in text or Z1_K not in text:
        raise RuntimeError("spectral_decoder_bwd.cu no longer builds z1's MlpInput as expected")
    text = text.replace(Z1_INPUT, PATCHED)
    src.write_text(text.replace(Z1_K, "k1_pad, n_px, hidden, c + xin.c_skip, 1, rps,"))
    kernels.CSRC_DIR = diag / "csrc"
    procs = {}
    for name, defs in VARIANTS.items():
        out = diag / f"libspectral_decoder_bwd-{name}.so"
        cmd = kernels._compile_command("spectral_decoder_bwd", out, verbose=False) + defs
        procs[name] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT, text=True))
    for name, (_, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(log[-3000:])
            return 1
    rn, _ = chip_smoke._randn(dev, 8)
    h, w, c = 721, 1440, 256
    mt = chip_smoke._serving_transforms()[1]._const("merged_t", dev)
    hm, skip = rn(1, h, mt.shape[1], c, scale=0.05), rn(1, h, w, 73)
    a, b = 1.0 + rn(1, c, scale=0.1), rn(1, c, scale=0.1)
    w1, b1, w2 = rn(c + 73, c, scale=0.05), rn(c, scale=0.1), rn(c, 73, scale=0.06)
    gy = rn(1, h, w, 73, scale=1e-6)
    prepared = dk.prepare(w1, w2, mt, c, "float32")

    def call():
        return db_.spectral_decoder_bwd(gy, hm, skip, mt, a, b, w1, b1, w2,
                                        mxu_dtype="float32", need_weights=False,
                                        prepared=prepared)

    for rnd in range(2):
        for name, (out, _) in procs.items():
            kernels._LIBS["spectral_decoder_bwd"] = ctypes.CDLL(str(out))
            with torch.inference_mode():
                call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
            for ev in prof.key_averages():
                if ev.device_type == torch.autograd.DeviceType.CUDA and "MlpInput" in ev.key:
                    us = getattr(ev, "self_device_time_total", None) or ev.self_cuda_time_total
                    print(json.dumps({"round": rnd, "variant": name, "z1_ms": us / ev.count / 1e3,
                                      "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
