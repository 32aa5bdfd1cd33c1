#!/usr/bin/env python3
"""The split-precision TF32 core alone (csrc/row_gemm.cuh:gemm_tf32x3, through
`tf32x3.tf32x3_matmul`) at the fused tail's GEMM shapes on one card: A
(1,038,240 x K) fp32 as a plain matrix, K = 256, 329 (rows not 16-byte
multiples: every A quad read by scalar loads), 332 and 352, N = 256 on
128-column tiles; K = 256, N = 73 on 80, 112 and 128-column tiles.  Prints
one JSON line per shape: the call's ms (CUDA events), the ms of the
torch.zeros of its output that the call includes, the bound at 495 / 3
TFLOP/s, and the card's name and power limit.

    python3 tools/probe_tf32x3_core.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    from chip_smoke import PEAK_OPS_PER_S, cuda_ms
    from msfno_torch.ops.kernels.tf32x3 import tf32x3_matmul
    from msfno_torch.runtime import resolve_device

    dev = resolve_device()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    m = 1038240
    g = torch.Generator(device=dev).manual_seed(0)
    for k, n, bn in ((256, 256, 128), (329, 256, 128), (332, 256, 128), (352, 256, 128),
                     (256, 73, 80), (256, 73, 112), (256, 73, 128)):
        a = torch.randn((m, k), device=dev, generator=g)
        b = torch.randn((k, n), device=dev, generator=g)
        ms = cuda_ms(lambda: tf32x3_matmul(a, b, bn=bn), 5)
        zeros_ms = cuda_ms(lambda: torch.zeros((1, m, n), device=dev), 5)
        print(json.dumps({"k": k, "n": n, "bn": bn, "ms": ms, "zeros_ms": zeros_ms,
                          "bound_ms": 2 * m * k * n / PEAK_OPS_PER_S["fp32_product"] * 1e3,
                          "card": card}), flush=True)
        del a, b
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
