"""kernels_roofline.finetune: the hand-written kernels' share of their
roofline: the sum over kernels of launches (the program's launch counters
over the traced window) times one launch's least time (port_bench/work/
kernels.py, at the published peaks), over the profiler's device time of
the kernels of the program's CUDA sources.  None where none ran."""


def read(rec):
    if not rec.get("handwritten_s") or not rec["launches"]:
        return None
    least = sum(n * rec["launch_least_s"].get(k, 0.0) for k, n in rec["launches"].items())
    if least == 0.0:
        return None
    return least / rec["handwritten_s"] * 100.0
