"""mfu.rollout: the model FLOPs the algorithm needs (port_bench/work/flops.py)
times the units completed in the traced window, over the window, as a share
of the published dense peak of the configuration's operand precision."""


def read(rec):
    if not rec.get("window_s") or not rec["units_traced"]:
        return None
    rate = rec["flops_per_unit"] * rec["units_traced"] / rec["window_s"]
    return rate / rec["peak_ops_per_s"] * 100.0
