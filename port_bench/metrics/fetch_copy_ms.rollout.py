"""fetch_copy_ms.rollout: device time of the copies between host and
device (initial states and SST uploaded, fields fetched) per member-step,
from the profiler's trace of the window."""


def read(rec):
    if "copy_s" not in rec or not rec["units_traced"]:
        return None
    return rec["copy_s"] / rec["units_traced"] * 1e3
