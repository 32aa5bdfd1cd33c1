"""rollout_io_ms.rollout: device time of the program's `rollout.inputs` (x0 and
SST uploaded and normalized) and `rollout.outputs` (fp32 cast,
denormalization, collection, the fetch queued) spans over the traced
window, per member-step; None where neither was recorded."""


def _program():
    """The program's recorder, or None where the program has none."""
    try:
        from msfno_torch.utils import observability
    except ImportError:
        return None
    return observability if hasattr(observability, "span_totals") else None


SPANS = ("rollout.inputs", "rollout.outputs")


def read(rec):
    obs = _program()
    totals = obs.span_totals() if obs else {}
    times = [totals[n]["device_s"] for n in SPANS if n in totals]
    if not times or None in times or not rec.get("units_traced"):
        return None
    return sum(times) / rec["units_traced"] * 1e3
