"""fetch_wait_ms.rollout: host time of the program's `rollout.fetch_wait` spans
(the consumer waiting for a fetched field) over the traced window, per
member-step; None where none was recorded."""


def _program():
    """The program's recorder, or None where the program has none."""
    try:
        from msfno_torch.utils import observability
    except ImportError:
        return None
    return observability if hasattr(observability, "span_totals") else None


def read(rec):
    obs = _program()
    total = obs and obs.span_totals().get("rollout.fetch_wait")
    if not total or not rec.get("units_traced"):
        return None
    return total["host_s"] / rec["units_traced"] * 1e3
