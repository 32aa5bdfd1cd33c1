"""pageable_uploads.rollout: host arrays the program made into device tensors
from pageable memory (its `uploads.pageable` counter, counted while tracing
was on: the traced window) per batch step delivered; each such upload
synchronises the stream.  None where the program recorded no span."""


def _program():
    """The program's recorder, or None where the program has none."""
    try:
        from msfno_torch.utils import observability
    except ImportError:
        return None
    return observability if hasattr(observability, "span_totals") else None


def read(rec):
    obs = _program()
    if obs is None or not obs.span_totals() or not rec.get("steps"):
        return None
    return obs.counters(traced=True).get("uploads.pageable", 0) / rec["steps"]
