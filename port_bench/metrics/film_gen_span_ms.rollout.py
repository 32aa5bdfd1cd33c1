"""film_gen_span_ms.rollout: device time of the program's `film.generator` spans
(events on the compute stream inside `FilmWrapper.forward`) over the traced
window, per member-step; None where none was recorded."""


def _program():
    """The program's recorder, or None where the program has none."""
    try:
        from msfno_torch.utils import observability
    except ImportError:
        return None
    return observability if hasattr(observability, "span_totals") else None


def read(rec):
    obs = _program()
    total = obs and obs.span_totals().get("film.generator")
    if not total or total["device_s"] is None or not rec.get("units_traced"):
        return None
    return total["device_s"] / rec["units_traced"] * 1e3
