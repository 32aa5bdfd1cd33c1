"""net_encoder_decoder_ms.rollout: device time of the program's `net.encoder`
and `net.decoder` spans (the head with its positional embedding, the tail)
over the traced window, per member-step; None where neither was recorded."""


def _program():
    """The program's recorder, or None where the program has none."""
    try:
        from msfno_torch.utils import observability
    except ImportError:
        return None
    return observability if hasattr(observability, "span_totals") else None


SPANS = ("net.encoder", "net.decoder")


def read(rec):
    obs = _program()
    totals = obs.span_totals() if obs else {}
    times = [totals[n]["device_s"] for n in SPANS if n in totals]
    if not times or None in times or not rec.get("units_traced"):
        return None
    return sum(times) / rec["units_traced"] * 1e3
