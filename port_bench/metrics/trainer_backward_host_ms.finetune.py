"""trainer_backward_host_ms.finetune: host time of the program's
`trainer.backward` spans (`torch.autograd.grad` and the zero fill of unused
leaves) over the traced window, per optimizer step; None where none was
recorded."""


def _program():
    """The program's recorder, or None where the program has none."""
    try:
        from msfno_torch.utils import observability
    except ImportError:
        return None
    return observability if hasattr(observability, "span_totals") else None


def read(rec):
    obs = _program()
    total = obs and obs.span_totals().get("trainer.backward")
    if not total or not rec.get("steps"):
        return None
    return total["host_s"] / rec["steps"] * 1e3
