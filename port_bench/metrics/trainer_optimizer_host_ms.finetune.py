"""trainer_optimizer_host_ms.finetune: host time of the program's
`trainer.optimizer` spans (the gradients' reduction, their norm and the
optimizer's update) over the traced window, per optimizer step; None where
none was recorded."""


def _program():
    """The program's recorder, or None where the program has none."""
    try:
        from msfno_torch.utils import observability
    except ImportError:
        return None
    return observability if hasattr(observability, "span_totals") else None


def read(rec):
    obs = _program()
    total = obs and obs.span_totals().get("trainer.optimizer")
    if not total or not rec.get("steps"):
        return None
    return total["host_s"] / rec["steps"] * 1e3
