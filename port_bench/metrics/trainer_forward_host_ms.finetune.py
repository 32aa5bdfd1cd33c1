"""trainer_forward_host_ms.finetune: host time of the program's `trainer.forward`
spans (the rollout loss's forward in `Trainer.loss_and_grads`) over the
traced window, per optimizer step; None where none was recorded."""


def _program():
    """The program's recorder, or None where the program has none."""
    try:
        from msfno_torch.utils import observability
    except ImportError:
        return None
    return observability if hasattr(observability, "span_totals") else None


def read(rec):
    obs = _program()
    total = obs and obs.span_totals().get("trainer.forward")
    if not total or not rec.get("steps"):
        return None
    return total["host_s"] / rec["steps"] * 1e3
