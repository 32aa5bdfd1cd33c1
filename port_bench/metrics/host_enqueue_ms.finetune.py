"""host_enqueue_ms.finetune: host time inside `Trainer.train_steps` up to
its return, with no synchronise, per optimizer step (the benchmark's own
span around the call, summed over the traced window)."""


def read(rec):
    if not rec.get("steps"):
        return None
    return rec["host_enqueue_s"] / rec["steps"] * 1e3
