"""device_idle.finetune: the share of the traced window in which no operation
ran on the device (1 - the union of device intervals over the window)."""


def read(rec):
    if not rec.get("window_s"):
        return None
    return (1.0 - rec["busy_s"] / rec["window_s"]) * 100.0
