"""train_samples_per_s: training samples whose optimizer step finished on
the card inside the window (an event recorded after each step), over the
window's seconds."""


def read(rec):
    return rec["units_done"] / rec["seconds"]
