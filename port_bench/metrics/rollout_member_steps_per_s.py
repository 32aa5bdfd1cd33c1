"""rollout_member_steps_per_s: 6-hour member-steps whose field reached the
consumer inside the window (host clock), over the window's seconds."""


def read(rec):
    return rec["units_done"] / rec["seconds"]
