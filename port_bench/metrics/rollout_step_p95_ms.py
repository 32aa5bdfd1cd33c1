"""rollout_step_p95_ms: the 95th percentile of the intervals between
consecutive fields delivered to the consumer in the window, on the device's
clock (an event on the compute stream at each delivery), over all of the
window's steps; None with fewer than 20 intervals."""

import statistics


def read(rec):
    ms = rec.get("step_intervals_ms") or []
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=20)[18]
