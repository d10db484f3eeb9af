"""Share of the traced stretch the device was idle: 1 - device busy over
the stretch's wall (its length is set by the schedule, not the host)."""
from perfbench.metrics import _read


def read(rec):
    p = _read.profile(rec)
    if p is None or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["wall_s"])
