"""Share of the window the device was idle: 1 - device busy per round in
the traced stretch over the unprofiled window's wall per round (the profiler
slows the host, not the device)."""
from perfbench.metrics import _read


def read(rec):
    p, w = _read.profile(rec), rec["window"]
    if p is None or not w["rounds"]:
        return None
    return 100.0 * (1.0 - (p["busy_s"] / p["rounds"])
                    / (w["wall_s"] / w["rounds"]))
