"""ms per pool round that the pump waited for a ring drain
(pool_stats pump_drain_wait_s) over the window."""


def read(rec):
    w = rec["window"]
    if not w["rounds"]:
        return None
    return w["stats"]["pump_drain_wait_s"] / w["rounds"] * 1e3
