"""Shared arithmetic of the per-layer readers.  Each reader's ``read(rec)``
takes the traced run's record (``lib.bench.record``) and returns a number,
or ``None`` where the record holds nothing to read."""
from __future__ import annotations


def pump_ms_per_round(rec):
    w = rec["window"]
    if not w["rounds"]:
        return None
    sp = w["spans"]
    return (sp.get("pump", 0.0) + sp.get("poll", 0.0)) / w["rounds"] * 1e3


def profile(rec):
    p = rec["profile"]
    return p if p and p["rounds"] and p["busy_s"] > 0 else None


def roofline(rec, kernel):
    """100 x the least time per call over the measured time per call; the
    calls are counted on each side, so records the profiler dropped do not
    bias the share."""
    r = rec["rooflines"].get(kernel)
    if not r or not r["calls"] or not r["kernel_calls"] or r["kernel_s"] <= 0:
        return None
    return 100.0 * (r["bound_s"] / r["calls"]) / (
        r["kernel_s"] / r["kernel_calls"])
