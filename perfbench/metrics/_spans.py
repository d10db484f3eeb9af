"""Shared arithmetic of the readers of the program's own spans
(``repro_torch.obs.spans``).  Spans record only while the profiler runs,
so in a run of the harness their totals cover the traced stretch, and a
reader divides them by that stretch's pool rounds.  A program without
spans (``repro_torch.obs`` has no ``spans``) gives ``None``, as does a
record without a profiled stretch or a span that never ran."""
from __future__ import annotations

from perfbench.metrics import _read


def ms_per_round(rec, names, field="seconds"):
    """``field`` of the spans ``names``, summed, in ms per traced round;
    ``None`` where the record or the program has nothing to read."""
    p = _read.profile(rec)
    if p is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = getattr(obs, "spans", None)
    if spans is None:
        return None
    snap = spans.snapshot()
    total = 0.0
    for name in names:
        row = snap.get(name)
        if not row or not row["count"] or row[field] is None:
            return None
        total += row[field]
    return total / p["rounds"] * 1e3
