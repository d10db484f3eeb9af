"""100 x the lanes active in a detector step over the lanes it stepped,
summed over the traced stretch: the program's counters
``step.lanes_active`` and ``step.lanes_stepped`` (``repro_torch.obs
.spans.count``, on only under the profiler).  Every bucket's executor
steps the whole lane-stacked state, so this is the share of a round's
width that does work.  ``None`` without a profiled stretch, or against a
program without these counters."""
from perfbench.metrics import _read


def read(rec):
    if _read.profile(rec) is None:
        return None
    try:
        from repro_torch import obs
    except ImportError:
        return None
    spans = getattr(obs, "spans", None)
    if spans is None:
        return None
    snap = spans.snapshot()
    stepped = snap.get("step.lanes_stepped") or {}
    active = snap.get("step.lanes_active") or {}
    if not stepped.get("total") or active.get("total") is None:
        return None
    return 100.0 * active["total"] / stepped["total"]
