"""Host ms per pool round in the program's ``pool.step`` and ``pool.push``
spans (issuing the step's launches and the ring push, and any wait for
the launch queue) over the traced stretch; its rounds are the three
buckets' (128, 512 and 2048 events)."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ms_per_round(rec, ("pool.step", "pool.push"))
