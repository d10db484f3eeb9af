"""Host ms per pool round in the program's ``pool.step`` and ``pool.push``
spans (issuing the step's launches and the ring push, and any wait for
the launch queue) over the traced stretch."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ms_per_round(rec, ("pool.step", "pool.push"))
