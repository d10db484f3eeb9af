"""Host ms per pool round in the program's ``pool.stage`` span (gather a
block's rounds, upload them through the pinned stager) over the traced
stretch."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ms_per_round(rec, ("pool.stage",))
