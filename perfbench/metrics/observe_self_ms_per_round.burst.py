"""Host ms per pool round in the program's ``pool.observe`` span less its
child spans (the rate read and the adaptive scheduler's decision, without
the moves it stages) over the traced stretch."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ms_per_round(rec, ("pool.observe",), "self_seconds")
