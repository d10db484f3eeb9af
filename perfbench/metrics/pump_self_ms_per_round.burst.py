"""Host ms per pool round in the program's ``pool.pump`` span less its
child spans (the lock, the control loop, the loop over the three buckets'
executors between collect, stage and dispatch) over the traced stretch."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ms_per_round(rec, ("pool.pump",), "self_seconds")
