"""Host ms per pool round in the program's ``pool.migrate`` spans (each
move's drain and staging where a poll stages it, its drain and bucket
switch where the next pump or flush applies it) over the traced stretch."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ms_per_round(rec, ("pool.migrate",))
