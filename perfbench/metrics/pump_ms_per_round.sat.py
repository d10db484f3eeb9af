"""Host ms per pool round in the harness spans around pump() and poll()
over the window: the pool front end and the readout wait it pays."""
from perfbench.metrics import _read


def read(rec):
    return _read.pump_ms_per_round(rec)
