"""Device ms per pool round between the CUDA events of the program's
``step.draw`` span (the key split and the write-error draw of every lane
in the state, active or not) over the traced stretch."""
from perfbench.metrics import _spans


def read(rec):
    return _spans.ms_per_round(rec, ("step.draw",), "device_seconds")
