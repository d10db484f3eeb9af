"""K3's share of its roofline: perfbench/rooflines/k3.py's least time per
call over the profiler's time per call in the traced stretch."""
from perfbench.metrics import _read


def read(rec):
    return _read.roofline(rec, "k3")
