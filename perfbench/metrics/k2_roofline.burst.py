"""K2's share of its roofline (the Harris LUT refresh) in the burst cell:
perfbench/rooflines/k2.py's least time per call over the profiler's time
per call in the traced stretch, whose rounds are the three buckets'."""
from perfbench.metrics import _read


def read(rec):
    return _read.roofline(rec, "k2")
