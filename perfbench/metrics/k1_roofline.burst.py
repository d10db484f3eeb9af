"""K1's share of its roofline (the fused step) in the burst cell:
perfbench/rooflines/k1.py's least time per call over the profiler's time
per call in the traced stretch, whose rounds are the three buckets'."""
from perfbench.metrics import _read


def read(rec):
    return _read.roofline(rec, "k1")
