"""Kernels, copies and memsets the device ran per pool round in the
traced stretch."""
from perfbench.metrics import _read


def read(rec):
    p = _read.profile(rec)
    return None if p is None else p["records"] / p["rounds"]
