"""A profiled stretch of a run, read from ``torch.profiler``'s trace.

The harness wraps its calls into the pool in named ranges (``feed``,
``pump``, ``poll``, ``wait``); the profiler records them with the host's
operators and every kernel, copy and memset the device ran.  From the
exported trace this module takes:

* ``busy_s``: the union of the device records' intervals (a copy on the
  reader's stream that overlaps a kernel counts once);
* per device record name, its count and summed seconds;
* the idle gaps between device records, each put down to the harness range
  the host was in at the gap's middle and the host operator that overlaps
  the gap most, summed by that label (gaps under 20 us under one label).

Only complete traces count: a run whose trace holds no device record has
nothing to read, and its device metrics are left out.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_US = 20.0       # shorter gaps are summed under one label


def profile(fn):
    """Run ``fn()`` under the profiler; returns ``(fn's result, Trace)``.
    Without CUDA (a rehearsal on the CPU) only the host is traced, and the
    trace holds no device record."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with prof_ctx(activities=acts) as prof:
        out = fn()
        if cuda:
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return out, Trace(events)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


class Trace:
    def __init__(self, events):
        dev, ranges, ops = [], [], []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            s = float(ev["ts"])
            e = s + float(ev.get("dur", 0.0))
            if cat in DEVICE_CATS:
                dev.append((s, e, ev["name"]))
            elif cat == "user_annotation":
                ranges.append((s, e, ev["name"]))
            elif cat == "cpu_op":
                ops.append((s, e, ev["name"]))
        self.device = dev
        self.ranges = sorted(ranges)
        self.ops = sorted(ops)
        self.busy = _union((s, e) for s, e, _ in dev)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def by_name(self) -> dict:
        """``{name: [count, seconds]}`` over the device records."""
        out: dict = {}
        for s, e, name in self.device:
            c = out.setdefault(name, [0, 0.0])
            c[0] += 1
            c[1] += (e - s) * 1e-6
        return out

    def _label(self, s: float, e: float) -> str:
        mid = (s + e) / 2
        i = bisect.bisect_right(self.ranges, (mid, float("inf")))
        rng = [n for a, b, n in self.ranges[max(0, i - 8):i] if b >= mid]
        best, most = None, 0.0
        i = bisect.bisect_left(self.ops, (s - 2e3,))
        for a, b, n in self.ops[i:]:
            if a > e:
                break
            over = min(b, e) - max(a, s)
            if over > most:
                best, most = n, over
        head = rng[-1] if rng else "outside"
        return f"{head}/{best}" if best else head

    def idle_gaps(self, top: int = 10) -> list:
        """The idle time between device records, summed by what the host
        was doing, longest first: ``[[label, seconds], ...]``."""
        sums: dict = {}
        for (_, e0), (s1, _) in zip(self.busy, self.busy[1:]):
            if s1 <= e0:
                continue
            lab = (self._label(e0, s1) if s1 - e0 >= SHORT_GAP_US
                   else f"gaps under {SHORT_GAP_US:g} us")
            sums[lab] = sums.get(lab, 0.0) + (s1 - e0) * 1e-6
        return sorted(([k, v] for k, v in sums.items()),
                      key=lambda kv: -kv[1])[:top]

    def device_ops(self, top: int = 10) -> list:
        """The device records that took most time: ``[[name, seconds]]``."""
        return sorted(([k, v[1]] for k, v in self.by_name().items()),
                      key=lambda kv: -kv[1])[:top]
