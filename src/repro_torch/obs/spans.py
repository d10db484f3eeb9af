"""Spans: named host ranges inside the port, on while the profiler runs.

    with obs.span("pool.stage"):
        ...
    with obs.span("step.draw", device=surface.device):
        ...

Tracing is on exactly while a ``torch.profiler`` session is on: the flag
``torch.autograd.profiler._is_profiler_enabled``, which every session sets
and every thread sees.  There is no other switch.

With tracing off at entry a span costs that one flag read: ``span``
returns a shared null context, which enters no ``record_function``, reads
no clock and records nothing.

With tracing on at entry a span

* opens ``torch.profiler.record_function(name)``, so the range lies on the
  profiler's clock beside the device records (only on a thread whose C++
  profiler state is on: a thread started before the session records no
  range, but its totals still count);
* reads ``obs.timer()`` at entry and exit and adds to the per-name totals:
  count, seconds, and self seconds (the duration less what its child spans
  on the same thread cover);
* with ``device=`` a CUDA device, records a pair of CUDA events on that
  device's current stream around the body.  The pair is resolved into
  ``device_seconds`` by ``snapshot()``, never in the span.

``timed=True`` is for a caller that needs the duration whatever the
profiler does (a ``pool_stats()`` timer): the span then reads the clock
with tracing off too, and leaves ``seconds`` on the object it yields.

Counters share the switch: ``count(name, n)`` adds ``n`` to the total of
``name`` while tracing is on, and costs the one flag read otherwise.
``tracing()`` is that flag, for a caller whose ``n`` costs work to
compute.

``snapshot()`` returns ``{name: {count, seconds, self_seconds,
device_seconds}}`` per span (``device_seconds`` is ``None`` for a name that
never recorded an event pair) and ``{name: {count, total}}`` per counter
(``count`` the calls, ``total`` the sum of their ``n``); ``reset()`` clears
both.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

from repro_torch.obs.metrics import timer

__all__ = ["span", "count", "tracing", "snapshot", "reset"]


class _Null:
    """The span with tracing off: does nothing."""
    __slots__ = ()
    seconds = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NULL = _Null()
_lock = threading.Lock()
_totals: dict = {}    # name -> [count, seconds, self_seconds, device_s]
_pending: list = []   # (name, start event, end event), unresolved
_counts: dict = {}    # counter name -> [calls, total]
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "device", "traced", "t0", "seconds", "child",
                 "_rf", "_start")

    def __init__(self, name: str, device, traced: bool):
        self.name, self.traced = name, traced
        self.device = (device if traced and device is not None
                       and torch.device(device).type == "cuda" else None)
        self.seconds = None
        self.child = 0.0
        self._rf = self._start = None

    def __enter__(self):
        self.t0 = timer()
        if self.traced:
            _stack().append(self)
            if torch._C._autograd._profiler_enabled():
                self._rf = torch.profiler.record_function(self.name)
                self._rf.__enter__()
            if self.device is not None:
                self._start = _record(self.device)
        return self

    def __exit__(self, *exc) -> bool:
        if self.traced:
            end = _record(self.device) if self._start is not None else None
            if self._rf is not None:
                self._rf.__exit__(*exc)
        self.seconds = timer() - self.t0
        if self.traced:
            _close(self, end)
        return False


def _record(device) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _close(sp: _Span, end: Optional[torch.cuda.Event]) -> None:
    stack = _stack()
    if stack and stack[-1] is sp:
        stack.pop()
    if stack:
        stack[-1].child += sp.seconds
    with _lock:
        row = _totals.get(sp.name)
        if row is None:
            row = _totals[sp.name] = [0, 0.0, 0.0, None]
        row[0] += 1
        row[1] += sp.seconds
        row[2] += sp.seconds - sp.child
        if end is not None:
            if row[3] is None:
                row[3] = 0.0
            _pending.append((sp.name, sp._start, end))


def span(name: str, *, device=None, timed: bool = False):
    """A context manager over the code it wraps (see the module doc)."""
    if _autograd_profiler._is_profiler_enabled:
        return _Span(name, device, True)
    return _Span(name, None, False) if timed else _NULL


def tracing() -> bool:
    """Whether tracing is on (see the module doc)."""
    return _autograd_profiler._is_profiler_enabled


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` while tracing is on (see the module
    doc); otherwise nothing."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            row = _counts.get(name)
            if row is None:
                row = _counts[name] = [0, 0]
            row[0] += 1
            row[1] += n


def _resolve() -> None:
    """Fold every pending event pair into ``device_seconds``,
    synchronising on each end event."""
    with _lock:
        todo = list(_pending)
        _pending.clear()
    done = []
    for name, start, end in todo:
        end.synchronize()
        done.append((name, start.elapsed_time(end) * 1e-3))
    with _lock:
        for name, s in done:
            row = _totals.get(name)
            if row is not None:     # else reset() ran meanwhile
                row[3] += s


def snapshot() -> dict:
    """Every span's and counter's totals since the last ``reset()`` (see
    the module doc); resolves every pending event pair first."""
    _resolve()
    with _lock:
        out = {name: {"count": c, "seconds": s, "self_seconds": own,
                      "device_seconds": dev}
               for name, (c, s, own, dev) in _totals.items()}
        out.update({name: {"count": c, "total": t}
                    for name, (c, t) in _counts.items()})
        return out


def reset() -> None:
    """Clear the totals and counters and drop the pending event pairs."""
    with _lock:
        _totals.clear()
        _counts.clear()
        _pending.clear()
