"""Metrics registry: typed counters/gauges/histograms with labels.

One ``MetricsRegistry`` owns every metric of a subsystem (the process-wide
default lives in ``default_registry()``; each ``DetectorPool`` scopes its
own instance so two pools never collide on a counter).  A metric is
declared once — name, one-line description, label names — and mutated only
through the handles the registry hands out:

    reg = MetricsRegistry(namespace="pool")
    fetches = reg.counter("host_fetches", "blocking result transfers")
    slots = reg.counter("h2d_event_slots", "uploaded chunk slots",
                        labels=("bucket",))
    fetches.inc()
    slots.labels(bucket=256).inc(2048)

Handles are cheap bound objects (one attribute add under a per-metric
lock), so hot paths hold them directly instead of re-resolving labels.
The registry is the SINGLE write path for serving witnesses: the
byte-compatible ``stats()``/``pool_stats()`` exports read handle values,
they never own counters of their own (a CI grep bans the legacy bare-dict
spellings outside this package).

Descriptions are load-bearing, not decoration: ``describe()`` feeds the
Prometheus ``# HELP`` lines and the generated stats-key reference table in
``repro.serve.__doc__`` — one source of truth (``repro_torch.obs.schema``).

``timer()`` is the one wall-clock everything observes through
(``time.perf_counter`` — monotonic, so a sink swap or an NTP step can
never change what a drain-wait witness measures).
"""
from __future__ import annotations

import bisect
import threading
import time
from typing import Optional

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "timer",
]

# Default histogram bucket bounds (seconds-flavored; callers override).
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)


def timer() -> float:
    """The wall clock every serving witness reads: ``time.perf_counter``.

    Monotonic and high-resolution.  Intervals are differences of two
    ``timer()`` reads — never ``time.time()`` (steps under NTP) and never
    a mix of clocks (the pre-registry timing hazard this helper retires).
    """
    return time.perf_counter()


def _label_key(labelnames: tuple, labels: dict) -> tuple:
    if set(labels) != set(labelnames):
        raise ValueError(
            f"expected labels {labelnames}, got {tuple(sorted(labels))}"
        )
    return tuple(str(labels[n]) for n in labelnames)


class _Handle:
    """A metric bound to one label combination: the object hot paths hold.

    Mutations take the parent metric's lock (shared across this metric's
    handles) — cheap, and safe from the pump, reader, and monitor threads
    at once.  ``value()`` reads without the lock: Python attribute reads
    of ints/floats are atomic, and every exported witness is either read
    under the pool lock or tolerant of a one-update-stale view.
    """

    __slots__ = ("_metric", "_key", "_v")

    def __init__(self, metric: "_Metric", key: tuple):
        self._metric = metric
        self._key = key
        self._v = 0

    def value(self):
        return self._v

    @property
    def labels(self) -> dict:
        return dict(zip(self._metric.labelnames, self._key))


class _CounterHandle(_Handle):
    def inc(self, n=1) -> None:
        if n < 0:
            raise ValueError(f"counter {self._metric.name} cannot decrease")
        with self._metric._lock:
            self._v += n


class _GaugeHandle(_Handle):
    def set(self, v) -> None:
        with self._metric._lock:
            self._v = v

    def add(self, n) -> None:
        with self._metric._lock:
            self._v += n


class _HistogramHandle(_Handle):
    __slots__ = ("count", "sum", "bucket_counts", "_samples")

    def __init__(self, metric: "_Metric", key: tuple):
        super().__init__(metric, key)
        self.count = 0
        self.sum = 0.0
        self.bucket_counts = [0] * (len(metric.buckets) + 1)
        # bounded raw-sample reservoir (keep-first): enough for the SLO
        # percentiles the scenario suite reads; the cumulative bucket
        # counts stay exact regardless
        self._samples: list = []

    def observe(self, v) -> None:
        m = self._metric
        with m._lock:
            self.count += 1
            self.sum += v
            self.bucket_counts[bisect.bisect_left(m.buckets, v)] += 1
            if len(self._samples) < m.max_samples:
                self._samples.append(float(v))

    def value(self):
        """Histograms export their count as the scalar value."""
        return self.count

    def percentile(self, q: float) -> float:
        """Percentile over the raw-sample reservoir (0 when empty)."""
        with self._metric._lock:
            s = sorted(self._samples)
        if not s:
            return 0.0
        i = (len(s) - 1) * min(max(q, 0.0), 100.0) / 100.0
        lo, hi = int(i), min(int(i) + 1, len(s) - 1)
        return s[lo] + (s[hi] - s[lo]) * (i - lo)


class _Metric:
    """Shared metric core: name, kind, description, label names, and the
    handle table.  Label-less metrics ARE their own (single) handle —
    ``counter.inc()`` works without a ``labels()`` hop."""

    kind = "untyped"
    _handle_cls = _Handle

    def __init__(self, name: str, desc: str, labelnames: tuple = (),
                 **kw):
        self.name = name
        self.desc = desc
        self.labelnames = tuple(str(n) for n in labelnames)
        self._lock = threading.Lock()
        self._handles: dict[tuple, _Handle] = {}
        self._default: Optional[_Handle] = None
        if not self.labelnames:
            self._default = self._handle_cls(self, ())
            self._handles[()] = self._default

    def labels(self, **labels) -> _Handle:
        """The handle for one label combination (created on first use)."""
        key = _label_key(self.labelnames, labels)
        with self._lock:
            h = self._handles.get(key)
            if h is None:
                h = self._handle_cls(self, key)
                self._handles[key] = h
            return h

    def samples(self) -> list:
        """``(label_values_tuple, handle)`` pairs, insertion order."""
        with self._lock:
            return list(self._handles.items())

    # label-less convenience: the metric IS its default handle
    def _need_default(self) -> _Handle:
        if self._default is None:
            raise ValueError(
                f"metric {self.name} has labels {self.labelnames}; "
                f"use .labels(...)"
            )
        return self._default

    def value(self):
        return self._need_default().value()


class Counter(_Metric):
    """Monotonically non-decreasing count (int or float increments)."""

    kind = "counter"
    _handle_cls = _CounterHandle

    def inc(self, n=1) -> None:
        self._need_default().inc(n)


class Gauge(_Metric):
    """A value that can go up and down (``set``/``add``)."""

    kind = "gauge"
    _handle_cls = _GaugeHandle

    def set(self, v) -> None:
        self._need_default().set(v)

    def add(self, n) -> None:
        self._need_default().add(n)


class Histogram(_Metric):
    """Distribution: exact cumulative bucket counts + count/sum, plus a
    bounded raw-sample reservoir for host-side percentiles."""

    kind = "histogram"
    _handle_cls = _HistogramHandle

    def __init__(self, name, desc, labelnames=(), *,
                 buckets=DEFAULT_BUCKETS, max_samples=8192):
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.max_samples = int(max_samples)
        super().__init__(name, desc, labelnames)

    def observe(self, v) -> None:
        self._need_default().observe(v)

    def percentile(self, q: float) -> float:
        return self._need_default().percentile(q)


class MetricsRegistry:
    """Declare-once metric namespace with attachable sinks.

    ``counter``/``gauge``/``histogram`` are get-or-create: re-declaring an
    existing name returns the same metric (so two modules can share one
    witness) but a kind mismatch raises — a counter cannot quietly become
    a gauge.  ``emit(kind=...)`` snapshots every metric and fans the
    record out to the attached sinks (see ``repro_torch.obs.sinks``).
    """

    def __init__(self, namespace: str = ""):
        self.namespace = str(namespace)
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}
        self._sinks: list = []

    # -- declaration --------------------------------------------------------

    def _declare(self, cls, name, desc, labels, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {m.kind}"
                    )
                return m
            m = cls(name, desc, tuple(labels), **kw)
            self._metrics[name] = m
            return m

    def counter(self, name: str, desc: str,
                labels: tuple = ()) -> Counter:
        return self._declare(Counter, name, desc, labels)

    def gauge(self, name: str, desc: str, labels: tuple = ()) -> Gauge:
        return self._declare(Gauge, name, desc, labels)

    def histogram(self, name: str, desc: str, labels: tuple = (), *,
                  buckets=DEFAULT_BUCKETS,
                  max_samples: int = 8192) -> Histogram:
        return self._declare(Histogram, name, desc, labels,
                             buckets=buckets, max_samples=max_samples)

    # -- introspection ------------------------------------------------------

    def metrics(self) -> list:
        with self._lock:
            return list(self._metrics.values())

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def describe(self) -> dict:
        """``{name: (kind, description, labelnames)}`` — the one source of
        truth the Prometheus HELP lines and the generated stats-key
        reference table both render from."""
        return {
            m.name: (m.kind, m.desc, m.labelnames) for m in self.metrics()
        }

    def snapshot(self) -> dict:
        """Flat ``{key: value}`` of every handle.  Label-less metrics key
        by bare name; labeled ones by ``name{a=x,b=y}`` (deterministic
        label order = declaration order)."""
        out = {}
        for m in self.metrics():
            for key, h in m.samples():
                if m.labelnames:
                    lbl = ",".join(f"{n}={v}" for n, v in
                                   zip(m.labelnames, key))
                    out[f"{m.name}{{{lbl}}}"] = h.value()
                else:
                    out[m.name] = h.value()
        return out

    # -- sinks --------------------------------------------------------------

    def attach(self, sink) -> None:
        """Attach a sink (anything with ``emit(record)``); ``emit`` fans
        out to every attached sink."""
        with self._lock:
            self._sinks.append(sink)

    @property
    def sinks(self) -> tuple:
        with self._lock:
            return tuple(self._sinks)

    def emit(self, kind: str = "snapshot", extra: Optional[dict] = None,
             ) -> dict:
        """Snapshot every metric into one record and hand it to each
        attached sink.  Returns the record (so callers without sinks can
        still use ``emit`` as 'snapshot with provenance')."""
        record = {
            "kind": str(kind),
            "namespace": self.namespace,
            "t_wall": time.time(),       # provenance only, never a witness
            "metrics": self.snapshot(),
        }
        if extra:
            record.update(extra)
        for sink in self.sinks:
            sink.emit(record)
        return record

    def close(self) -> None:
        for sink in self.sinks:
            close = getattr(sink, "close", None)
            if close is not None:
                close()


_DEFAULT = MetricsRegistry(namespace="repro")


def default_registry() -> MetricsRegistry:
    """The process-wide registry (ad-hoc scripts, single-tenant tools).
    Subsystems that can exist N times per process — ``DetectorPool`` —
    scope their own instance instead."""
    return _DEFAULT
