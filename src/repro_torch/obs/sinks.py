"""Metric sinks: where registry emissions go.

A sink is anything with ``emit(record: dict)`` (and optionally
``close()``).  ``MetricsRegistry.emit()`` builds one record per call —
``{"kind", "namespace", "t_wall", "metrics": {key: value}}`` — and fans it
out to every attached sink.  The composite-tracker idiom: the registry
never knows whether it is talking to a console, a JSONL file, a
Prometheus text file, or all three at once, and one broken sink never
poisons the others (``CompositeSink`` isolates per-sink faults).

- ``LogSink``    — human-oriented one-liners through a callable
                   (``print`` by default, or a logger method).
- ``JsonlSink``  — one JSON object per line, append-only, thread-safe;
                   the machine-readable trail ``serve_events
                   --metrics-out`` writes.
- ``PromSink``   — Prometheus text exposition (version 0.0.4) rewritten
                   atomically on every emit; a node-exporter-style
                   textfile, scrapeable without a server (the scrape
                   *endpoint* lives with the future ingest tier).
- ``CompositeSink`` — fan-out with fault isolation.
"""
from __future__ import annotations

import io
import json
import os
import threading
from typing import Callable, Optional

__all__ = ["LogSink", "JsonlSink", "PromSink", "CompositeSink"]


def _json_default(o):
    # numpy scalars/arrays sneak into records via device math; coerce
    # without importing numpy here (obs must not depend on it)
    for attr in ("item",):
        f = getattr(o, attr, None)
        if callable(f):
            return f()
    tolist = getattr(o, "tolist", None)
    if callable(tolist):
        return tolist()
    raise TypeError(f"not JSON serializable: {type(o).__name__}")


class LogSink:
    """Render each record as one compact human-readable line.

    ``write`` is any ``str -> None`` callable (``print``,
    ``logger.info``, a list's ``append`` in tests).  ``fields`` limits
    the rendered metrics to keys containing any of the given substrings
    (a console summary wants 10 numbers, not 80).
    """

    def __init__(self, write: Callable[[str], None] = print,
                 fields: Optional[tuple] = None):
        self._write = write
        self._fields = tuple(fields) if fields else None

    def emit(self, record: dict) -> None:
        metrics = record.get("metrics", {})
        if self._fields is not None:
            metrics = {k: v for k, v in metrics.items()
                       if any(f in k for f in self._fields)}
        parts = []
        for k, v in metrics.items():
            if isinstance(v, float):
                parts.append(f"{k}={v:.6g}")
            else:
                parts.append(f"{k}={v}")
        ns = record.get("namespace", "")
        kind = record.get("kind", "snapshot")
        self._write(f"[{ns}:{kind}] " + " ".join(parts))


class JsonlSink:
    """Append one JSON object per emit to a file, thread-safe.

    Writes are serialized under a lock and flushed per record, so the
    pump thread, the reader thread, and a periodic monitor can all emit
    concurrently and a crash loses at most the in-flight line.  Records
    round-trip: ``read_jsonl(path)`` returns exactly what was emitted.
    """

    def __init__(self, path):
        self.path = os.fspath(path)
        self._lock = threading.Lock()
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")

    def emit(self, record: dict) -> None:
        line = json.dumps(record, sort_keys=True, default=_json_default)
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line + "\n")
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None


def read_jsonl(path) -> list:
    """Load a JsonlSink trail back into a list of records."""
    out = []
    with open(os.fspath(path), encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


class PromSink:
    """Prometheus text exposition written to a file on every emit.

    The whole exposition is rewritten from the registry's current state
    (records are cumulative, so last-write-wins is correct) and swapped
    in atomically via tmp+rename — a scraper never sees a torn file.
    Needs the registry itself (for ``describe()`` HELP/TYPE lines and
    structured label access), so attach it via ``PromSink(path,
    registry)`` rather than relying on the flat record alone.
    """

    def __init__(self, path, registry):
        self.path = os.fspath(path)
        self._registry = registry
        self._lock = threading.Lock()
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)

    @staticmethod
    def _escape(s: str) -> str:
        return (str(s).replace("\\", r"\\").replace("\n", r"\n")
                .replace('"', r'\"'))

    @staticmethod
    def _fmt(v) -> str:
        if isinstance(v, bool):
            return "1" if v else "0"
        if isinstance(v, (int,)):
            return str(v)
        try:
            return repr(float(v))
        except (TypeError, ValueError):
            return "0"

    def render(self) -> str:
        """The full exposition for the current registry state."""
        reg = self._registry
        ns = reg.namespace or "repro"
        buf = io.StringIO()
        for m in reg.metrics():
            full = f"{ns}_{m.name}"
            buf.write(f"# HELP {full} {self._escape(m.desc)}\n")
            buf.write(f"# TYPE {full} {m.kind}\n")
            for key, h in m.samples():
                lbl = ""
                if m.labelnames:
                    pairs = ",".join(
                        f'{n}="{self._escape(v)}"'
                        for n, v in zip(m.labelnames, key))
                    lbl = "{" + pairs + "}"
                if m.kind == "histogram":
                    acc = 0
                    for bound, c in zip(m.buckets, h.bucket_counts):
                        acc += c
                        le = ('{le="%s"%s}'
                              % (repr(float(bound)),
                                 "," + lbl[1:-1] if lbl else ""))
                        buf.write(f"{full}_bucket{le} {acc}\n")
                    inf = ('{le="+Inf"%s}'
                           % ("," + lbl[1:-1] if lbl else ""))
                    buf.write(f"{full}_bucket{inf} {h.count}\n")
                    buf.write(f"{full}_sum{lbl} {self._fmt(h.sum)}\n")
                    buf.write(f"{full}_count{lbl} {h.count}\n")
                else:
                    buf.write(f"{full}{lbl} {self._fmt(h.value())}\n")
        return buf.getvalue()

    def emit(self, record: dict) -> None:
        text = self.render()
        with self._lock:
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fh:
                fh.write(text)
            os.replace(tmp, self.path)


class CompositeSink:
    """Fan one emit out to many sinks; one failing sink never poisons
    the rest (its first error is remembered in ``errors`` for tests and
    reported once through ``on_error``, default silent)."""

    def __init__(self, sinks, on_error: Optional[Callable] = None):
        self._sinks = list(sinks)
        self._on_error = on_error
        self._lock = threading.Lock()
        self.errors: dict[int, str] = {}

    def emit(self, record: dict) -> None:
        for i, sink in enumerate(self._sinks):
            try:
                sink.emit(record)
            except Exception as e:  # noqa: BLE001 — isolation is the point
                with self._lock:
                    first = i not in self.errors
                    if first:
                        self.errors[i] = f"{type(e).__name__}: {e}"
                if first and self._on_error is not None:
                    self._on_error(sink, e)

    def close(self) -> None:
        for sink in self._sinks:
            close = getattr(sink, "close", None)
            if close is None:
                continue
            try:
                close()
            except Exception:  # noqa: BLE001
                pass
