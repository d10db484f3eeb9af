"""Observability spine: metrics registry, sinks, and the stats schema.

``repro_torch.obs`` is the single write path for serving witnesses.  The
runtime and scheduler mutate registry handles (``metrics``); attachable
sinks (``sinks``) fan emissions out to logs / JSONL / Prometheus text;
``schema`` declares every exported stats key with its description and is
the one source of truth for docs, registry metric HELP text, and the
golden-key tests; ``spans`` times named ranges inside the port, and counts,
while the torch profiler runs (``span``, ``spans.count``).
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    timer,
)
from repro_torch.obs.sinks import (  # noqa: F401
    CompositeSink,
    JsonlSink,
    LogSink,
    PromSink,
    read_jsonl,
)
from repro_torch.obs import schema  # noqa: F401
from repro_torch.obs import spans  # noqa: F401
from repro_torch.obs.spans import span  # noqa: F401
from repro_torch.obs.d2h import leaves_nbytes  # noqa: F401

__all__ = [
    "leaves_nbytes",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "default_registry",
    "timer",
    "CompositeSink",
    "JsonlSink",
    "LogSink",
    "PromSink",
    "read_jsonl",
    "schema",
    "span",
    "spans",
]
