"""Fixed-size chunking of event streams (numpy; ``repro.events.stream``'s
``chunk_iterator`` and ``stack_chunks``).

``stack_chunks`` pads and reshapes a whole stream into ``(n_chunks, chunk,
...)`` arrays for the batch pipeline.  Timestamps stay int64 here; the
pipeline rebases them to chunk-relative int32 (``pipeline.chunk_ts_base``).
"""
from __future__ import annotations

from typing import Iterator

import numpy as np

from repro_torch.events.synthetic import EventStream

__all__ = ["chunk_iterator", "stack_chunks"]


def chunk_iterator(
    stream: EventStream, chunk: int, *, start_chunk: int = 0
) -> Iterator[tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (xy, ts, valid) fixed-size chunks; tail padded with (0,0) dummies."""
    e = len(stream)
    n_chunks = (e + chunk - 1) // chunk
    for c in range(start_chunk, n_chunks):
        lo, hi = c * chunk, min((c + 1) * chunk, e)
        n = hi - lo
        xy = np.zeros((chunk, 2), np.int32)
        ts = np.zeros((chunk,), np.int64)
        xy[:n] = stream.xy[lo:hi]
        ts[:n] = stream.ts[lo:hi]
        if n:
            ts[n:] = stream.ts[hi - 1]
        valid = np.arange(chunk) < n
        yield xy, ts, valid


def stack_chunks(
    xy: np.ndarray, ts: np.ndarray, chunk: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Pad a stream to a chunk multiple and stack it into per-chunk arrays.

    Returns ``(xy (C, chunk, 2) int32, ts (C, chunk) int64,
    valid (C, chunk) bool, n_events)``.  Padding slots sit at the in-bounds
    dummy pixel (0, 0) and repeat the last timestamp, exactly like
    ``chunk_iterator``; they carry ``valid=False`` and are inert.
    """
    xy = np.asarray(xy, np.int32)
    ts = np.asarray(ts, np.int64)
    e = xy.shape[0]
    pad = (-e) % chunk
    if pad:
        xy = np.concatenate([xy, np.zeros((pad, 2), np.int32)], 0)
        ts = np.concatenate(
            [ts, np.full((pad,), ts[-1] if e else 0, ts.dtype)], 0
        )
    c = (e + pad) // chunk
    valid = np.arange(e + pad) < e
    return (
        xy.reshape(c, chunk, 2),
        ts.reshape(c, chunk),
        valid.reshape(c, chunk),
        e,
    )
