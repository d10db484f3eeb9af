"""Fixed-size chunking of event streams and their prefetched upload
(``repro.events.stream``).

``chunk_iterator`` yields fixed-size chunks (the tail padded);
``stack_chunks`` pads and reshapes a whole stream into ``(n_chunks, chunk,
...)`` arrays for the batch pipeline.  Timestamps stay int64 there; the
pipeline rebases them to chunk-relative int32 (``pipeline.chunk_ts_base``).
``PrefetchingLoader`` moves the chunks to the device on a worker thread,
one chunk ahead of the consumer or more, rebased to int32.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.state import resolve_device
from repro_torch.events.synthetic import EventStream

__all__ = ["chunk_iterator", "stack_chunks", "PrefetchingLoader"]


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


class PrefetchingLoader:
    """Background-thread upload of a stream's chunks (double buffering).

    Yields ``(xy (chunk, 2) int32, ts (chunk,) int32, valid (chunk,) bool)``
    on ``device`` (the card unless the caller asks for ``"cpu"``; asking
    for CUDA without it raises).  Timestamps are rebased by ``rebase_us``
    in int64 on the host; a chunk that would still overflow int32 raises
    instead of wrapping.  ``device_slabs=True`` declares the serving
    contract: chunks sized and rebased for
    ``StreamingDetector.feed_device_chunk`` (pass ``rebase_us=
    session_base_us(...)``), so slabs go host -> device once, off the
    consumer thread, with no re-chunking.

    On CUDA the worker copies each chunk from pinned memory on a copy
    stream of its own and records an event after the chunk's copies;
    ``__next__`` makes the consumer's current stream wait on that event
    and marks the tensors as used on it, so the copy overlaps the
    consumer's work and the allocator cannot hand their memory out early.
    Every item is a fresh set of tensors: a consumer may keep any of them.

    Worker exceptions are re-raised on the consumer's ``next``.
    ``close()`` (or leaving the context manager) stops the worker early
    and joins it; use it when abandoning a partially consumed stream.
    """

    def __init__(self, stream: EventStream, chunk: int, *, depth: int = 2,
                 start_chunk: int = 0, device_slabs: bool = False,
                 rebase_us: int = 0, device="cuda"):
        self._device = resolve_device(device)
        self._it = chunk_iterator(stream, chunk, start_chunk=start_chunk)
        self.device_slabs = device_slabs   # declared consumer contract
        self._rebase_us = int(rebase_us)
        self._copy_stream = (torch.cuda.Stream(self._device)
                             if self._device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._closed = False
        self._ended = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that aborts when close() is requested."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _upload(self, arrays):
        """One chunk's tensors on the device, and the event that marks
        their copies done (None on the CPU)."""
        host = [torch.from_numpy(a) for a in arrays]
        if self._copy_stream is None:
            return tuple(host), None
        with torch.cuda.stream(self._copy_stream):
            dev = tuple(h.pin_memory().to(self._device, non_blocking=True)
                        for h in host)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return dev, done

    def _worker(self):
        try:
            for xy, ts, valid in self._it:
                ts64 = ts - self._rebase_us
                if ts64.size and int(ts64.max()) > np.iinfo(np.int32).max:
                    # Never wrap silently: long recordings need rebase_us.
                    raise OverflowError(
                        "chunk timestamps exceed int32 after rebase by "
                        f"{self._rebase_us}; pass rebase_us= (see "
                        "StreamingDetector / session_base_us) before "
                        "streaming further"
                    )
                item = self._upload((xy, ts64.astype(np.int32), valid))
                if not self._put(item):
                    return
        except BaseException as e:  # propagate to the consumer
            self._err = e
        self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed or self._ended:
            raise StopIteration
        item = self._q.get()
        if item is self._done:
            self._ended = True
            if self._err is not None:
                err, self._err = self._err, None
                raise err
            raise StopIteration
        tensors, done = item
        if done is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(done)
            for t in tensors:
                t.record_stream(consumer)
        return tensors

    def close(self):
        """Stop the worker and release the queue (idempotent)."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        try:  # drain so a blocked worker put() wakes up promptly
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
