"""Multi-camera serving (``repro.serve.pool``): the data-plane runtime
wired to a placement scheduler.

``DetectorPool`` is a thin façade over ``serve.runtime.PoolRuntime`` (the
data plane: executors, device rings, the reader thread, lane buffers) and
a ``serve.scheduler`` policy (which bucket a lane lands in, which order
buckets pump in).  The port serves ``policy="static"``: a lane stays in
the bucket chosen at ``connect()`` for life and buckets pump in ascending
order.  The reference's adaptive, ladder and pack policies are refused
until they are ported (``ROADMAP.md``, M8).

A lane's outputs equal a standalone ``StreamingDetector``'s and
``run_pipeline``'s on that lane's full stream, whatever the interleaving,
K-blocking, drain mode or readout.  Only fixed-Vdd and online-DVFS configs
are servable.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.serve import scheduler as scheduler_mod
from repro_torch.serve.runtime import PoolRuntime

__all__ = ["DetectorPool"]


class DetectorPool:
    """Fixed-capacity pool of detector sessions: a ``PoolRuntime`` driven
    by a placement scheduler.  ``pipeline_depth`` sizes the pump's
    stage-ahead window (1 = the serial pump; results are the same either
    way).  ``readout="compact"`` keeps each ring slot's kept corners as
    ``(cap,)`` records on the device (K3), so drains fetch about
    ``chunk/cap`` times fewer bytes; ``compact_cap`` overrides the
    ``chunk // 8`` default, and a slot-lane that overflows it falls back to
    its dense row.  Results equal ``"dense"``'s.  Runs on ``cfg.device``.
    """

    def __init__(self, cfg, capacity: int, *, seed: int = 0,
                 ring_rounds: int = 8,
                 buckets: Optional[tuple] = None,
                 on_overflow: str = "drain",
                 shard: object = "auto",
                 drain_mode: str = "async",
                 ring_depth: int = 2,
                 pipeline_depth: int = 2,
                 readout: str = "dense",
                 compact_cap: Optional[int] = None,
                 policy: str = "static",
                 metrics: Optional[obs_mod.MetricsRegistry] = None):
        self._rt = PoolRuntime(
            cfg, capacity, seed=seed, ring_rounds=ring_rounds,
            buckets=buckets, on_overflow=on_overflow, shard=shard,
            drain_mode=drain_mode, ring_depth=ring_depth,
            pipeline_depth=pipeline_depth, readout=readout,
            compact_cap=compact_cap, metrics=metrics,
        )
        try:
            self._sched = scheduler_mod.make_scheduler(policy,
                                                       self._rt.buckets)
        except NotImplementedError:
            self._rt.close()          # stop the reader thread, then refuse
            raise
        self._sched.bind_metrics(self._rt.metrics)
        self._cfg = cfg

    # Data-plane attributes (``_states``, ``_rings``, ``_phys``,
    # ``_reader``, ...) resolve on the runtime.
    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_rt"), name)

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Stop the runtime (reader thread included).  Rounds still sealed
        or buffered on device are abandoned — ``flush`` the lanes first if
        their results matter.  Idempotent; the pool rejects further use."""
        self._rt.close()

    def __enter__(self) -> "DetectorPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- membership ---------------------------------------------------------

    def connect(self, *, seed: Optional[int] = None,
                chunk: Optional[int] = None,
                qos: str = "standard") -> int:
        """Claim a free lane for a new camera session; returns the lane id.
        ``chunk`` requests a per-session chunk size: the lane lands in the
        smallest configured bucket that fits (default ``cfg.chunk``).
        ``qos`` is carried as a label."""
        want = self._cfg.chunk if chunk is None else int(chunk)
        bucket = self._sched.place(want)
        if bucket is None:
            raise ValueError(
                f"no chunk bucket fits {want} (buckets: {self._rt.buckets})"
            )
        lane = self._rt.connect(bucket, seed, qos=qos)
        self._sched.forget(lane)
        return lane

    def disconnect(self, lane: int) -> dict:
        """Release a lane; returns its final accounting stats.  Undrained
        ring slots are drained first, so the slot's next tenant inherits
        nothing."""
        out = self._rt.disconnect(lane)
        self._sched.forget(lane)
        return out

    def warmup(self, xy, ts_us) -> None:
        """Exercise every executor shape of the default bucket outside any
        timed region, with the reference's recipe: a scratch lane pumps a
        multi-round block (the K-block executor), then a lone round (the
        1-round path), then disconnects, leaving its slot's next tenant
        nothing.  The port compiles nothing, so this builds the kernels on
        their first launch and records each block shape once
        (``compile_cache_sizes``)."""
        lane = self.connect()
        b = self._rt._lanes[lane].bucket
        xy = np.asarray(xy)
        ts = np.asarray(ts_us)
        self.feed(lane, xy[:3 * b], ts[:3 * b])
        self.pump()
        self.feed(lane, xy[:b], ts[:b])
        self.pump()
        self.disconnect(lane)

    # -- serving ------------------------------------------------------------

    def feed(self, lane: int, xy, ts_us) -> None:
        """Buffer a slab for one session (any length, time-sorted)."""
        self._rt.feed(lane, xy, ts_us)

    def pump(self) -> int:
        """Fold every buffered full chunk through the bucket executors until
        no active lane has a full chunk left.  Returns rounds executed."""
        return self.pump_rounds(None)

    def pump_rounds(self, max_rounds: Optional[int] = None) -> int:
        """Like ``pump`` but stops after at most ``max_rounds`` rounds
        (``None`` = run until dry)."""
        return self._rt.pump_pass(self._sched.order({}), max_rounds)

    def flush(self, lane: int):
        """Drain the lane's full chunks, then its padded partial tail, and
        return everything not yet polled."""
        return self._rt.flush(lane, self._sched.order({}))

    def poll(self, lane: int, *, wait: bool = True):
        """Drain the lane's accumulated (scores, kept), in stream order
        (see ``PoolRuntime.poll``)."""
        return self._rt.poll(lane, wait=wait)

    # -- introspection ------------------------------------------------------

    @property
    def policy(self) -> str:
        return self._sched.policy

    @property
    def scheduler(self) -> scheduler_mod.StaticScheduler:
        return self._sched

    def stats(self, lane: int) -> dict:
        """Lane accounting; see ``PoolRuntime.stats``."""
        return self._rt.stats(lane)

    def pool_stats(self) -> dict:
        """Pool-level runtime counters plus the active policy; see
        ``PoolRuntime.pool_stats``."""
        out = self._rt.pool_stats()
        out["policy"] = self._sched.policy
        out.update(self._sched.scheduler_stats())
        return out

    def emit_metrics(self, kind: str = "pool") -> dict:
        """Snapshot the pool's registry into one record, fold the
        scheduler's policy counters in as extras, and fan it out to every
        attached sink (``pool.metrics.attach(...)``).  Returns the record."""
        extra = {"policy": self._sched.policy,
                 **self._sched.scheduler_stats()}
        return self._rt.metrics.emit(kind, extra={"scheduler": extra})
