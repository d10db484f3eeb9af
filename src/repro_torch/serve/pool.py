"""Multi-camera serving (``repro.serve.pool``): the data-plane runtime
wired to a placement scheduler.

``DetectorPool`` is a thin façade over ``serve.runtime.PoolRuntime`` (the
data plane: executors, device rings, the reader thread, lane buffers) and
a ``serve.scheduler`` policy (which bucket a lane lands in, which order
buckets pump in, which knobs a lane runs at).  ``policy="static"`` keeps a
lane in the bucket chosen at ``connect()`` for life and pumps buckets in
ascending order; ``policy="adaptive"`` moves a lane between buckets live
as its measured event rate changes (each ``poll`` / ``flush`` is one rate
observation) and pumps the most backlogged bucket first;
``policy="ladder"`` degrades lanes under backlog pressure, QoS class by
class (``connect(qos=)``, ``ladder=LadderConfig(...)``), and packs sparse
buckets at its top level; ``policy="pack"`` packs alone.  The ladder and
pack decide once per pump pass, on the runtime's ``Observation``: their
knob writes apply before the pass's rounds, their moves at the next pass;
``poll`` never actuates them.  ``set_lane_control`` moves a lane's
degradation knobs by hand.

A lane's outputs equal a standalone ``StreamingDetector``'s and
``run_pipeline``'s on that lane's full stream, whatever the interleaving,
K-blocking, drain mode or readout; a lane that migrated equals a
``StreamingDetector`` that ``rebucket()``s at the lane's logged
boundaries.  Only fixed-Vdd and online-DVFS configs are servable.
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
    its dense row.  Results equal ``"dense"``'s.  Runs on ``cfg.device``;
    ``shard=True``, or ``"auto"`` where there is more than one local
    device of that type, shards the lanes over a lane mesh of them (see
    ``serve.runtime``), with the same results.

    ``migrate_patience`` and ``migrate_margin`` tune ``policy="adaptive"``
    (rate windows a move must be wanted for; the headroom a move down
    needs); ``migrate_patience`` is also ``policy="pack"``'s patience.
    ``ladder=`` configures ``policy="ladder"`` (default ``LadderConfig()``;
    its base refresh interval is ``cfg.lut_every_chunks`` and its top
    operating point the runtime's ``vdd_top``).  ``scheduler=`` passes a
    policy object instead, whose buckets must be the pool's.
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
                 migrate_patience: int = 3,
                 migrate_margin: float = 0.9,
                 ladder: Optional[scheduler_mod.LadderConfig] = None,
                 scheduler: Optional[scheduler_mod.StaticScheduler] = None,
                 metrics: Optional[obs_mod.MetricsRegistry] = None):
        self._rt = PoolRuntime(
            cfg, capacity, seed=seed, ring_rounds=ring_rounds,
            buckets=buckets, on_overflow=on_overflow, shard=shard,
            drain_mode=drain_mode, ring_depth=ring_depth,
            pipeline_depth=pipeline_depth, readout=readout,
            compact_cap=compact_cap, metrics=metrics,
        )
        try:
            if scheduler is not None:
                if tuple(scheduler.buckets) != self._rt.buckets:
                    raise ValueError(
                        f"scheduler buckets {scheduler.buckets} do not "
                        f"match pool buckets {self._rt.buckets}")
                self._sched = scheduler
            else:
                self._sched = scheduler_mod.make_scheduler(
                    policy, self._rt.buckets, patience=migrate_patience,
                    down_margin=migrate_margin, ladder=ladder,
                    base_lut_every=cfg.lut_every_chunks,
                    vdd_top=self._rt.vdd_top)
        except BaseException:
            self._rt.close()          # stop the reader thread, then refuse
            raise
        self._sched.bind_metrics(self._rt.metrics)
        self._cfg = cfg
        # Moves decided by non-blocking polls: staging seals and drains
        # (it may wait on the reader), which poll(wait=False) must never
        # do, so the decision parks here and is staged at the next pump or
        # flush.  Guarded by the runtime lock.
        self._deferred: dict[int, int] = {}

    # Data-plane attributes and verbs (``_states``, ``_rings``,
    # ``set_lane_control``, ``vdd_top``, ...) resolve on the runtime.
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
        ``qos`` names the session's QoS class: under ``policy="ladder"`` it
        must be one of the ladder's classes (earlier classes degrade
        first); other policies carry it as a label.  Under
        ``policy="adaptive"`` the placement is only the starting point."""
        want = self._cfg.chunk if chunk is None else int(chunk)
        bucket = self._sched.place(want)
        if bucket is None:
            raise ValueError(
                f"no chunk bucket fits {want} (buckets: {self._rt.buckets})"
            )
        lad = getattr(self._sched, "ladder", None)
        if lad is not None and qos not in lad.qos_names():
            raise ValueError(
                f"unknown QoS class {qos!r} (ladder classes: "
                f"{lad.qos_names()})"
            )
        lane = self._rt.connect(bucket, seed, qos=qos)
        self._forget(lane)
        return lane

    def disconnect(self, lane: int) -> dict:
        """Release a lane; returns its final accounting stats.  Undrained
        ring slots are drained first and a staged or parked move is
        dropped, so the slot's next tenant inherits nothing."""
        out = self._rt.disconnect(lane)
        self._forget(lane)
        return out

    def _forget(self, lane: int) -> None:
        """A recycled slot starts with no rate streak and no parked move."""
        self._sched.forget(lane)
        with self._rt._lock:
            self._deferred.pop(lane, None)

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
        (``None`` = run until dry).  Moves parked by non-blocking polls
        are staged first, staged moves apply before any round, and a
        policy that decides per pump (ladder, pack) observes and acts
        then."""
        self._stage_deferred()
        return self._rt.pump_pass(self._order(), max_rounds,
                                  decide=self._decide())

    def flush(self, lane: int):
        """Drain the lane's full chunks, then its padded partial tail, and
        return everything not yet polled.  One rate observation, like
        ``poll``."""
        self._stage_deferred()
        out = self._rt.flush(lane, self._order())
        self._observe(lane)
        return out

    def poll(self, lane: int, *, wait: bool = True):
        """Drain the lane's accumulated (scores, kept), in stream order
        (see ``PoolRuntime.poll``).  Each poll is one rate observation:
        under ``policy="adaptive"`` a lane whose rate has outgrown (or
        undershot) its bucket for ``migrate_patience`` rate windows has
        its move staged here, or, with ``wait=False``, parked until the
        next pump or flush; the move applies at the next pump pass."""
        out = self._rt.poll(lane, wait=wait)
        self._observe(lane, allow_stage=wait)
        return out

    def _order(self) -> tuple:
        """The scheduler's bucket pump order.  The backlog walk holds the
        runtime lock over every active lane, so it runs only for a policy
        that reads it."""
        backlog = (self._rt.bucket_backlog_rounds()
                   if self._sched.needs_backlog else {})
        return self._sched.order(backlog)

    def _decide(self):
        """The scheduler's ``decide`` for the runtime's per-pump control
        loop, or ``None`` for a policy that never acts there (static,
        adaptive), so no ``Observation`` is built for it."""
        if not self._sched.needs_pump_observation:
            return None
        return self._sched.decide

    def _observe(self, lane: int, *, allow_stage: bool = True) -> None:
        """Give the scheduler one rate sample for ``lane`` and stage the
        move it decides, or park it when the caller must not block.
        Serialized under the runtime lock so concurrent pollers cannot
        interleave the scheduler's state.  Under the profiler this is the
        span ``pool.observe``, with a staged move's ``pool.migrate`` inside
        it."""
        if not self._sched.needs_observation:
            return
        with obs_mod.span("pool.observe"), self._rt._lock:
            if not self._rt._active[lane]:
                return                      # retired by a concurrent caller
            ln = self._rt._lanes[lane]
            target = self._sched.observe(
                lane, ln.bucket, self._rt.lane_halfwin_rate(lane),
                win=ln.r_win,
            )
            if target is None or target == ln.bucket:
                return
            if allow_stage:
                self._deferred.pop(lane, None)
                self._rt.stage_migration(lane, target)
            else:
                self._deferred[lane] = target

    def _stage_deferred(self) -> None:
        """Stage the moves parked by non-blocking polls (a pump or flush
        may block anyway)."""
        if not self._deferred:
            return
        with self._rt._lock:
            for lane, target in list(self._deferred.items()):
                # pop, not del: a concurrent disconnect can clear the entry
                # while an earlier staging waits on the pump token
                self._deferred.pop(lane, None)
                if (self._rt._active[lane]
                        and self._rt._lanes[lane].bucket != target):
                    self._rt.stage_migration(lane, target)

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
        """Pool-level runtime counters plus the active policy and its own
        counters (``ladder_level``, ``pack_moves``, ...); see
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
