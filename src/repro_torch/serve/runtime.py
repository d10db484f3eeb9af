"""Data plane of the multi-camera pool (``repro.serve.runtime``).

``PoolRuntime`` owns the pool's mechanisms — per-bucket executors, the
device result rings and their reader thread, the lane-stacked detector
state, host re-chunk buffers — and exposes them as verbs (``connect`` a
lane into a bucket, ``feed`` it, ``pump_pass`` an ordered list of buckets,
``poll`` / ``flush`` its results).  Which bucket a lane belongs in and
the pump order are policy (``serve.scheduler``), wired in by the
``DetectorPool`` façade.

**Executors.**  A bucket's executor is a host loop, not a compiled
program: for each ready round, in round order, it runs the lane-batched
``detector_step_`` over all lanes, in place on the pool's own state (K1
in one launch, which leaves the inactive lanes' surfaces untouched; K2
over the lanes whose LUT refresh is due), keeps the inactive lanes' other
leaves (the masked select), and pushes the round into the bucket's live
device ring in one K3 ring-push launch (which, with ``readout="compact"``,
also ranks the round's kept-event records).  Rounds are gathered
``ring_rounds`` at a time into a block and uploaded as the reference
uploads them: a block with one ready round as ``(lanes, chunk)`` slabs,
any other as padded ``(ring_rounds, lanes, chunk)`` slabs whose padded
rounds the host skips.
Nothing is compiled, so ``compile_cache_sizes`` counts, per bucket and
block shape, the distinct shape signatures of the device slabs the executor
was handed (what a compiled or captured executor would need one build per);
``executors_compiled_once`` holds while each count is at most 1, so
membership, occupancy and lane placement never change those shapes.

**Rings and drains.**  The host fetches a ring once per drain, in one
transfer, and walks its slots oldest-first.  ``on_overflow="drain"``
drains before a block that would not fit (lossless backpressure);
``"drop_oldest"`` lets a full ring overwrite its oldest slot and counts
the loss.  ``drain_mode="sync"`` fetches inline on the calling thread;
``"async"`` gives each bucket ``ring_depth`` rings: draining *seals* the
live ring (a spare becomes live) and hands it, with a CUDA event recorded
after its last push, to a reader thread.  The reader waits on that event
from its own CUDA stream, copies the leaves into pinned host memory,
synchronises its stream, and only then takes the lock to distribute and
return the ring to the spares.  ``readout="compact"`` fetches each slot's
kept-event records (K3) instead of the dense rows, and the dense row of a
slot-lane whose kept count overflowed the records in a second transfer;
the host densify reproduces the dense slot byte for byte.

**Pipelined pump.**  A pass *stages* a block (host gather plus its H2D
upload through the pinned ``HostStager``) and *dispatches* it (ring room,
then the executor) up to ``pipeline_depth - 1`` blocks later, in stage
order, so the next block's gather and upload overlap the device's work.
A timebase rebase flushes the staged blocks first.

**Membership** is an active mask over ``capacity`` lanes: join and leave
are data, never a new executor.  Per lane the runtime keeps what a
``StreamingDetector`` keeps (re-chunk buffer, int64 timebase, float64
books, result queue), so a lane's results equal a standalone session's and
``run_pipeline``'s on its stream.

**Live migration.**  ``stage_migration`` seals and drains the lane's
bucket, so every round it has executed reaches its result queue in
stream order, and records the target; the move applies at the start of
the next pump pass or flush, under the pump token, so no block staged
ahead can still hold the lane's rows for the old bucket.  The lane-stacked
state has no chunk axis and is stepped in place, so a move touches no
device memory: the lane's rows stay where they are, and its host re-chunk
buffer re-chunks at the new size from the next collect.

**Knob writes.**  ``set_lane_control`` moves a lane's ``lut_every``,
``vdd_cap`` and ``shed`` (``DetectorState.ctrl``, host arrays read by the
step), so a write launches nothing.  A shedding lane keeps at most one
ring of rounds in its re-chunk buffer, dropping the oldest events.

**Control loop.**  ``pump_pass(..., decide=)`` runs a policy's
observe -> decide -> actuate step under the pump token, after the staged
moves apply and before any round is collected.  The ``Observation`` is
host data only (no device read); each lane's part is memoised on a
generation counter that feed, shed, round collection, move apply and tier
writes bump, so an idle lane is served from its cache
(``observation_rebuilds`` / ``observation_reuses``).  The returned actions
write their knobs first, every write of the pass in one replacement of
the ``ctrl`` leaves (``ctrl_batched_writes`` / ``ctrl_actions_coalesced``
when more than one lane's knobs move), then mirror tiers and stage moves,
which apply at the next pass.

**Thread safety.**  One re-entrant lock guards all mutable state; the
reader takes it only to distribute and recycle, never across a transfer.
A pump token serializes whole pump passes, migrations and knob writes.

**Spans.**  While the torch profiler runs, the pool opens
``repro_torch.obs`` spans.  The pump thread: ``pool.pump`` over a pass,
in it ``pool.collect`` per round, ``pool.stage`` and ``pool.dispatch``
per block, and in a dispatch ``pool.forced_drain`` and, per round and
shard, ``pool.step`` (with the step's ``step.draw``) and ``pool.push``;
``pool.poll``, in it ``pool.seal`` and ``pool.poll_wait``; ``pool.flush``
over a flush, which pumps and polls inside it.  ``pool.migrate`` wraps
each move's work twice: where it is staged (the drain of the old bucket;
inside ``DetectorPool``'s ``pool.observe`` when a poll or flush decides
the move, inside ``pool.pump`` when a pass's actions do) and where it
applies (the drain again, inside ``pool.pump`` or ``pool.flush``).  The
reader thread opens none.  A round opens at most four ranges (collect,
step, draw, push), and its step adds to the counters
``step.lanes_stepped`` and ``step.lanes_active`` (``obs.spans.count``).
``pump_stage_s`` and ``pump_drain_wait_s`` are the ``pool.stage`` and
``pool.forced_drain`` spans' durations, counted with the profiler off
too.

**Lane sharding.**  ``shard=True``, or ``"auto"`` with more than one local
device of the pool's type, serves the lanes over a 1-D lane mesh
(``launch.sharding.local_lane_mesh``); otherwise the pool is one shard on
its device, so both share every code path.  The capacity is padded to a
multiple of the mesh width (the padding lanes are never connectable and
always masked).  Each shard owns a contiguous run of lanes on its device:
their state, riders, stager and rings (lane axis second).  The executor
steps and pushes every shard each round, on the shard's device; the step
has no cross-lane term, so no shard reads another's.  A drain fetches
each shard and gathers the lanes in global order; per-lane verbs route a
global lane to its shard and local index.
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch import obs as obs_mod
from repro_torch.core import dvfs as dvfs_mod
from repro_torch.core import pipeline as pipeline_mod
from repro_torch.core import state as state_mod
from repro_torch.kernels import fused_step
from repro_torch.launch import sharding as sharding_mod
from repro_torch.obs.schema import POOL_BUCKET_STATS, POOL_STATS
from repro_torch.serve import scheduler as scheduler_mod
from repro_torch.serve import streaming as streaming_mod

__all__ = ["PoolRuntime", "EVENT_SLOT_BYTES"]

_OVERFLOW_POLICIES = ("drain", "drop_oldest")
_DRAIN_MODES = ("sync", "async")
_READOUTS = ("dense", "compact")
_STOP = object()          # reader-thread shutdown sentinel

# H2D bytes per uploaded chunk slot: xy int32 pair + ts int32 + valid bool.
EVENT_SLOT_BYTES = 13


class _Lane:
    """Host-side bookkeeping for one pool slot."""

    __slots__ = ("bucket", "buf_xy", "buf_ts", "base", "results", "n_events",
                 "n_chunks", "kept_total", "energy_pj", "latency_ns",
                 "vdd_trace", "events_folded", "migrations", "migration_log",
                 "shed_events", "r_win", "r_cur", "r_p1", "r_p2", "qos",
                 "tier", "gen", "obs_cache")

    def __init__(self, bucket: int, *, qos: str = "standard"):
        self.bucket = bucket
        self.qos = qos
        self.tier = 0                   # actuated ladder tier (mirror)
        self.buf_xy = np.zeros((0, 2), np.int32)
        self.buf_ts = np.zeros((0,), np.int64)
        self.base: Optional[int] = None
        self.results: list[tuple[np.ndarray, np.ndarray]] = []
        self.n_events = 0
        self.n_chunks = 0
        self.kept_total = 0
        self.energy_pj = 0.0
        self.latency_ns = 0.0
        self.vdd_trace: list[float] = []
        self.events_folded = 0          # events consumed by executed rounds
        self.migrations = 0             # bucket moves applied to this lane
        # (events_folded, from_bucket, to_bucket) per applied move: a
        # StreamingDetector fed the same stream and rebucket()ed at each
        # logged boundary reproduces this lane's outputs.
        self.migration_log: list[tuple[int, int, int]] = []
        self.shed_events = 0            # oldest events dropped while shedding
        # Host twin of the 3-counter DVFS rate estimator (half-window
        # binning of *fed* timestamps; same rotation the device step does).
        self.r_win = 0
        self.r_cur = 0
        self.r_p1 = 0
        self.r_p2 = 0
        # Observation memo: ``gen`` moves with everything a
        # LaneObservation reads (feed, shed, round collection, move apply,
        # tier write); ``obs_cache`` is ``(gen, LaneObservation)``.
        self.gen = 0
        self.obs_cache: Optional[tuple] = None

    def rate_update(self, ts: np.ndarray, half: int) -> None:
        """Fold one time-sorted slab into the rate twin (only the last three
        half-windows can ever be read again, exactly like
        ``dvfs.online_vdd_from_chunk_ts``)."""
        w = ts // half
        wl = int(w[-1])
        n0 = int(np.count_nonzero(w == wl))
        n1 = int(np.count_nonzero(w == wl - 1))
        n2 = int(np.count_nonzero(w == wl - 2))
        d = wl - self.r_win
        if d == 0:
            cur, p1, p2 = self.r_cur + n0, self.r_p1 + n1, self.r_p2 + n2
        elif d == 1:
            cur, p1, p2 = n0, self.r_cur + n1, self.r_p1 + n2
        elif d == 2:
            cur, p1, p2 = n0, n1, self.r_cur + n2
        else:
            cur, p1, p2 = n0, n1, n2
        self.r_win, self.r_cur, self.r_p1, self.r_p2 = wl, cur, p1, p2


class _Round:
    """One collected pump round (host arrays, lane-stacked) for a bucket."""

    __slots__ = ("xy", "ts", "valid", "mask", "n_valid")

    def __init__(self, xy, ts, valid, mask, n_valid):
        self.xy, self.ts, self.valid = xy, ts, valid
        self.mask, self.n_valid = mask, n_valid


class _StagedBlock:
    """One block whose upload has started but whose rounds have not
    run: the unit of the pump's stage-ahead deque.  ``parts`` holds, per
    shard, its ``(xy, ts, valid, mask, n_valid)`` device tensors with a
    leading round axis (none when ``single``); ``masks`` are the host lane
    masks of the ``n`` real rounds, over all lanes."""

    __slots__ = ("bucket", "n", "single", "parts", "masks")

    def __init__(self, bucket, n, single, parts, masks):
        self.bucket, self.n, self.single = bucket, n, single
        self.parts, self.masks = parts, masks

    def round(self, i: int, shard: int):
        """Round ``i``'s device rows ``(xy, ts, valid, mask, n_valid)`` on
        shard ``shard``."""
        part = self.parts[shard]
        return part if self.single else tuple(t[i] for t in part)


class _Shard:
    """One device's run of lanes ``[lo, hi)``: their lane-stacked state,
    the step's riders and the stager of their uploads."""

    __slots__ = ("device", "lo", "hi", "state", "riders", "stager")

    def __init__(self, device, lo, hi, state, riders, stager):
        self.device, self.lo, self.hi = device, lo, hi
        self.state, self.riders, self.stager = state, riders, stager


def _record_event(device: torch.device) -> torch.cuda.Event:
    """A CUDA event recorded on ``device``'s current stream."""
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class PoolRuntime:
    """Mechanics of a fixed-capacity camera pool: per-bucket executors over
    the lane-stacked state, device result rings with sync or async drain,
    dense or compact readout, and a pipelined pump.  See the module
    docstring; placement comes from outside (``DetectorPool``)."""

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
                 metrics: Optional[obs_mod.MetricsRegistry] = None):
        streaming_mod._check_streamable(cfg)
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if ring_rounds < 1:
            raise ValueError("ring_rounds must be >= 1")
        if pipeline_depth < 1:
            raise ValueError(
                "pipeline_depth must be >= 1 (1 = unpipelined: every block "
                "dispatches as soon as it is staged)"
            )
        if on_overflow not in _OVERFLOW_POLICIES:
            raise ValueError(
                f"on_overflow must be one of {_OVERFLOW_POLICIES}, "
                f"got {on_overflow!r}"
            )
        if drain_mode not in _DRAIN_MODES:
            raise ValueError(
                f"drain_mode must be one of {_DRAIN_MODES}, "
                f"got {drain_mode!r}"
            )
        if ring_depth < 2:
            raise ValueError(
                "ring_depth must be >= 2 (one live ring plus at least one "
                "spare for the reader)"
            )
        if readout not in _READOUTS:
            raise ValueError(
                f"readout must be one of {_READOUTS}, got {readout!r}"
            )
        if compact_cap is not None and int(compact_cap) < 1:
            raise ValueError("compact_cap must be >= 1")
        if buckets is None:
            buckets = (cfg.chunk,)
        buckets = tuple(sorted({int(b) for b in buckets}))
        if any(b < 1 for b in buckets):
            raise ValueError("chunk buckets must be positive")
        if buckets[-1] > fused_step.MAX_EVENTS:
            raise ValueError(
                f"chunk bucket {buckets[-1]} exceeds the {fused_step.MAX_EVENTS}"
                f" events K1 takes per chunk")
        self._cfg = cfg
        self._device = state_mod.resolve_device(cfg.device)
        self._capacity = capacity
        self._seed = seed
        self._ring_rounds = ring_rounds
        self._buckets = buckets
        self._overflow = on_overflow
        self._drain_mode = drain_mode
        self._ring_depth = ring_depth
        self._pipeline_depth = int(pipeline_depth)
        self._readout = readout
        # Per-bucket record capacity: chunk/8 by default (corners are
        # sparse); an explicit compact_cap clamps to the bucket.
        self._compact_caps = {
            b: (max(1, b // 8) if compact_cap is None
                else max(1, min(int(compact_cap), b)))
            for b in buckets
        }
        self._half_us = int(cfg.dvfs_cfg.half_us)
        self._online = bool(cfg.dvfs and cfg.dvfs_online)
        self._tab = dvfs_mod.op_point_table(cfg.dvfs_cfg)
        self._vdd_top = state_mod._vdd_top(cfg)
        self._tcfg = {b: pipeline_mod._trace_cfg(cfg, chunk=b)
                      for b in buckets}

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._closed = False

        # -- lane sharding: a 1-D 'lanes' mesh, or one shard ---------------
        self._mesh = None
        if shard is True or shard == "auto":
            local = sharding_mod.local_lane_mesh(device=self._device.type)
            if shard is True or local.shape["lanes"] > 1:
                self._mesh = local
        if self._mesh is not None:
            other = {d.type for d in self._mesh.devices} - {
                self._device.type}
            if other:
                raise ValueError(
                    f"a lane mesh over {sorted(other)} devices cannot serve "
                    f"a pool on {self._device.type!r}")
        home = self._device
        if home.type == "cuda" and home.index is None:
            home = torch.device("cuda", torch.cuda.current_device())
        mesh = self._mesh or sharding_mod.LaneMesh((home,))
        # Physical lane count: padded so the lane axis splits evenly; the
        # padding lanes are permanently inactive (masked, never connectable).
        self._phys = sharding_mod.lane_padded_capacity(capacity, mesh)
        self._per = self._phys // mesh.shape["lanes"]
        states = sharding_mod.lane_put(mesh, state_mod.detector_init(
            cfg, seed=[seed + i for i in range(self._phys)],
            device=mesh.devices[0]))
        vdd = None if self._online else np.full((1,), cfg.vdd, np.float64)
        riders = state_mod.chunk_input_riders(1, vdd, cfg)
        self._shards = [
            _Shard(dev, j * self._per, (j + 1) * self._per, st,
                   tuple(state_mod.upload(
                       np.full((self._per,), r[0], np.float32), dev)
                       for r in riders),
                   sharding_mod.HostStager(dev, depth=self._pipeline_depth))
            for j, (dev, st) in enumerate(zip(mesh.devices, states))]
        # the distinct CUDA devices, for events and copy streams
        self._cuda_devices = tuple(dict.fromkeys(
            d for d in mesh.devices if d.type == "cuda"))
        self._active = np.zeros((self._phys,), bool)
        self._lanes: list[Optional[_Lane]] = [None] * self._phys
        self._staged: dict[int, int] = {}     # lane -> target bucket

        # -- per-bucket runtime: ring-of-rings + executor use --------------
        self._rings: dict[int, tuple] = {}    # live ring, one per shard
        self._spares: dict[int, collections.deque] = {}
        self._inflight: dict[int, int] = {}       # sealed rings being fetched
        self._executed: dict[int, dict] = {}      # slab signatures run
        for b in buckets:
            self._rings[b] = self._make_ring(b)
            self._spares[b] = collections.deque(
                self._make_ring(b) for _ in
                range(ring_depth - 1 if drain_mode == "async" else 0)
            )
            self._inflight[b] = 0
            self._executed[b] = ({"block": set(), "single": set()}
                                 if ring_rounds > 1 else {"block": set()})

        self._metrics = (metrics if metrics is not None
                         else obs_mod.MetricsRegistry(namespace="pool"))
        self._declare_metrics(buckets)
        self._pass_dispatches = 0  # blocks dispatched in the current pass
        self._busy_probe = ()      # CUDA events after the last dispatch
        self._pump_busy = False

        self._reader_exc: Optional[BaseException] = None
        self._sealed_q: Optional[queue.Queue] = None
        self._reader: Optional[threading.Thread] = None
        if drain_mode == "async":
            self._sealed_q = queue.Queue()
            self._reader = threading.Thread(
                target=self._reader_loop, daemon=True,
                name="PoolRuntime-reader",
            )
            self._reader.start()

    # -- metrics ------------------------------------------------------------

    def _declare_metrics(self, buckets: tuple) -> None:
        """Declare every runtime witness on the registry and bind its
        handle(s), as the reference does."""
        reg = self._metrics
        p, bk = POOL_STATS, POOL_BUCKET_STATS

        def ctr(name):
            return reg.counter(name, p[name])

        self._m_host_fetches = ctr("host_fetches")
        self._m_rounds_executed = ctr("rounds_executed")
        self._m_drain_wait = ctr("pump_drain_wait_s")
        self._m_forced_drains = ctr("pump_forced_drains")
        self._m_stages = ctr("pump_stages")
        self._m_stages_overlapped = ctr("pump_stages_overlapped")
        self._m_stage_s = ctr("pump_stage_s")
        self._m_stage_hidden_s = ctr("pump_stage_hidden_s")
        self._m_ctrl_writes = ctr("ctrl_batched_writes")
        self._m_ctrl_coalesced = ctr("ctrl_actions_coalesced")
        self._m_obs_rebuilds = ctr("observation_rebuilds")
        self._m_obs_reuses = ctr("observation_reuses")
        self._m_migrations = ctr("migrations_total")
        # D2H accounting, incremented inside the fetch paths (which run on
        # the reader thread in async mode; registry handles lock
        # themselves).
        self._m_d2h_bytes = ctr("d2h_bytes")
        self._m_d2h_saved = ctr("d2h_bytes_saved")
        self._m_d2h_overflow = ctr("d2h_compact_overflow_slots")

        def per_bucket(metric):
            return {b: metric.labels(bucket=b) for b in buckets}

        lbl = ("bucket",)
        self._m_h2d_slots = per_bucket(
            reg.counter("h2d_event_slots", bk["h2d_event_slots"], lbl))
        self._m_h2d_valid = per_bucket(
            reg.counter("h2d_valid_events", bk["h2d_valid_events"], lbl))
        self._m_ring_count = per_bucket(
            reg.gauge("ring_rounds_buffered", bk["ring_rounds_buffered"],
                      lbl))
        self._m_sealed = per_bucket(
            reg.gauge("ring_sealed_rounds", bk["ring_sealed_rounds"], lbl))
        self._m_dropped_dev = per_bucket(
            reg.counter("dropped_rounds_confirmed",
                        p["dropped_rounds_confirmed"], lbl))
        self._m_dropped_pred = per_bucket(
            reg.gauge("dropped_rounds_predicted",
                      "overflow drops predicted for undrained rounds", lbl))
        self._m_last_drain_wait = per_bucket(
            reg.gauge("last_drain_wait_s",
                      "wall seconds of this bucket's last forced drain",
                      lbl))

    @property
    def metrics(self) -> obs_mod.MetricsRegistry:
        """The pool-scoped metrics registry (attach sinks here)."""
        return self._metrics

    # -- lifecycle ----------------------------------------------------------

    def close(self) -> None:
        """Stop the reader thread (async mode).  Rounds still sealed or
        buffered on device are abandoned — ``flush`` the lanes first if
        their results matter.  Idempotent; the runtime rejects further use.
        """
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if self._reader is not None:
            self._sealed_q.put(_STOP)
            self._reader.join(timeout=30)

    def __del__(self):  # best-effort: don't leak the reader thread
        try:
            self.close()
        except Exception:
            pass

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("DetectorPool is closed")
        if self._reader_exc is not None:
            raise RuntimeError(
                "DetectorPool reader thread failed; results since the last "
                "successful drain are lost and the pool cannot continue"
            ) from self._reader_exc

    # -- executors and rings --------------------------------------------------

    def _make_ring(self, bucket: int) -> tuple:
        """A bucket's ring: one ring per shard, of the shard's lanes (the
        lane axis second), on its device."""
        if self._readout == "compact":
            return tuple(state_mod.compact_ring_init(
                self._ring_rounds, self._per, bucket,
                self._compact_caps[bucket], device=sh.device)
                for sh in self._shards)
        return tuple(state_mod.ring_init(self._ring_rounds, self._per,
                                         bucket, device=sh.device)
                     for sh in self._shards)

    @staticmethod
    def _reset_ring(ring: state_mod.RingState) -> state_mod.RingState:
        """Mark a drained ring (one shard's) empty (count/dropped -> 0)
        without touching its data buffers."""
        ring.count.zero_()
        ring.dropped.zero_()
        return ring

    def _locate(self, lane: int) -> tuple:
        """The shard holding global lane ``lane``, and its index there."""
        sh = self._shards[lane // self._per]
        return sh, lane - sh.lo

    @property
    def _states(self):
        """The lane-stacked state: a ``DetectorState`` on one shard, else
        the tuple of the shards' states in lane order (which
        ``state.state_to_numpy`` and ``state.lane_state`` read)."""
        if len(self._shards) == 1:
            return self._shards[0].state
        return tuple(sh.state for sh in self._shards)

    # -- membership ---------------------------------------------------------

    def connect(self, bucket: int, seed: Optional[int] = None,
                qos: str = "standard") -> int:
        """Claim a free lane in ``bucket`` (a configured chunk-size bucket)
        for a new camera session; returns the lane id.  The lane starts
        from a fresh state at the config's neutral knobs (``detector_init``
        sets its ``ctrl`` entries)."""
        with self._lock:
            self._check_open()
            if bucket not in self._buckets:
                raise ValueError(
                    f"{bucket} is not a configured bucket ({self._buckets})"
                )
            free = np.flatnonzero(~self._active[:self._capacity])
            if not free.size:
                raise RuntimeError(f"pool full ({self._capacity} sessions)")
            lane = int(free[0])
            sh, i = self._locate(lane)
            fresh = state_mod.detector_init(
                self._cfg, seed=self._seed + lane if seed is None else seed,
                device=sh.device)
            sh.state = state_mod.set_lane_state(sh.state, i, fresh)
            self._active[lane] = True
            self._lanes[lane] = _Lane(bucket, qos=str(qos))
            return lane

    def disconnect(self, lane: int) -> dict:
        """Release a lane; returns its final accounting stats.  Undrained
        ring slots referencing the lane are drained first (waiting for the
        reader in async mode), so the stats are complete and a later
        session reusing the slot inherits nothing, a staged migration
        included."""
        with self._lock:
            self._check_open()
            self._check_lane(lane)
            # a pump parked on the spare-ring wait still holds collected
            # rounds for this lane: take the pump token first
            self._acquire_pump()
            try:
                self._check_lane(lane)
                self._staged.pop(lane, None)
                self._drain_bucket(self._lanes[lane].bucket)
                out, dev = self._lane_stats_locked(lane)
                self._active[lane] = False
                self._lanes[lane] = None
            finally:
                self._release_pump()
        return self._finish_stats(out, dev)

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def drain_mode(self) -> str:
        return self._drain_mode

    @property
    def ring_depth(self) -> int:
        return self._ring_depth

    @property
    def active_lanes(self) -> list[int]:
        return [int(i) for i in np.flatnonzero(self._active)]

    @property
    def buckets(self) -> tuple:
        return self._buckets

    @property
    def host_fetches(self) -> int:
        """Blocking result transfers so far (one per ring drain; counted on
        the reader thread in async mode)."""
        return self._m_host_fetches.value()

    @property
    def rounds_executed(self) -> int:
        return self._m_rounds_executed.value()

    def compile_cache_size(self) -> int:
        """Total block shapes run across buckets (see
        ``compile_cache_sizes``); membership churn must not grow it."""
        return sum(n for d in self.compile_cache_sizes().values()
                   for n in d.values())

    def compile_cache_sizes(self) -> dict:
        """Per bucket and block shape, ``{bucket: {"block": n, "single":
        n}}``: the number of distinct shape signatures (shape and dtype of
        every device slab) the executor has run on.  The port compiles
        nothing (its executor is a host loop over the kernels), so this
        counts what a compiled executor would build: the padded K-round
        block, and the 1-round block (present when ``ring_rounds > 1``),
        each 0 until first run and 1 after, unless a slab's shape varies."""
        return {b: {k: len(v) for k, v in d.items()}
                for b, d in self._executed.items()}

    def executors_compiled_once(self) -> bool:
        """The churn witness: every executor (per bucket, per block shape)
        has run on at most one shape signature."""
        return all(n <= 1 for d in self.compile_cache_sizes().values()
                   for n in d.values())

    # -- feeding ------------------------------------------------------------

    def feed(self, lane: int, xy: np.ndarray, ts_us: np.ndarray) -> None:
        """Buffer a slab for one session (any length, time-sorted) and fold
        its timestamps into the lane's host rate-estimator twin.  A
        shedding lane then drops its oldest buffered events down to one
        ring of rounds (the rate twin still counts them, so recovery sees
        the true arrival rate)."""
        with self._lock:
            self._check_open()
            self._check_lane(lane)
            ln = self._lanes[lane]
            xy = np.asarray(xy, np.int32).reshape(-1, 2)
            ts = np.asarray(ts_us, np.int64).reshape(-1)
            if not ts.size:
                return
            if ln.base is None:
                ln.base = streaming_mod.session_base_us(
                    int(ts[0]), self._cfg
                )
            ln.buf_xy = np.concatenate([ln.buf_xy, xy], 0)
            ln.buf_ts = np.concatenate([ln.buf_ts, ts], 0)
            ln.n_events += int(ts.size)
            ln.rate_update(ts, self._half_us)
            ln.gen += 1
            sh, i = self._locate(lane)
            if sh.state.ctrl.shed[i]:
                self._shed_buffer(ln)

    def _shed_buffer(self, ln: _Lane) -> None:
        """Drop-oldest a shedding lane's re-chunk buffer down to one ring
        of rounds (caller holds the lock)."""
        excess = int(ln.buf_ts.size) - self._ring_rounds * ln.bucket
        if excess > 0:
            ln.buf_xy = ln.buf_xy[excess:]
            ln.buf_ts = ln.buf_ts[excess:]
            ln.shed_events += excess
            ln.gen += 1

    def pump_pass(self, order: tuple,
                  max_rounds: Optional[int] = None, decide=None) -> int:
        """One serialized pump pass: apply the staged migrations, run the
        control loop when a policy's ``decide`` is given (its knob writes
        apply to this pass's rounds, its moves stage for the next pass),
        then fold every buffered full chunk through the bucket executors,
        visiting buckets in ``order`` (each pumps until dry or the round
        budget runs out).  Returns rounds executed.
        Results stay in the device rings until ``poll``/``flush`` (or a
        backpressure drain under ``"drain"``).  Blocks are staged and
        dispatched through one stage-ahead deque, flushed before the pass
        returns, so every staged round executes exactly once, in order."""
        with obs_mod.span("pool.pump"), self._lock:
            self._check_open()
            self._acquire_pump()
            try:
                self._apply_staged_locked()
                if decide is not None:
                    actions = decide(self._observation_locked())
                    if actions:
                        self._apply_actions_locked(actions)
                total = 0
                q: collections.deque = collections.deque()
                self._pass_dispatches = 0
                try:
                    for bucket in order:
                        left = (None if max_rounds is None
                                else max_rounds - total)
                        if left is not None and left <= 0:
                            break
                        total += self._pump_bucket(bucket, q,
                                                   max_rounds=left)
                finally:
                    self._flush_pipeline(q)
                return total
            finally:
                self._release_pump()

    def flush(self, lane: int, order: tuple) -> tuple[np.ndarray, np.ndarray]:
        """Apply the staged migrations, drain the lane's full chunks, then
        its padded partial tail, and return everything not yet polled."""
        with obs_mod.span("pool.flush"), self._lock:
            self._check_open()
            self._check_lane(lane)
            self._acquire_pump()
            try:
                self._check_lane(lane)
                self._apply_staged_locked()
                q: collections.deque = collections.deque()
                self._pass_dispatches = 0
                try:
                    for bucket in order:
                        self._pump_bucket(bucket, q)   # until dry
                    ln = self._lanes[lane]
                    if ln.buf_ts.size:
                        self._pump_bucket(ln.bucket, q, max_rounds=1,
                                          flush_lane=lane)
                finally:
                    self._flush_pipeline(q)
            finally:
                self._release_pump()
            return self.poll(lane)

    def _acquire_pump(self) -> None:
        """Take the pump token (caller holds the lock)."""
        while self._pump_busy:
            self._check_open()
            self._cv.wait()
        self._pump_busy = True

    def _release_pump(self) -> None:
        self._pump_busy = False
        self._cv.notify_all()

    def poll(self, lane: int, *,
             wait: bool = True) -> tuple[np.ndarray, np.ndarray]:
        """Drain the lane's accumulated (scores, kept), in stream order.

        Sync mode fetches the lane's bucket ring inline, in one transfer;
        async mode seals it to the reader and, with ``wait=True``, waits
        until the reader has distributed it.  ``wait=False`` never waits
        on a transfer: it returns what earlier drains already delivered.
        Rounds lost under ``on_overflow="drop_oldest"`` are absent here
        and counted in ``stats()['ring_dropped_rounds']``."""
        with obs_mod.span("pool.poll"), self._lock:
            self._check_open()
            self._check_lane(lane)
            bucket = self._lanes[lane].bucket
            self._drain_bucket(bucket, wait=wait, block=wait)
            self._check_lane(lane)
            ln = self._lanes[lane]
            if not ln.results:
                return (np.zeros((0,), np.float32), np.zeros((0,), bool))
            scores = np.concatenate(
                [r[0] for r in ln.results]
            ).astype(np.float32)
            kept = np.concatenate([r[1] for r in ln.results]).astype(bool)
            ln.results.clear()
            return scores, kept

    # -- migration ------------------------------------------------------------

    def stage_migration(self, lane: int, new_bucket: int) -> None:
        """Stage a live move of ``lane`` to ``new_bucket``: seal and drain
        the lane's bucket (every round it executed reaches its result
        queue, in order) and record the target.  The move applies at the
        start of the next pump pass or flush, both of which apply before
        they collect a round, under the pump token.  Re-staging a lane
        replaces its pending move; staging its current bucket cancels it.
        """
        with self._lock:
            self._check_open()
            self._check_lane(lane)
            if new_bucket not in self._buckets:
                raise ValueError(
                    f"{new_bucket} is not a configured bucket "
                    f"({self._buckets})"
                )
            ln = self._lanes[lane]
            if new_bucket == ln.bucket:
                self._staged.pop(lane, None)
                return
            self._acquire_pump()
            try:
                # The token wait released the lock: if the lane was retired
                # meanwhile (its slot perhaps reused), the decision belonged
                # to the old session and is dropped.
                if self._lanes[lane] is not ln or not self._active[lane]:
                    return
                self._stage_locked(lane, new_bucket)
            finally:
                self._release_pump()

    def _stage_locked(self, lane: int, new_bucket: int) -> None:
        """The stage body (caller holds the lock and the pump token, from
        ``stage_migration`` or from a pass actuating a migrate action; the
        token is not re-entrant): drain the lane's bucket and record the
        target, or cancel when the lane already sits there (a pass may
        have applied a move during the token wait)."""
        ln = self._lanes[lane]
        if new_bucket == ln.bucket:
            self._staged.pop(lane, None)
            return
        with obs_mod.span("pool.migrate"):
            self._drain_bucket(ln.bucket)
            self._staged[lane] = new_bucket

    def staged_migrations(self) -> dict:
        """Pending (staged, not yet applied) moves: ``{lane: bucket}``."""
        with self._lock:
            return dict(self._staged)

    def _apply_staged_locked(self) -> None:
        """Move every staged lane to its target bucket (caller holds the
        lock and the pump token, before any round is collected).  The
        lane's state stays in place; the old bucket is drained once more
        so its results stay in stream order."""
        for lane in sorted(self._staged):
            new_bucket = self._staged.pop(lane)
            ln = self._lanes[lane]
            if ln is None or not self._active[lane]:
                continue                      # retired between stage and apply
            with obs_mod.span("pool.migrate"):
                old = ln.bucket
                self._drain_bucket(old)
                ln.bucket = new_bucket
                ln.gen += 1
                ln.migrations += 1
                ln.migration_log.append((ln.events_folded, old, new_bucket))
                self._m_migrations.inc()

    # -- knob writes ----------------------------------------------------------

    def set_lane_control(self, lane: int, *,
                         lut_every: Optional[int] = None,
                         vdd_cap: Optional[int] = None,
                         shed: Optional[bool] = None) -> None:
        """Set a lane's degradation knobs under the pump token, so a write
        cannot fall between a pass's rounds: the out-of-band spelling of a
        knob ``Action``.  ``lut_every`` is clamped to >= 1 and ``vdd_cap``
        to ``[0, vdd_top]``; unset knobs keep their value.  Entering
        ``shed`` drops the oldest buffered events down to one ring of
        rounds at once.  The ``ctrl`` leaves are replaced by new arrays,
        so a ``ctrl`` read earlier keeps its values."""
        with self._lock:
            self._check_open()
            self._check_lane(lane)
            self._acquire_pump()
            try:
                self._check_lane(lane)    # re-validate after the token wait
                want = self._knob_want(lane, lut_every, vdd_cap, shed)
                if want is not None:
                    self._write_knobs_locked([(lane, want)])
            finally:
                self._release_pump()

    def _knob_want(self, lane: int, lut_every: Optional[int],
                   vdd_cap: Optional[int],
                   shed: Optional[bool]) -> Optional[tuple]:
        """A knob request clamped against the lane's ``ctrl`` entries (the
        only copy of its knobs); ``None`` when it would change nothing."""
        sh, i = self._locate(lane)
        c = sh.state.ctrl
        cur = (int(c.lut_every[i]), int(c.vdd_cap[i]), bool(c.shed[i]))
        want = (
            cur[0] if lut_every is None else max(1, int(lut_every)),
            cur[1] if vdd_cap is None
            else max(0, min(int(vdd_cap), self._vdd_top)),
            cur[2] if shed is None else bool(shed),
        )
        return None if want == cur else want

    def _write_knobs_locked(self, writes: list) -> None:
        """Write ``[(lane, (lut_every, vdd_cap, shed)), ...]`` as one
        replacement of the three ``ctrl`` leaves of each shard written
        (caller holds the lock and the pump token); later writes to a lane
        win.  A pass's writes of more than one lane count as one coalesced
        write, as the reference's batched update does.  A lane entering
        ``shed`` drops its oldest buffered events at once."""
        shed_now, leaves = {}, {}
        for lane, want in writes:
            sh, i = self._locate(lane)
            shed_now[lane] = bool(sh.state.ctrl.shed[i])
            if sh not in leaves:
                leaves[sh] = [leaf.copy() for leaf in sh.state.ctrl]
            for leaf, value in zip(leaves[sh], want):
                leaf[i] = value
        for sh, new in leaves.items():
            sh.state = sh.state._replace(ctrl=state_mod.ControlState(*new))
        if len(writes) > 1:
            self._m_ctrl_writes.inc()
            self._m_ctrl_coalesced.inc(len(writes))
        for lane, want in writes:
            if want[2] and not shed_now[lane]:
                self._shed_buffer(self._lanes[lane])
            shed_now[lane] = want[2]

    # -- control loop: observe -> decide -> actuate ---------------------------

    def _observation_locked(self) -> scheduler_mod.Observation:
        """The per-pump ``Observation`` (caller holds the lock and the pump
        token, the staged moves applied).  Host data only: observing reads
        nothing from the device.  A lane whose generation has not moved
        since its last observation is served from its cache."""
        lanes = []
        backlog = {b: 0 for b in self._buckets}
        for lane in self.active_lanes:
            ln = self._lanes[lane]
            cached = ln.obs_cache
            if cached is not None and cached[0] == ln.gen:
                lob = cached[1]
                self._m_obs_reuses.inc()
            else:
                eps = state_mod.rate_estimate_eps(
                    ln.r_p1, ln.r_p2, self._cfg.dvfs_cfg
                )
                lob = scheduler_mod.LaneObservation(
                    lane=lane,
                    bucket=ln.bucket,
                    qos=ln.qos,
                    tier=ln.tier,
                    events_per_halfwin=eps * self._half_us * 1e-6,
                    backlog_rounds=int(ln.buf_ts.size) // ln.bucket,
                    win=ln.r_win,
                )
                ln.obs_cache = (ln.gen, lob)
                self._m_obs_rebuilds.inc()
            backlog[lob.bucket] += lob.backlog_rounds
            lanes.append(lob)
        h2d_slots = sum(h.value() for h in self._m_h2d_slots.values())
        h2d_valid = sum(h.value() for h in self._m_h2d_valid.values())
        return scheduler_mod.Observation(
            lanes=tuple(lanes),
            backlog_rounds=backlog,
            reader_lag_rounds={b: self._m_sealed[b].value()
                               for b in self._buckets},
            drain_wait_s=float(self._m_drain_wait.value()),
            last_drain_wait_s={b: float(self._m_last_drain_wait[b].value())
                               for b in self._buckets},
            padding_ratio=(
                1.0 - h2d_valid / h2d_slots if h2d_slots else 0.0
            ),
            h2d_event_slots=h2d_slots,
            h2d_valid_events=h2d_valid,
            h2d_padding_bytes=(h2d_slots - h2d_valid) * EVENT_SLOT_BYTES,
            h2d_by_bucket={
                b: {"slots": self._m_h2d_slots[b].value(),
                    "valid": self._m_h2d_valid[b].value()}
                for b in self._buckets
            },
            phys=self._phys,
            ring_rounds=self._ring_rounds,
        )

    def _apply_actions_locked(self, actions) -> None:
        """Actuate a policy's decisions (caller holds the lock and the pump
        token).  ``drop_policy`` flips now; actions for lanes retired since
        the observation are dropped (the decision belonged to the dead
        session).  Every knob write of the pass lands first, in one
        replacement of the ``ctrl`` leaves, so a lane that also moves has
        its new knobs before the move is staged; then tiers are mirrored
        and moves staged, to apply at the next pass."""
        writes = []
        for act in actions:
            if act.drop_policy is not None:
                if act.drop_policy not in _OVERFLOW_POLICIES:
                    raise ValueError(
                        f"drop_policy must be one of {_OVERFLOW_POLICIES}, "
                        f"got {act.drop_policy!r}"
                    )
                self._overflow = act.drop_policy
            if not self._live(act.lane):
                continue
            want = self._knob_want(act.lane, act.lut_every, act.vdd_cap,
                                   act.shed)
            if want is not None:
                writes.append((act.lane, want))
        if writes:
            self._write_knobs_locked(writes)
        for act in actions:
            if not self._live(act.lane):
                continue
            ln = self._lanes[act.lane]
            if act.tier is not None and int(act.tier) != ln.tier:
                ln.tier = int(act.tier)
                ln.gen += 1
            if act.migrate is not None:
                if act.migrate not in self._buckets:
                    raise ValueError(
                        f"{act.migrate} is not a configured bucket "
                        f"({self._buckets})"
                    )
                self._stage_locked(act.lane, act.migrate)

    def _live(self, lane: Optional[int]) -> bool:
        """Whether an action's lane is an active session."""
        return (lane is not None and 0 <= lane < self._capacity
                and bool(self._active[lane]))

    @property
    def vdd_top(self) -> int:
        """Highest DVFS operating-point index a knob may select (0 in
        fixed-Vdd mode, where the cap is inert)."""
        return self._vdd_top

    # -- observability -------------------------------------------------------

    def lane_halfwin_rate(self, lane: int) -> float:
        """Observed events per DVFS half-window for one lane, from the host
        rate twin (no device sync): the adaptive policy's migration
        metric."""
        with self._lock:
            self._check_lane(lane)
            ln = self._lanes[lane]
            eps = state_mod.rate_estimate_eps(
                ln.r_p1, ln.r_p2, self._cfg.dvfs_cfg
            )
            return eps * self._half_us * 1e-6

    def bucket_backlog_rounds(self) -> dict:
        """Ready but unpumped rounds per bucket (full chunks waiting in the
        lanes' re-chunk buffers): the adaptive pump order's input."""
        with self._lock:
            out = {b: 0 for b in self._buckets}
            for lane in self.active_lanes:
                ln = self._lanes[lane]
                out[ln.bucket] += int(ln.buf_ts.size) // ln.bucket
            return out

    def stats(self, lane: int) -> dict:
        """Lane accounting: host float64 books (drained rounds only) plus
        the lane's on-device accumulators (always complete), ring occupancy
        of its bucket, and its rate view (``events_per_s_est`` from the
        host twin, ``device_events_per_s_est`` from the in-state estimator,
        which integrates only in online-DVFS mode)."""
        with self._lock:
            self._check_open()
            self._check_lane(lane)
            out, dev = self._lane_stats_locked(lane)
        return self._finish_stats(out, dev)

    def _lane_stats_locked(self, lane: int):
        """Host stats dict plus copies of the lane's device scalars (caller
        holds the lock; the copies are enqueued now and fetched after the
        lock is released, so no transfer runs under it)."""
        ln = self._lanes[lane]
        n_scored = max(ln.kept_total, 1)
        sh, i = self._locate(lane)
        s = sh.state
        dev = tuple(t[i].clone() for t in (
            s.kept_total, s.energy_pj, s.latency_ns, s.rate.prev1,
            s.rate.prev2))
        b = ln.bucket
        out = {
            "lane": lane,
            "bucket": b,
            "n_events": ln.n_events,
            "n_chunks": ln.n_chunks,
            "kept_total": ln.kept_total,
            "energy_pj": ln.energy_pj,
            "latency_ns_per_event": ln.latency_ns / n_scored,
            "buffered": int(ln.buf_ts.size),
            "events_per_s_est": state_mod.rate_estimate_eps(
                ln.r_p1, ln.r_p2, self._cfg.dvfs_cfg
            ),
            "migrations": ln.migrations,
            "migration_log": list(ln.migration_log),
            "migration_staged": lane in self._staged,
            "ring_capacity": self._ring_rounds,
            "ring_rounds_buffered": self._m_ring_count[b].value(),
            "ring_sealed_rounds": self._m_sealed[b].value(),
            "ring_dropped_rounds": (
                self._m_dropped_dev[b].value()
                + self._m_dropped_pred[b].value()
            ),
            "backlog_rounds": int(ln.buf_ts.size) // b,
            "reader_lag_rounds": self._m_sealed[b].value(),
            "last_drain_wait_s": float(self._m_last_drain_wait[b].value()),
            "qos": ln.qos,
            "ladder_tier": ln.tier,
            "ctrl_lut_every": int(s.ctrl.lut_every[i]),
            "ctrl_vdd_cap": int(s.ctrl.vdd_cap[i]),
            "ctrl_shed": bool(s.ctrl.shed[i]),
            "shed_events": ln.shed_events,
        }
        return out, dev

    def _finish_stats(self, out: dict, dev) -> dict:
        dev_kept, dev_energy, dev_latency, dev_p1, dev_p2 = \
            pipeline_mod._fetch(*dev)
        out["device_kept_total"] = int(dev_kept)
        out["device_energy_pj"] = float(dev_energy)
        out["device_latency_ns"] = float(dev_latency)
        out["device_events_per_s_est"] = state_mod.rate_estimate_eps(
            dev_p1, dev_p2, self._cfg.dvfs_cfg
        )
        return out

    def pool_stats(self) -> dict:
        """Pool-level runtime counters (no device sync); the same keys as
        the reference's.  ``h2d_event_slots`` / ``h2d_padding_bytes`` count
        the slabs this pool uploaded (``phys`` lanes wide, the padding
        lanes of a lane mesh included), ``d2h_bytes`` the bytes its drains
        fetched.  Every shard stages each block's arrays through its own
        stager, so ``h2d_staged_uploads`` counts a block's arrays once,
        whatever the mesh width."""
        with self._lock:
            self._check_open()
            exe = self.compile_cache_sizes()
            h2d_slots = sum(h.value() for h in self._m_h2d_slots.values())
            h2d_valid = sum(h.value() for h in self._m_h2d_valid.values())
            stages = self._m_stages.value()
            overlapped = self._m_stages_overlapped.value()
            dropped_pred = sum(h.value()
                               for h in self._m_dropped_pred.values())
            dropped_dev = sum(h.value()
                              for h in self._m_dropped_dev.values())
            return {
                "capacity": self._capacity,
                "active": len(self.active_lanes),
                "sharded": self._mesh is not None,
                "devices": (self._mesh.shape["lanes"]
                            if self._mesh is not None else 1),
                "ring_rounds": self._ring_rounds,
                "ring_depth": self._ring_depth,
                "pipeline_depth": self._pipeline_depth,
                "on_overflow": self._overflow,
                "drain_mode": self._drain_mode,
                "readout": self._readout,
                "host_fetches": self._m_host_fetches.value(),
                "rounds_executed": self._m_rounds_executed.value(),
                "pump_drain_wait_s": float(self._m_drain_wait.value()),
                "pump_forced_drains": self._m_forced_drains.value(),
                "pump_stages": stages,
                "pump_stages_overlapped": overlapped,
                "pump_stage_overlap_ratio": (
                    overlapped / stages if stages else 0.0
                ),
                "pump_stage_s": float(self._m_stage_s.value()),
                "pump_stage_hidden_s": float(self._m_stage_hidden_s.value()),
                "ctrl_batched_writes": self._m_ctrl_writes.value(),
                "ctrl_actions_coalesced": self._m_ctrl_coalesced.value(),
                "observation_rebuilds": self._m_obs_rebuilds.value(),
                "observation_reuses": self._m_obs_reuses.value(),
                "reader_lag_rounds": sum(
                    h.value() for h in self._m_sealed.values()
                ),
                "migrations_total": self._m_migrations.value(),
                "migrations_staged": len(self._staged),
                "h2d_event_slots": h2d_slots,
                "h2d_valid_events": h2d_valid,
                "h2d_pinned_staging": self._shards[0].stager.pinned,
                "h2d_staged_uploads": self._shards[0].stager.uploads,
                "h2d_padding_bytes": (
                    (h2d_slots - h2d_valid) * EVENT_SLOT_BYTES
                ),
                "d2h_bytes": self._m_d2h_bytes.value(),
                "d2h_bytes_saved": self._m_d2h_saved.value(),
                "d2h_compact_overflow_slots": self._m_d2h_overflow.value(),
                "dropped_rounds_total": dropped_dev + dropped_pred,
                "dropped_rounds_confirmed": dropped_dev,
                "shed_events_total": sum(
                    ln.shed_events for ln in self._lanes if ln is not None
                ),
                "buckets": {
                    b: {
                        "lanes": sum(
                            1 for ln in self._lanes
                            if ln is not None and ln.bucket == b
                        ),
                        "events_per_s_est": sum(
                            state_mod.rate_estimate_eps(
                                ln.r_p1, ln.r_p2, self._cfg.dvfs_cfg
                            )
                            for ln in self._lanes
                            if ln is not None and ln.bucket == b
                        ),
                        "ring_rounds_buffered":
                            self._m_ring_count[b].value(),
                        "ring_sealed_rounds": self._m_sealed[b].value(),
                        "ring_dropped_rounds": (
                            self._m_dropped_dev[b].value()
                            + self._m_dropped_pred[b].value()
                        ),
                        "h2d_event_slots": self._m_h2d_slots[b].value(),
                        "h2d_valid_events": self._m_h2d_valid[b].value(),
                        "executables": exe[b],
                    }
                    for b in self._buckets
                },
            }

    # -- internals ----------------------------------------------------------

    def _check_lane(self, lane: int) -> None:
        if not (0 <= lane < self._capacity) or not self._active[lane]:
            raise KeyError(f"lane {lane} is not an active session")

    def _pump_bucket(self, bucket: int, q: collections.deque,
                     max_rounds: Optional[int] = None,
                     flush_lane: Optional[int] = None) -> int:
        """Run this bucket's ready rounds, ``ring_rounds`` per block,
        cutting a block early when a lane needs a timebase rebase.  A
        completed block is staged at once and dispatched once the deque
        holds ``pipeline_depth`` blocks; a rebase writes the state, so it
        applies only with nothing staged ahead (the deque is flushed
        first)."""
        executed = 0
        while True:
            pending: list[_Round] = []
            stop = False
            while len(pending) < self._ring_rounds:
                if max_rounds is not None and \
                        executed + len(pending) >= max_rounds:
                    stop = True
                    break
                rnd = self._collect_round(
                    bucket, flush_lane,
                    allow_rebase=not pending and not q,
                )
                if rnd == "rebase":
                    if not pending and q:
                        self._flush_pipeline(q)
                        continue
                    break          # cut the block; rebase opens the next one
                if rnd is None:
                    stop = True
                    break
                pending.append(rnd)
            if pending:
                q.append(self._stage_block(bucket, pending,
                                           stage_ahead=bool(q)))
                while len(q) >= self._pipeline_depth:
                    self._dispatch_block(q.popleft())
                executed += len(pending)
            if stop or not pending:
                break
        return executed

    def _flush_pipeline(self, q: collections.deque) -> None:
        """Dispatch every staged-ahead block, in stage order."""
        while q:
            self._dispatch_block(q.popleft())

    def _collect_round(self, bucket: int, flush_lane: Optional[int],
                       allow_rebase: bool):
        """Pop one round's worth of chunks from this bucket's lane buffers.

        Returns a ``_Round``, ``None`` (nothing ready), or ``"rebase"`` (a
        lane needs a timebase hop first but the current block already holds
        rounds, which must run before the hop)."""
        ready: list[tuple[int, int]] = []
        for lane in self.active_lanes:
            ln = self._lanes[lane]
            if ln.bucket != bucket:
                continue
            if ln.buf_ts.size >= bucket:
                ready.append((lane, bucket))
            elif lane == flush_lane and ln.buf_ts.size:
                ready.append((lane, int(ln.buf_ts.size)))
        if not ready:
            return None

        with obs_mod.span("pool.collect"):
            hops_needed = []
            for lane, n in ready:
                ln = self._lanes[lane]
                new_base, hops = streaming_mod.plan_rebase(
                    ln.base, ln.buf_ts[:n], self._cfg
                )
                if hops:
                    hops_needed.append((lane, new_base, hops))
            if hops_needed and not allow_rebase:
                return "rebase"
            for lane, new_base, hops in hops_needed:
                self._lanes[lane].base = new_base
                sh, i = self._locate(lane)
                one = state_mod.lane_state(sh.state, i)
                for hop in hops:
                    one = streaming_mod.shift_state_base(one, hop,
                                                         self._half_us)
                sh.state = state_mod.set_lane_state(sh.state, i, one)

            xy = np.zeros((self._phys, bucket, 2), np.int32)
            ts = np.zeros((self._phys, bucket), np.int32)
            valid = np.zeros((self._phys, bucket), bool)
            mask = np.zeros((self._phys,), bool)
            n_valid = np.zeros((self._phys,), np.int32)
            for lane, n in ready:
                ln = self._lanes[lane]
                xy[lane, :n] = ln.buf_xy[:n]
                ts64 = np.full((bucket,),
                               ln.buf_ts[min(n, ln.buf_ts.size) - 1],
                               np.int64)
                ts64[:n] = ln.buf_ts[:n]
                ts[lane] = (ts64 - ln.base).astype(np.int32)
                valid[lane, :n] = True
                mask[lane] = True
                n_valid[lane] = n
                ln.buf_xy = ln.buf_xy[n:]
                ln.buf_ts = ln.buf_ts[n:]
                ln.events_folded += n
                ln.gen += 1
            return _Round(xy, ts, valid, mask, n_valid)

    def _stage_block(self, bucket: int, rounds: list, *,
                     stage_ahead: bool = False) -> _StagedBlock:
        """The stage half: gather a block's rounds into host slabs and
        start their upload through the pinned stager.  One round uploads
        ``(lanes, chunk)`` slabs (mask and counts ride in the same slab);
        more upload the padded ``(ring_rounds, lanes, chunk)`` block, with
        mask and counts as small uploads of their own.  Each shard's slice
        of the lanes goes through that shard's stager to its device.  The
        uploads are accounted here; rings and state are not touched."""
        k = self._ring_rounds
        n = len(rounds)
        with obs_mod.span("pool.stage", timed=True) as sp:
            masks = [r.mask for r in rounds]
            if n == 1 and k > 1:
                rnd = rounds[0]
                parts = [sh.stager.put(*(a[sh.lo:sh.hi] for a in (
                    rnd.xy, rnd.ts, rnd.valid, rnd.mask, rnd.n_valid)))
                    for sh in self._shards]
                blk = _StagedBlock(bucket, 1, True, parts, masks)
                self._m_h2d_slots[bucket].inc(self._phys * bucket)
            else:
                xy = np.zeros((k, self._phys, bucket, 2), np.int32)
                ts = np.zeros((k, self._phys, bucket), np.int32)
                valid = np.zeros((k, self._phys, bucket), bool)
                mask = np.zeros((k, self._phys), bool)
                n_valid = np.zeros((k, self._phys), np.int32)
                for i, rnd in enumerate(rounds):
                    xy[i], ts[i], valid[i] = rnd.xy, rnd.ts, rnd.valid
                    mask[i], n_valid[i] = rnd.mask, rnd.n_valid
                parts = []
                for sh in self._shards:
                    lanes = slice(sh.lo, sh.hi)
                    parts.append((
                        *sh.stager.put(xy[:, lanes], ts[:, lanes],
                                       valid[:, lanes]),
                        state_mod.upload(mask[:, lanes], sh.device),
                        state_mod.upload(n_valid[:, lanes], sh.device)))
                blk = _StagedBlock(bucket, n, False, parts, masks)
                self._m_h2d_slots[bucket].inc(k * self._phys * bucket)
            self._m_h2d_valid[bucket].inc(
                int(sum(int(r.n_valid.sum()) for r in rounds)))
        dt = sp.seconds
        self._m_stages.inc()
        self._m_stage_s.inc(dt)
        if stage_ahead and self._pass_dispatches > 0:
            # this stage began with an earlier block staged-but-undispatched
            # and a block of this pass already dispatched: the gather and
            # upload ran ahead of the dispatch point
            self._m_stages_overlapped.inc()
            if not all(ev.query() for ev in self._busy_probe):
                self._m_stage_hidden_s.inc(dt)
        return blk

    def _dispatch_block(self, blk: _StagedBlock) -> None:
        """The dispatch half: make ring room (``"drain"`` policy) and run
        the block's rounds: for each, on every shard, the lane-batched step
        (K1, K2 where due), the masked select, and the ring push (K3, which
        also ranks a compact ring's records).  The executed-slab witness
        counts one signature per block, however many shards it spans."""
        with obs_mod.span("pool.dispatch"):
            bucket, k, n = blk.bucket, self._ring_rounds, blk.n
            if self._overflow == "drain" and \
                    self._m_ring_count[bucket].value() + n > k:
                with obs_mod.span("pool.forced_drain", timed=True) as sp:
                    self._drain_bucket(bucket, wait=False)
                self._m_drain_wait.inc(sp.seconds)
                self._m_last_drain_wait[bucket].set(sp.seconds)
                self._m_forced_drains.inc()

            tcfg = self._tcfg[bucket]
            rings = self._rings[bucket]
            for i in range(n):
                for j, sh in enumerate(self._shards):
                    xy, ts, valid, mask, n_valid = blk.round(i, j)
                    chunk = state_mod.ChunkInput(xy, ts, valid, *sh.riders)
                    with obs_mod.span("pool.step"):
                        sh.state, outs = state_mod.detector_step_(
                            tcfg, sh.state, chunk,
                            mask=blk.masks[i][sh.lo:sh.hi])
                    with obs_mod.span("pool.push"):
                        state_mod.ring_push(rings[j], outs, mask, n_valid)
            self._executed[bucket]["single" if blk.single else "block"].add(
                tuple((tuple(t.shape), t.dtype) for part in blk.parts
                      for t in part))
            c = self._m_ring_count[bucket].value()
            self._m_ring_count[bucket].set(min(c + n, k))
            self._m_dropped_pred[bucket].add(max(0, c + n - k))
            self._m_rounds_executed.inc(n)
            self._pass_dispatches += 1
            self._busy_probe = tuple(_record_event(d)
                                     for d in self._cuda_devices)

    # -- draining: sync (inline fetch) and async (seal to the reader) -------

    def _drain_bucket(self, bucket: int, *, wait: bool = True,
                      block: bool = True) -> None:
        """Get this bucket's buffered rounds on their way to the host: sync
        mode fetches inline; async mode seals the live ring to the reader
        and, with ``wait=True``, waits until everything sealed for this
        bucket is distributed.  ``block=False`` skips the inline fetch
        (sync) or a seal that would wait for a spare ring (async)."""
        if self._drain_mode == "sync":
            if block:
                self._drain_ring(bucket)
        else:
            self._seal_ring(bucket, block=block)
            if wait:
                self._wait_bucket_drained(bucket)

    def _drain_ring(self, bucket: int) -> None:
        """Sync mode: fetch the live ring on the calling thread (one
        transfer per shard), then distribute and mark the ring empty."""
        if self._m_ring_count[bucket].value() == 0:
            return
        host = self._fetch_ring(self._rings[bucket])
        self._m_host_fetches.inc()
        self._distribute(bucket, host)
        self._m_ring_count[bucket].set(0)
        for ring in self._rings[bucket]:
            self._reset_ring(ring)

    def _seal_ring(self, bucket: int, *, block: bool = True) -> None:
        """Async mode's swap point (caller holds the lock): install a spare
        as the live ring and hand the sealed one, with an event recorded
        after its last push on each CUDA device, to the reader.  With every
        spare still in the reader's hands this waits (releasing the lock),
        or with ``block=False`` returns."""
        if self._m_ring_count[bucket].value() == 0:
            return
        with obs_mod.span("pool.seal"):
            while not self._spares[bucket]:
                if not block:
                    return
                self._check_open()
                self._cv.wait()
                if self._m_ring_count[bucket].value() == 0:
                    return
            sealed = self._rings[bucket]
            done = {d: _record_event(d) for d in self._cuda_devices}
            self._rings[bucket] = self._spares[bucket].popleft()
            self._m_sealed[bucket].add(self._m_ring_count[bucket].value())
            self._inflight[bucket] += 1
            self._m_ring_count[bucket].set(0)
            self._sealed_q.put((bucket, sealed, done))

    def _wait_bucket_drained(self, bucket: int) -> None:
        """Block (releasing the lock) until the reader has fetched and
        distributed every ring sealed for this bucket."""
        if self._inflight[bucket] == 0:
            return
        with obs_mod.span("pool.poll_wait"):
            while self._inflight[bucket] > 0:
                self._check_open()
                self._cv.wait()

    def _fetch_ring(self, rings: tuple, streams: Optional[dict] = None,
                    done: Optional[dict] = None) -> state_mod.RingState:
        """The transfer both drain modes funnel through: one per shard, on
        the current stream, or with ``streams`` (the reader's, with no lock
        held) on the copy stream of the shard's device after the pump's
        event, which then also resets the shard's ring.  The cursors come
        from the first shard (every shard pushes every round, so theirs
        agree).  Returns a dense host ``RingState`` with the lanes in
        global order: compact rings are densified shard by shard, so an
        overflow row keeps its lane."""
        parts, cursors = [], None
        fetched = dense_eq = 0
        for ring in rings:
            if streams is None:
                part = self._fetch_shard(ring, cursors)
            else:
                dev = ring.head.device
                stream = streams[dev]
                with torch.cuda.stream(stream):
                    stream.wait_event(done[dev])
                    part = self._fetch_shard(ring, cursors)
                    self._reset_ring(ring)
                    stream.synchronize()
            host, cursors, nbytes, eq = part
            parts.append(host)
            fetched += nbytes
            dense_eq += eq
        self._m_d2h_bytes.inc(fetched)
        self._m_d2h_saved.inc(max(0, dense_eq - fetched))
        return sharding_mod._lane_gather(parts, lane_axis=1)

    def _fetch_shard(self, ring, cursors: Optional[tuple]):
        """One shard's ring on the host, in one transfer: ``(host
        RingState, cursors, bytes fetched, bytes of the dense readout)``.
        The ring's ``(head, count, dropped)`` are fetched with it unless
        ``cursors`` (the first shard's) are given."""
        own = () if cursors is not None else (ring.head, ring.count,
                                              ring.dropped)
        if self._readout == "compact":
            return self._fetch_compact(ring, own, cursors)
        lanes = (ring.scores, ring.keep, ring.n_kept, ring.vdd_idx,
                 ring.n_valid, ring.mask)
        got = pipeline_mod._fetch(*lanes, *own)
        cursors = tuple(got[6:]) if own else cursors
        nbytes = obs_mod.leaves_nbytes(*lanes, *own)
        return (state_mod.RingState(*got[:6], *cursors), cursors, nbytes,
                nbytes)

    def _fetch_compact(self, ring: state_mod.CompactRingState, own: tuple,
                       cursors: Optional[tuple]):
        """Compact readout of one shard: fetch the records plus the cursors
        ``own`` in one transfer (``vdd_idx`` only when DVFS is online —
        fixed-Vdd books never read it), gather the dense rows of the
        slot-lanes whose kept count overflowed the records into one second
        transfer, and scatter back to a dense host ``RingState``.

        The densify is exact: the step scores every event that was not
        kept exactly ``-inf`` with ``keep=False``, the fill value, so
        scattering the ``n_kept`` records reproduces the dense row."""
        rounds, lanes, chunk = ring.scores.shape
        cap = ring.c_idx.shape[2]
        leaves = [ring.c_idx, ring.c_val, ring.n_kept, ring.n_valid,
                  ring.mask, *own]
        if self._online:
            leaves.append(ring.vdd_idx)
        c_idx, c_val, n_kept, n_valid, mask, *rest = \
            pipeline_mod._fetch(*leaves)
        if own:
            cursors, rest = tuple(rest[:3]), rest[3:]
        head, count, dropped = cursors
        vdd_idx = rest[0] if rest else np.zeros((rounds, lanes), np.int32)
        fetched = obs_mod.leaves_nbytes(*leaves)

        # Only undrained slots: recycled rings reset just their cursors, so
        # stale slots can still look masked.
        live = state_mod.ring_slot_order(int(head), int(count), rounds)
        rows = [
            (slot, int(lane))
            for slot in live
            for lane in np.flatnonzero(mask[slot] & (n_kept[slot] > cap))
        ]
        if rows:
            dev = ring.scores.device
            si = state_mod.upload(np.array([r[0] for r in rows]), dev)
            li = state_mod.upload(np.array([r[1] for r in rows]), dev)
            over = (ring.scores[si, li], ring.keep[si, li])
            over_s, over_k = pipeline_mod._fetch(*over)
            fetched += obs_mod.leaves_nbytes(*over)
            self._m_d2h_overflow.inc(len(rows))

        scores = np.full((rounds, lanes, chunk), -np.inf, np.float32)
        keep = np.zeros((rounds, lanes, chunk), bool)
        for slot in live:
            for lane in np.flatnonzero(mask[slot]):
                nk = int(n_kept[slot, lane])
                if nk > cap:
                    continue  # filled from the overflow rows below
                idx = c_idx[slot, lane, :nk]
                scores[slot, lane, idx] = c_val[slot, lane, :nk]
                keep[slot, lane, idx] = True
        for j, (slot, lane) in enumerate(rows):
            scores[slot, lane] = over_s[j]
            keep[slot, lane] = over_k[j]

        dense_eq = obs_mod.leaves_nbytes(
            ring.scores, ring.keep, ring.n_kept, ring.vdd_idx,
            ring.n_valid, ring.mask, *own)
        host = state_mod.RingState(
            scores=scores, keep=keep, n_kept=n_kept, vdd_idx=vdd_idx,
            n_valid=n_valid, mask=mask, head=head, count=count,
            dropped=dropped,
        )
        return host, cursors, fetched, dense_eq

    def _reader_loop(self) -> None:
        """Async drain: fetch sealed rings FIFO on the reader's own CUDA
        stream per device after the pump's event, then distribute under
        the lock and return the ring to the spares (its copy is finished:
        the fetch synchronised the streams).  Any exception is stored and
        re-raised to the next public API caller."""
        streams = ({d: torch.cuda.Stream(d) for d in self._cuda_devices}
                   if self._cuda_devices else None)
        while True:
            item = self._sealed_q.get()
            if item is _STOP:
                return
            bucket, sealed, done = item
            try:
                host = self._fetch_ring(sealed, streams, done)
            except BaseException as e:
                with self._cv:
                    self._reader_exc = e
                    self._cv.notify_all()
                return
            with self._cv:
                try:
                    self._m_host_fetches.inc()
                    self._distribute(bucket, host)
                    if streams is None:
                        for ring in sealed:
                            self._reset_ring(ring)
                    self._spares[bucket].append(sealed)
                    self._m_sealed[bucket].set(max(
                        0, self._m_sealed[bucket].value() - int(host.count)
                    ))
                    self._inflight[bucket] -= 1
                except BaseException as e:
                    self._reader_exc = e
                    self._cv.notify_all()
                    return
                self._cv.notify_all()

    def _distribute(self, bucket: int, ring) -> None:
        """Walk a fetched ring's undrained slots (oldest first), hand each
        lane its results, fold the float64 books, and move the drops this
        fetch confirmed from the predicted to the confirmed tally (caller
        holds the lock; ``ring`` is host data)."""
        n_slots = ring.scores.shape[0]
        for slot in state_mod.ring_slot_order(ring.head, ring.count, n_slots):
            for lane in np.flatnonzero(ring.mask[slot]):
                ln = self._lanes[int(lane)]
                if ln is None:
                    continue
                n = int(ring.n_valid[slot, lane])
                streaming_mod.account_chunk(
                    ln, ring.n_kept[slot, lane], ring.vdd_idx[slot, lane],
                    online=self._online, tab=self._tab,
                    fixed_vdd=self._cfg.vdd,
                )
                # copy: a view would pin the whole fetched buffer
                ln.results.append((
                    ring.scores[slot, lane, :n].astype(np.float32,
                                                       copy=True),
                    ring.keep[slot, lane, :n].astype(bool, copy=True),
                ))
        d = int(ring.dropped)
        self._m_dropped_dev[bucket].inc(d)
        self._m_dropped_pred[bucket].add(-d)
