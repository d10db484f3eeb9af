"""Control plane of the multi-camera pool (``repro.serve.scheduler``):
observe -> decide -> actuate.

The data plane (``serve.runtime.PoolRuntime``) can run any lane in any
chunk-size bucket; deciding which is policy, expressed here.  The module
carries the contract's records (``LaneObservation``, ``Observation``,
``Action``) and the two policies the port serves:

  ``StaticScheduler``   — a lane lands in the smallest bucket that fits
                          its ``connect(chunk=)`` request and stays there
                          for life; buckets pump in ascending size order;
                          no observation, no actions.
  ``AdaptiveScheduler`` — rate-aware placement: each drain observation
                          compares the lane's events per DVFS half-window
                          (the host twin of the in-step rate estimator)
                          with its bucket, and after ``patience`` rate
                          windows beyond the hysteresis thresholds asks
                          the runtime to migrate the lane live; buckets
                          pump starved first.

The reference's ladder and pack policies, and the per-pump ``decide``
loop they run on, are not ported yet (``ROADMAP.md``, item M8b):
``make_scheduler`` refuses them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

from repro_torch import obs as obs_mod

__all__ = [
    "LaneObservation",
    "Observation",
    "Action",
    "StaticScheduler",
    "AdaptiveScheduler",
    "make_scheduler",
]


class LaneObservation(NamedTuple):
    """One lane's slice of a pump observation (host scalars only)."""

    lane: int
    bucket: int
    qos: str                     # QoS class the session connected with
    tier: int                    # currently *actuated* ladder tier (mirror)
    events_per_halfwin: float    # host rate-twin estimate
    backlog_rounds: int          # full chunks waiting in the re-chunk buffer
    win: Optional[int]           # rate-estimator rotation cursor


class Observation(NamedTuple):
    """What the runtime hands ``decide()`` once per pump pass.

    Built under the pump token before any round is collected, so a policy
    sees the pool exactly as this pass will find it.  All host data — no
    device sync is paid to observe.
    """

    lanes: tuple                 # of LaneObservation, lane-id order
    backlog_rounds: dict         # bucket -> ready-but-unpumped rounds
    reader_lag_rounds: dict      # bucket -> sealed, not yet drained rounds
    drain_wait_s: float          # cumulative pump-thread drain wait
    last_drain_wait_s: dict      # bucket -> last forced-drain wait (s)
    padding_ratio: float         # 1 - valid/uploaded H2D chunk slots
    # H2D upload audit (cumulative counters, both executor paths) — the
    # packing objective's measured signal.  Trailing defaults keep older
    # Observation(...) construction sites valid.
    h2d_event_slots: int = 0     # chunk slots uploaded (valid + padding)
    h2d_valid_events: int = 0    # slots that carried a real event
    h2d_padding_bytes: int = 0   # wasted bytes at the AER slot width
    h2d_by_bucket: dict = {}     # bucket -> {"slots": int, "valid": int}
    phys: int = 1                # physical lane slots every upload pays
    ring_rounds: int = 1         # K: rounds per compiled executor block


class Action(NamedTuple):
    """One actuation request returned by ``decide()``.

    ``None`` fields are left alone.  Knob writes (``lut_every`` /
    ``vdd_cap`` / ``shed``) apply immediately (before this pass's rounds);
    ``migrate`` stages through the normal migration machinery and applies
    at the *next* pump pass; ``drop_policy`` flips the pool-wide overflow
    policy.  ``tier`` is bookkeeping: the runtime mirrors it back in the
    next ``LaneObservation`` so a policy can tell intent from actuation.
    Actions for lanes that disconnected since the observation are dropped
    silently — the decision belonged to the dead session.
    """

    lane: Optional[int]
    lut_every: Optional[int] = None      # Harris LUT refresh interval
    vdd_cap: Optional[int] = None        # max DVFS operating-point index
    shed: Optional[bool] = None          # suspend refresh + drop-oldest buf
    migrate: Optional[int] = None        # target chunk-size bucket
    drop_policy: Optional[str] = None    # pool-wide: "drain"/"drop_oldest"
    tier: Optional[int] = None           # actuated-tier mirror bookkeeping


class StaticScheduler:
    """Frozen placement: buckets are chosen at connect and pumped in
    ascending size order.  ``observe`` never migrates."""

    policy = "static"
    # static ignores its order() argument and never migrates, so the
    # façade can skip both the lock-held backlog walk and the per-poll
    # rate observation entirely on the default path
    needs_backlog = False
    needs_observation = False
    # ... and the runtime skips building the per-pump Observation unless a
    # policy actually consumes it (the ladder does; static/adaptive don't)
    needs_pump_observation = False

    def __init__(self, buckets: tuple):
        self._buckets = tuple(sorted(int(b) for b in buckets))

    @property
    def buckets(self) -> tuple:
        return self._buckets

    def place(self, want: int) -> Optional[int]:
        """Smallest bucket that fits a ``connect(chunk=want)`` request, or
        ``None`` when nothing does (the façade raises)."""
        return next((b for b in self._buckets if b >= int(want)), None)

    def order(self, backlog_rounds: dict) -> tuple:
        """Bucket pump order; static keeps the deterministic ascending
        order (``backlog_rounds`` is ignored)."""
        return self._buckets

    def observe(self, lane: int, bucket: int, events_per_halfwin: float,
                win: Optional[int] = None) -> Optional[int]:
        """One drain observation for ``lane``; returns a migration target
        bucket or ``None``.  Static never migrates."""
        return None

    def decide(self, obs: Observation) -> tuple:
        """The decide half of the control loop: one pump observation in,
        a tuple of ``Action`` records out.  Static/adaptive never act
        here (their migration path is the per-poll ``observe``)."""
        return ()

    def forget(self, lane: int) -> None:
        """Drop any per-lane observation state (slot recycled)."""

    def bind_metrics(self, registry: obs_mod.MetricsRegistry) -> None:
        """Re-home this policy's witness counters onto ``registry`` (the
        pool's, at façade wiring time) so one emission carries the data
        plane and the control plane alike.  Static/adaptive own no
        counters; policies that do re-declare their handles there,
        carrying any pre-bind counts forward."""

    def scheduler_stats(self) -> dict:
        """Policy-side counters merged into ``pool_stats()``."""
        return {}


class AdaptiveScheduler(StaticScheduler):
    """Rate-aware placement: hysteresis and patience around the fit rule.

    ``observe`` consumes the lane's events per half-window (one
    half-window is the DVFS controller's re-budgeting period).  A lane
    whose estimate exceeds ``bucket * up_margin`` wants the smallest
    bucket that fits; one whose estimate fits a smaller bucket times
    ``down_margin`` wants that.  The want must repeat for ``patience``
    consecutive rate windows before it is returned.
    """

    policy = "adaptive"
    needs_backlog = True
    needs_observation = True

    def __init__(self, buckets: tuple, *, patience: int = 3,
                 down_margin: float = 0.9, up_margin: float = 1.0):
        super().__init__(buckets)
        if patience < 1:
            raise ValueError("patience must be >= 1")
        if not (0.0 < down_margin <= 1.0):
            raise ValueError("down_margin must be in (0, 1]")
        if up_margin <= 0.0:
            raise ValueError("up_margin must be > 0")
        self.patience = int(patience)
        self.down_margin = float(down_margin)
        self.up_margin = float(up_margin)
        # lane -> (wanted bucket, windows wanting it, last counted window)
        self._streaks: dict[int, tuple[int, int, Optional[int]]] = {}

    def _fit(self, w: float) -> int:
        """Smallest bucket >= w; the largest when nothing fits."""
        return next((b for b in self._buckets if b >= w), self._buckets[-1])

    def desired(self, bucket: int, events_per_halfwin: float) -> int:
        """Hysteresis target for a lane in ``bucket``: up the moment the
        rate outgrows the bucket; down only with ``down_margin`` headroom,
        to the deepest tier that has it (so a lane parked several tiers
        above its rate still descends partway when the bottom tier lacks
        the margin); otherwise stay."""
        w = float(events_per_halfwin)
        if w > bucket * self.up_margin:
            return max(self._fit(w), bucket)
        target = self._fit(w)
        if target < bucket:
            for b in self._buckets:           # ascending: deepest first
                if b >= bucket:
                    break
                if b >= target and w <= b * self.down_margin:
                    return b
        return bucket

    def order(self, backlog_rounds: dict) -> tuple:
        """Starved-first pump order: the buckets with the most ready
        rounds waiting in lane buffers fold first, so a round budget
        reaches the lanes that need it; ties break ascending.  With no
        budget every bucket pumps until dry, so the order changes latency,
        never results."""
        return tuple(sorted(
            self._buckets,
            key=lambda b: (-int(backlog_rounds.get(b, 0)), b),
        ))

    def observe(self, lane: int, bucket: int, events_per_halfwin: float,
                win: Optional[int] = None) -> Optional[int]:
        """One drain observation.  ``win`` is the lane's rate-estimator
        window cursor: observations repeating the same window collapse to
        one, so patience counts rate windows, not polls.  ``win=None``
        counts every call."""
        want = self.desired(bucket, events_per_halfwin)
        if want == bucket:
            self._streaks.pop(lane, None)
            return None
        prev_want, n, last_win = self._streaks.get(lane, (want, 0, None))
        if prev_want == want and win is not None and last_win == win:
            return None                     # same window: already counted
        n = n + 1 if prev_want == want else 1
        if n >= self.patience:
            self._streaks.pop(lane, None)
            return want
        self._streaks[lane] = (want, n, win)
        return None

    def forget(self, lane: int) -> None:
        self._streaks.pop(lane, None)


def make_scheduler(policy: str, buckets: tuple, *, patience: int = 3,
                   down_margin: float = 0.9,
                   up_margin: float = 1.0) -> StaticScheduler:
    """The scheduler for ``policy``: ``"static"`` or ``"adaptive"`` (with
    its patience and margins).  ``"ladder"`` and ``"pack"`` are refused
    until they are ported."""
    if policy == "static":
        return StaticScheduler(buckets)
    if policy == "adaptive":
        return AdaptiveScheduler(buckets, patience=patience,
                                 down_margin=down_margin,
                                 up_margin=up_margin)
    if policy in ("ladder", "pack"):
        raise NotImplementedError(
            f"policy {policy!r} is not ported yet (ROADMAP item M8b: the "
            f"ladder and pack policies and their per-pump decide loop); "
            f"use policy='static' or 'adaptive'")
    raise ValueError(
        f"policy must be 'static', 'adaptive', 'ladder', or 'pack', "
        f"got {policy!r}"
    )
