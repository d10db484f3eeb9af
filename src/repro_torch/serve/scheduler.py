"""Control plane of the multi-camera pool (``repro.serve.scheduler``):
observe -> decide -> actuate.

The data plane (``serve.runtime.PoolRuntime``) can run any lane in any
chunk-size bucket; deciding which is policy, expressed here.  The module
carries the contract's records (``LaneObservation``, ``Observation``,
``Action``) and the reference's four policies:

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
  ``DegradationLadder`` — overload handled by degrading quality, never
                          latency: each pump observation's backlog
                          pressure moves a fleet level with hysteresis and
                          patience; lanes descend QoS-ordered tiers
                          (stretch the LUT refresh, lower the DVFS
                          ceiling, shed), the first class first; pinned
                          at its top level the ladder packs sparse buckets
                          together (``plan_pack``) and sends the packed
                          lanes home once it is back at level 0.
  ``PackScheduler``     — that packing alone: every pump observation
                          plans the bucket evacuation that saves the most
                          padded H2D upload slots and, after ``patience``
                          observations that keep finding it, moves the
                          lanes.

The ladder and pack act through ``decide``: the runtime builds an
``Observation`` under the pump token before a pass collects any round and
applies the returned ``Action`` records (knob writes now, moves staged for
the next pass).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

from repro_torch import obs as obs_mod
from repro_torch.obs.schema import POLICY_STATS

__all__ = [
    "LaneObservation",
    "Observation",
    "Action",
    "StaticScheduler",
    "AdaptiveScheduler",
    "LadderConfig",
    "DegradationLadder",
    "PackScheduler",
    "pack_upload_slots",
    "plan_pack",
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


def pack_upload_slots(max_rounds: int, bucket: int, phys: int,
                      ring_rounds: int) -> int:
    """H2D chunk slots one pump pass uploads for a bucket whose busiest
    lane folds ``max_rounds`` rounds.

    Every upload is the full ``(phys, bucket)`` slab.  Full blocks of
    ``ring_rounds`` rounds upload ``ring_rounds * phys * bucket`` slots, a
    1-round remainder ``phys * bucket`` and a longer remainder a whole
    padded block (``PoolRuntime._stage_block``).  A bucket nobody folds in
    uploads nothing, which is why evacuating a sparse bucket saves its
    whole slab.
    """
    m = int(max_rounds)
    if m <= 0:
        return 0
    k = max(1, int(ring_rounds))
    full, rem = divmod(m, k)
    slots = full * k * int(phys) * int(bucket)
    if rem == 1:
        slots += int(phys) * int(bucket)
    elif rem > 1:
        slots += k * int(phys) * int(bucket)
    return slots


def plan_pack(obs: Observation, *, min_gain: float = 0.05) -> tuple:
    """Greedy bucket evacuation minimising the fleet's padded upload slots.

    Returns ``(moves, saved_slots, before_slots)``, ``moves`` a tuple of
    ``(lane, src_bucket, dst_bucket)``.  A lane folding ``w`` events per
    half-window in bucket ``b`` needs ``ceil(w / b)`` rounds a pass and a
    bucket pays for its busiest lane (``pack_upload_slots``).  A candidate
    moves *all* of a source bucket's lanes that carry traffic into one
    target (moving one lane out of a shared bucket saves nothing while a
    neighbour keeps the slab in use).  One evacuation per call, accepted
    when it saves at least ``min_gain`` of the fleet's current upload; ties
    go to the smallest ``(src, dst)``.  Until the H2D audit has seen a
    padded upload (``h2d_event_slots > h2d_valid_events``) the planner
    stays quiet.
    """
    if int(obs.h2d_event_slots) <= int(obs.h2d_valid_events):
        return (), 0, 0            # no padding observed yet: nothing to win
    phys = max(1, int(obs.phys))
    k = max(1, int(obs.ring_rounds))
    buckets = sorted({*obs.backlog_rounds} |
                     {lob.bucket for lob in obs.lanes})
    if len(buckets) < 2 or not obs.lanes:
        return (), 0, 0
    rates: dict = {b: [] for b in buckets}
    movers: dict = {b: [] for b in buckets}
    for lob in obs.lanes:
        w = float(lob.events_per_halfwin)
        rates[lob.bucket].append(w)
        if w > 0:
            movers[lob.bucket].append(lob)

    def bucket_slots(b: int, ws: list) -> int:
        m = 0
        for w in ws:
            if w > 0:
                m = max(m, max(1, math.ceil(w / b)))
        return pack_upload_slots(m, b, phys, k)

    before = sum(bucket_slots(b, rates[b]) for b in buckets)
    if before <= 0:
        return (), 0, before
    best = None                    # (saved, src, dst)
    for src in buckets:
        if not movers[src]:
            continue
        src_cost = bucket_slots(src, rates[src])
        for dst in buckets:
            if dst == src:
                continue
            merged = rates[dst] + [float(lob.events_per_halfwin)
                                   for lob in movers[src]]
            saved = (src_cost + bucket_slots(dst, rates[dst])
                     - bucket_slots(dst, merged))
            if saved <= 0:
                continue
            if best is None or saved > best[0] or \
                    (saved == best[0] and (src, dst) < (best[1], best[2])):
                best = (saved, src, dst)
    if best is None or best[0] < min_gain * before:
        return (), 0, before
    saved, src, dst = best
    moves = tuple((lob.lane, src, dst) for lob in movers[src])
    return moves, int(saved), int(before)


class PackScheduler(StaticScheduler):
    """Fleet-wide lane packing as a policy of its own (``policy="pack"``).

    Placement starts static; every pump observation runs ``plan_pack`` and,
    after ``patience`` consecutive observations that find a qualifying
    saving, returns the migrate ``Action`` records that evacuate the
    costliest sparse bucket.  Moves go through the runtime's staged
    migration, so nothing changes a block shape.
    """

    policy = "pack"
    needs_backlog = False
    needs_observation = False
    needs_pump_observation = True

    def __init__(self, buckets: tuple, *, patience: int = 2,
                 min_gain: float = 0.05):
        super().__init__(buckets)
        if patience < 1:
            raise ValueError("patience must be >= 1")
        if not (0.0 <= min_gain < 1.0):
            raise ValueError("min_gain must be in [0, 1)")
        self.patience = int(patience)
        self.min_gain = float(min_gain)
        self._streak = 0
        self._declare_metrics(obs_mod.MetricsRegistry(namespace="policy"))

    def _declare_metrics(self, reg: obs_mod.MetricsRegistry) -> None:
        self._m_pack_moves = reg.counter(
            "pack_moves", POLICY_STATS["pack_moves"])
        self._m_saved_slots = reg.counter(
            "pack_saved_slots", POLICY_STATS["pack_saved_slots"])

    def bind_metrics(self, registry: obs_mod.MetricsRegistry) -> None:
        moves = self._m_pack_moves.value()
        saved = self._m_saved_slots.value()
        self._declare_metrics(registry)
        if moves:
            self._m_pack_moves.inc(moves)
        if saved:
            self._m_saved_slots.inc(saved)

    def decide(self, obs: Observation) -> tuple:
        moves, saved, _before = plan_pack(obs, min_gain=self.min_gain)
        if not moves:
            self._streak = 0
            return ()
        self._streak += 1
        if self._streak < self.patience:
            return ()
        self._streak = 0
        self._m_pack_moves.inc(len(moves))
        self._m_saved_slots.inc(int(saved))
        return tuple(Action(lane=lane, migrate=dst)
                     for lane, _src, dst in moves)

    def scheduler_stats(self) -> dict:
        return {
            "pack_moves": self._m_pack_moves.value(),
            "pack_saved_slots": self._m_saved_slots.value(),
        }


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """Tuning of the overload ladder (host-side policy constants).

    ``classes`` lists the QoS classes in the order they degrade, first
    entry first, as ``(name, max_tier)`` pairs.  A class's tier is
    ``clamp(level - offset, 0, max_tier)``, ``offset`` the sum of the
    earlier classes' max tiers, so one class degrades fully before the
    next starts; by default a premium lane (max tier 0) never degrades.

    Pressure is ready-but-unpumped rounds plus rounds sealed to the reader
    and not yet drained, per active lane.  The level climbs one rung after
    ``patience`` consecutive observations above ``hi_rounds`` and descends
    one after ``recover_patience`` below ``lo_rounds``; in between both
    streaks reset (the dead band).

    Tiers are cumulative: tier 1 multiplies the LUT refresh interval by
    ``lut_stretch``; tier 2 also lowers the DVFS operating-point ceiling by
    ``vdd_drop`` entries (inert at a fixed Vdd); tier 3 also sheds
    (suspends refresh, drops the oldest buffered events beyond one ring of
    rounds).  With ``pack`` (and more than one bucket) a ladder pinned at
    its top level also packs sparse buckets (``plan_pack``, accepted at
    ``pack_min_gain``) and sends the packed lanes home at level 0.
    """

    classes: tuple = (("standard", 3), ("premium", 0))
    hi_rounds: float = 2.0       # enter-degradation pressure (rounds/lane)
    lo_rounds: float = 0.5       # exit-degradation pressure (rounds/lane)
    patience: int = 2            # pump observations above hi before +1
    recover_patience: int = 4    # pump observations below lo before -1
    lut_stretch: int = 4         # tier 1: lut_every *= lut_stretch
    vdd_drop: int = 1            # tier 2: vdd_cap = top - vdd_drop
    pack: bool = True            # bottom rung: pack lanes at max level
    pack_min_gain: float = 0.05  # accept a pack move saving >= this share

    def __post_init__(self):
        if not self.classes:
            raise ValueError("ladder needs at least one QoS class")
        names = [c for c, _ in self.classes]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate QoS class in {names}")
        if any(int(m) < 0 for _, m in self.classes):
            raise ValueError("max_tier must be >= 0")
        if not (0 <= self.lo_rounds < self.hi_rounds):
            raise ValueError("need 0 <= lo_rounds < hi_rounds")
        if self.patience < 1 or self.recover_patience < 1:
            raise ValueError("patience values must be >= 1")
        if self.lut_stretch < 2:
            raise ValueError("lut_stretch must be >= 2")
        if self.vdd_drop < 0:
            raise ValueError("vdd_drop must be >= 0")
        if not (0.0 <= self.pack_min_gain < 1.0):
            raise ValueError("pack_min_gain must be in [0, 1)")

    def qos_names(self) -> tuple:
        return tuple(c for c, _ in self.classes)


class DegradationLadder(StaticScheduler):
    """Hysteretic tiered degradation with QoS-ordered descent.

    Placement is static and the pump order starved-first, as adaptive's.
    ``decide`` tracks the backlog pressure across pump observations, moves
    the fleet level, and returns knob ``Action`` records only for lanes
    whose QoS-mapped tier differs from their actuated tier (the runtime
    mirrors it back), so a lane that reconnects at neutral knobs is simply
    actuated again on the next pass.
    """

    policy = "ladder"
    needs_backlog = True
    needs_observation = False
    needs_pump_observation = True

    def __init__(self, buckets: tuple, *,
                 ladder: Optional[LadderConfig] = None,
                 base_lut_every: int = 1, vdd_top: int = 0):
        super().__init__(buckets)
        self.ladder = ladder if ladder is not None else LadderConfig()
        self._base = max(1, int(base_lut_every))
        self._top = max(0, int(vdd_top))
        self._max_level = sum(int(m) for _, m in self.ladder.classes)
        self._level = 0
        self._hot = 0            # consecutive observations above hi_rounds
        self._cool = 0           # consecutive observations below lo_rounds
        self._pack_home = {}     # lane -> bucket it lived in before packing
        self._declare_metrics(obs_mod.MetricsRegistry(namespace="policy"))

    def _declare_metrics(self, reg: obs_mod.MetricsRegistry) -> None:
        self._m_level = reg.gauge(
            "ladder_level", POLICY_STATS["ladder_level"])
        self._m_max_level = reg.gauge(
            "ladder_max_level", POLICY_STATS["ladder_max_level"])
        self._m_level.set(self._level)
        self._m_max_level.set(self._max_level)
        self._m_transitions = reg.counter(
            "ladder_transitions", POLICY_STATS["ladder_transitions"])
        self._m_pack_moves = reg.counter(
            "pack_moves", POLICY_STATS["pack_moves"])

    def bind_metrics(self, registry: obs_mod.MetricsRegistry) -> None:
        trans = self._m_transitions.value()
        moves = self._m_pack_moves.value()
        self._declare_metrics(registry)
        if trans:
            self._m_transitions.inc(trans)
        if moves:
            self._m_pack_moves.inc(moves)

    @property
    def level(self) -> int:
        return self._level

    def target_tier(self, qos: str) -> int:
        """Tier of a class at the current level.  An unknown class never
        degrades (the façade refuses unknown classes at connect)."""
        off = 0
        for name, mx in self.ladder.classes:
            if name == qos:
                return max(0, min(self._level - off, int(mx)))
            off += int(mx)
        return 0

    def knobs_for_tier(self, tier: int) -> tuple:
        """``(lut_every, vdd_cap, shed)`` of a lane at ``tier``."""
        lad = self.ladder
        lut_every = self._base if tier < 1 else self._base * lad.lut_stretch
        vdd_cap = self._top if tier < 2 else max(0, self._top - lad.vdd_drop)
        return lut_every, vdd_cap, tier >= 3

    def order(self, backlog_rounds: dict) -> tuple:
        """Starved-first, ties ascending (as ``AdaptiveScheduler``)."""
        return tuple(sorted(
            self._buckets,
            key=lambda b: (-int(backlog_rounds.get(b, 0)), b),
        ))

    def decide(self, obs: Observation) -> tuple:
        lad = self.ladder
        n = max(1, len(obs.lanes))
        pressure = (
            sum(lob.backlog_rounds for lob in obs.lanes)
            + sum(obs.reader_lag_rounds.values())
        ) / n
        if pressure > lad.hi_rounds:
            self._hot, self._cool = self._hot + 1, 0
            if self._hot >= lad.patience and self._level < self._max_level:
                self._level += 1
                self._m_level.set(self._level)
                self._hot = 0
        elif pressure < lad.lo_rounds:
            self._cool, self._hot = self._cool + 1, 0
            if self._cool >= lad.recover_patience and self._level > 0:
                self._level -= 1
                self._m_level.set(self._level)
                self._cool = 0
        else:
            self._hot = self._cool = 0     # dead band: both streaks reset

        actions = []
        for lob in obs.lanes:
            tier = self.target_tier(lob.qos)
            if tier == lob.tier:
                continue
            lut_every, vdd_cap, shed = self.knobs_for_tier(tier)
            actions.append(Action(
                lane=lob.lane, lut_every=lut_every, vdd_cap=vdd_cap,
                shed=shed, tier=tier,
            ))
            self._m_transitions.inc()

        # The bottom rung is placement: pinned at the top level, pack lanes
        # into fewer buckets; back at level 0, send packed lanes home.
        if lad.pack and len(self._buckets) > 1:
            if self._level >= self._max_level and self._max_level > 0:
                moves, _saved, _before = plan_pack(
                    obs, min_gain=lad.pack_min_gain)
                for lane, src, dst in moves:
                    self._pack_home.setdefault(lane, src)
                    actions.append(Action(lane=lane, migrate=dst))
                    self._m_pack_moves.inc()
            elif self._level == 0 and self._pack_home:
                cur = {lob.lane: lob.bucket for lob in obs.lanes}
                for lane, home in sorted(self._pack_home.items()):
                    b = cur.get(lane)
                    self._pack_home.pop(lane)
                    if b is None or b == home:
                        continue     # gone, or already back where it was
                    actions.append(Action(lane=lane, migrate=home))
                    self._m_pack_moves.inc()
        return tuple(actions)

    def forget(self, lane: int) -> None:
        """A recycled slot must not inherit its predecessor's home."""
        self._pack_home.pop(lane, None)

    def scheduler_stats(self) -> dict:
        return {
            "ladder_level": self._level,
            "ladder_max_level": self._max_level,
            "ladder_transitions": self._m_transitions.value(),
            "pack_moves": self._m_pack_moves.value(),
        }


def make_scheduler(policy: str, buckets: tuple, *, patience: int = 3,
                   down_margin: float = 0.9,
                   up_margin: float = 1.0,
                   ladder: Optional[LadderConfig] = None,
                   base_lut_every: int = 1,
                   vdd_top: int = 0,
                   pack_min_gain: float = 0.05) -> StaticScheduler:
    """The scheduler for ``policy``: ``"static"``, ``"adaptive"`` (with its
    patience and margins), ``"ladder"`` (``ladder``, the config's
    ``base_lut_every`` and the pool's ``vdd_top``) or ``"pack"``
    (``patience``, ``pack_min_gain``)."""
    if policy == "static":
        return StaticScheduler(buckets)
    if policy == "adaptive":
        return AdaptiveScheduler(buckets, patience=patience,
                                 down_margin=down_margin,
                                 up_margin=up_margin)
    if policy == "ladder":
        return DegradationLadder(buckets, ladder=ladder,
                                 base_lut_every=base_lut_every,
                                 vdd_top=vdd_top)
    if policy == "pack":
        return PackScheduler(buckets, patience=patience,
                             min_gain=pack_min_gain)
    raise ValueError(
        f"policy must be 'static', 'adaptive', 'ladder', or 'pack', "
        f"got {policy!r}"
    )
