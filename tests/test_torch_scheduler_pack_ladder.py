"""The port's ladder and pack policies (``repro_torch.serve.scheduler``)
against the JAX package's, call for call, with no pool: ``pack_upload_slots``,
``plan_pack``, ``PackScheduler``, ``LadderConfig``, ``DegradationLadder``
and ``make_scheduler``.

Observations are built from numpy seeds (fleets of 1-16 lanes over 1-3
buckets, with rates, backlogs, reader lag, tiers, QoS classes and H2D
counts) as the same records of both packages.  Bound: every output equal
(moves, saved and before slots, the ``Action`` tuples, levels and
``scheduler_stats()``).
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402

BUCKET_POOL = (128, 256, 512, 2048)
RATES = (0.0, 40.0, 96.0, 100.0, 150.0, 300.0, 512.0, 700.0, 1500.0,
         2100.0)


def _fleet(rng, qos=("standard",)):
    """A random fleet: 1-3 buckets, 1-16 lanes, per-lane rates, backlogs,
    tiers and classes, as one dict of LaneObservation fields per lane."""
    buckets = tuple(sorted(rng.choice(BUCKET_POOL, int(rng.integers(1, 4)),
                                      replace=False).tolist()))
    n = int(rng.integers(1, 17))
    lanes = []
    for lane in range(n):
        lanes.append(dict(
            lane=lane, bucket=int(rng.choice(buckets)),
            qos=str(rng.choice(qos)), tier=0,
            events_per_halfwin=float(rng.choice(RATES)
                                     * rng.uniform(0.5, 1.5)),
            backlog_rounds=int(rng.integers(0, 6)),
            win=int(rng.integers(0, 50))))
    return buckets, lanes


def _obs(mod, buckets, lanes, *, lag=None, slots=1000, valid=100, phys=8,
         ring_rounds=4):
    """The same observation as ``mod``'s records."""
    lobs = tuple(mod.LaneObservation(**d) for d in lanes)
    backlog = {b: 0 for b in buckets}
    for d in lanes:
        backlog[d["bucket"]] += d["backlog_rounds"]
    return mod.Observation(
        lanes=lobs, backlog_rounds=backlog,
        reader_lag_rounds=lag or {b: 0 for b in buckets},
        drain_wait_s=0.0, last_drain_wait_s={b: 0.0 for b in buckets},
        padding_ratio=1.0 - valid / slots if slots else 0.0,
        h2d_event_slots=slots, h2d_valid_events=valid,
        h2d_padding_bytes=(slots - valid) * 13,
        h2d_by_bucket={b: {"slots": 0, "valid": 0} for b in buckets},
        phys=phys, ring_rounds=ring_rounds)


def _both(buckets, lanes, **kw):
    return _obs(tsched, buckets, lanes, **kw), _obs(jsched, buckets, lanes,
                                                    **kw)


# ---------------------------------------------------------------------------
# The records and the cost model
# ---------------------------------------------------------------------------


def test_records_and_exports_match_reference():
    for name in ("LaneObservation", "Observation", "Action"):
        got, want = getattr(tsched, name), getattr(jsched, name)
        assert got._fields == want._fields, name
        assert got._field_defaults == want._field_defaults, name
    assert tsched.__all__ == jsched.__all__
    assert ([f.name for f in dataclasses.fields(tsched.LadderConfig)]
            == [f.name for f in dataclasses.fields(jsched.LadderConfig)])
    assert (dataclasses.asdict(tsched.LadderConfig())
            == dataclasses.asdict(jsched.LadderConfig()))


def test_pack_upload_slots_block_shapes():
    """The reference's block-shape cases (tests/test_scheduler.py:357),
    then a grid against the JAX function."""
    f = tsched.pack_upload_slots
    assert f(0, 512, 4, 4) == 0 and f(-1, 512, 4, 4) == 0
    assert f(1, 512, 4, 4) == 4 * 512
    assert f(2, 128, 4, 4) == f(4, 128, 4, 4) == 4 * 4 * 128
    assert f(5, 128, 4, 4) == 4 * 4 * 128 + 4 * 128
    assert f(6, 128, 4, 4) == 2 * 4 * 4 * 128
    for m in range(-1, 20):
        for b in (1, 128, 2048):
            for phys in (1, 3, 16):
                for k in (0, 1, 2, 4, 8):
                    assert f(m, b, phys, k) == jsched.pack_upload_slots(
                        m, b, phys, k), (m, b, phys, k)


def _lob(mod, lane, bucket, rate, *, tier=0, backlog=0):
    return mod.LaneObservation(lane=lane, bucket=bucket, qos="standard",
                               tier=tier, events_per_halfwin=float(rate),
                               backlog_rounds=backlog, win=None)


def _ref_obs(mod, lanes, buckets, *, slots=1000, valid=100):
    """The reference tests' observation (phys 4, K 4)."""
    return mod.Observation(
        lanes=tuple(lanes), backlog_rounds={b: 0 for b in buckets},
        reader_lag_rounds={}, drain_wait_s=0.0, last_drain_wait_s={},
        padding_ratio=0.0, h2d_event_slots=slots, h2d_valid_events=valid,
        h2d_padding_bytes=0, h2d_by_bucket={}, phys=4, ring_rounds=4)


@pytest.mark.parametrize("mod", [tsched, jsched], ids=["torch", "jax"])
def test_plan_pack_reference_cases(mod):
    """tests/test_scheduler.py:374-419 on both packages: evacuation of the
    costlier sparse bucket, zero-rate lanes, the padding, bucket-count and
    ``min_gain`` gates, and the tie-break."""
    L = lambda *a, **k: _lob(mod, *a, **k)  # noqa: E731
    obs = _ref_obs(mod, [L(0, 128, 96), L(1, 512, 100), L(2, 512, 100)],
                   (128, 512))
    assert mod.plan_pack(obs) == (((1, 512, 128), (2, 512, 128)), 4 * 512,
                                  4 * 128 + 4 * 512)
    obs2 = _ref_obs(mod, [L(0, 128, 96), L(1, 512, 100), L(2, 512, 0)],
                    (128, 512))
    assert mod.plan_pack(obs2)[0] == ((1, 512, 128),)
    lanes = [L(0, 128, 96), L(1, 512, 100)]
    quiet = _ref_obs(mod, lanes, (128, 512), slots=100, valid=100)
    assert mod.plan_pack(quiet) == ((), 0, 0)
    assert mod.plan_pack(_ref_obs(mod, [L(0, 128, 96)], (128,))) == (
        (), 0, 0)
    obs = _ref_obs(mod, lanes, (128, 512))
    moves, saved, before = mod.plan_pack(obs, min_gain=0.05)
    assert moves and saved >= 0.05 * before
    rejected = mod.plan_pack(obs, min_gain=0.95)
    assert rejected[0] == () and rejected[2] == before
    tie = _ref_obs(mod, [L(0, 128, 512), L(1, 512, 100)], (128, 512))
    assert mod.plan_pack(tie)[:2] == (((0, 128, 512),), 4 * 4 * 128)


@pytest.mark.parametrize("seed", range(6))
def test_plan_pack_matches_reference_on_random_fleets(seed):
    rng = np.random.default_rng(seed)
    for _ in range(60):
        buckets, lanes = _fleet(rng)
        slots = int(rng.integers(0, 5000))
        valid = int(rng.integers(0, slots + 1)) if rng.random() < 0.9 \
            else slots
        kw = dict(slots=slots, valid=valid, phys=int(rng.integers(1, 17)),
                  ring_rounds=int(rng.choice([1, 2, 4, 8])))
        got, want = _both(buckets, lanes, **kw)
        for gain in (0.0, 0.05, 0.3):
            assert tsched.plan_pack(got, min_gain=gain) == jsched.plan_pack(
                want, min_gain=gain), (buckets, lanes, kw, gain)


# ---------------------------------------------------------------------------
# PackScheduler
# ---------------------------------------------------------------------------


def test_pack_scheduler_patience_and_stats():
    """tests/test_scheduler.py:422-447 on the port."""
    obs = _ref_obs(tsched, [_lob(tsched, 0, 128, 96),
                            _lob(tsched, 1, 512, 100)], (128, 512))
    quiet = obs._replace(h2d_event_slots=100, h2d_valid_events=100)
    s = tsched.PackScheduler((128, 512), patience=2)
    assert (s.policy, s.needs_pump_observation, s.needs_observation,
            s.needs_backlog) == ("pack", True, False, False)
    assert s.decide(obs) == ()
    assert s.decide(quiet) == ()
    assert s.decide(obs) == ()
    acts = s.decide(obs)
    assert acts == (tsched.Action(lane=1, migrate=128),)
    assert s.scheduler_stats() == {"pack_moves": 1,
                                   "pack_saved_slots": 4 * 512}
    assert s.decide(obs) == ()
    with pytest.raises(ValueError, match="patience"):
        tsched.PackScheduler((128, 512), patience=0)
    with pytest.raises(ValueError, match="min_gain"):
        tsched.PackScheduler((128, 512), min_gain=1.5)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("patience,min_gain", [(1, 0.05), (2, 0.05),
                                               (3, 0.2)])
def test_pack_scheduler_matches_reference(seed, patience, min_gain):
    """A sequence of observations of one fleet whose rates drift, some
    without padding, and whose lanes follow the moves: every decision and
    the counters equal."""
    rng = np.random.default_rng(100 + seed)
    buckets, lanes = _fleet(rng)
    got = tsched.PackScheduler(buckets, patience=patience,
                               min_gain=min_gain)
    want = jsched.PackScheduler(buckets, patience=patience,
                                min_gain=min_gain)
    for _ in range(40):
        for d in lanes:
            if rng.random() < 0.2:
                d["events_per_halfwin"] = float(rng.choice(RATES))
        valid = 1000 if rng.random() < 0.15 else 100
        go, wo = _both(buckets, lanes, valid=valid)
        a, b = got.decide(go), want.decide(wo)
        assert a == b
        for act in a:
            lanes[act.lane]["bucket"] = act.migrate
        assert got.scheduler_stats() == want.scheduler_stats()


# ---------------------------------------------------------------------------
# LadderConfig and DegradationLadder
# ---------------------------------------------------------------------------

BAD_LADDERS = [
    (dict(classes=()), "QoS class"),
    (dict(classes=(("a", 1), ("a", 2))), "QoS"),
    (dict(classes=(("a", -1),)), "max_tier"),
    (dict(hi_rounds=1.0, lo_rounds=2.0), "lo_rounds"),
    (dict(lo_rounds=-0.1), "lo_rounds"),
    (dict(patience=0), "patience"),
    (dict(recover_patience=0), "patience"),
    (dict(lut_stretch=1), "lut_stretch"),
    (dict(vdd_drop=-1), "vdd_drop"),
    (dict(pack_min_gain=1.0), "pack_min_gain"),
]


@pytest.mark.parametrize("kw,match", BAD_LADDERS,
                         ids=[m for _, m in BAD_LADDERS])
def test_ladder_config_validation(kw, match):
    for mod in (tsched, jsched):
        with pytest.raises(ValueError, match=match):
            mod.LadderConfig(**kw)


def _obs_lanes(mod, lanes, reader_lag=None):
    """tests/test_ladder.py's observation: no buckets, no H2D counts."""
    return mod.Observation(lanes=tuple(lanes), backlog_rounds={},
                           reader_lag_rounds=reader_lag or {},
                           drain_wait_s=0.0, last_drain_wait_s={},
                           padding_ratio=0.0)


def _lane(mod, lane, backlog, qos="standard", tier=0, bucket=128):
    return mod.LaneObservation(lane=lane, bucket=bucket, qos=qos, tier=tier,
                               events_per_halfwin=0.0,
                               backlog_rounds=backlog, win=None)


@pytest.mark.parametrize("mod", [tsched, jsched], ids=["torch", "jax"])
def test_ladder_units(mod):
    """tests/test_ladder.py:195-300 on both packages: QoS-ordered tiers,
    knobs per tier, the dead band and patience, actions only on a tier
    mismatch, starved-first order."""
    lad = mod.LadderConfig(classes=(("bronze", 2), ("silver", 2),
                                    ("premium", 0)))
    s = mod.DegradationLadder((128,), ladder=lad)
    assert s._max_level == 4
    for level, tiers in {0: (0, 0, 0), 1: (1, 0, 0), 2: (2, 0, 0),
                         3: (2, 1, 0), 4: (2, 2, 0)}.items():
        s._level = level
        assert tuple(s.target_tier(q) for q in
                     ("bronze", "silver", "premium")) == tiers
        assert s.target_tier("not-a-class") == 0

    s = mod.DegradationLadder((128,), ladder=mod.LadderConfig(),
                              base_lut_every=2, vdd_top=3)
    assert [s.knobs_for_tier(t) for t in range(4)] == [
        (2, 3, False), (8, 3, False), (8, 2, False), (8, 2, True)]

    s = mod.DegradationLadder((128,), ladder=mod.LadderConfig(
        hi_rounds=2.0, lo_rounds=0.5, patience=2, recover_patience=3))
    hot, mid, cool = (_obs_lanes(mod, [_lane(mod, 0, b)]) for b in (5, 1, 0))
    seq = [hot, hot, hot, mid, hot, hot, cool, cool, mid, cool, cool, cool]
    levels = []
    for o in seq:
        s.decide(o)
        levels.append(s.level)
    assert levels == [0, 1, 1, 1, 1, 2, 2, 2, 2, 2, 2, 1]
    for _ in range(20):
        s.decide(cool)
    assert s.level == 0
    for _ in range(40):
        s.decide(hot)
    assert s.level == s._max_level

    s = mod.DegradationLadder((128,), ladder=mod.LadderConfig(
        patience=1, recover_patience=1), base_lut_every=2, vdd_top=3)
    s._level = 1
    acts = s.decide(_obs_lanes(mod, [
        _lane(mod, 0, 1), _lane(mod, 1, 1, qos="premium"),
        _lane(mod, 2, 1, tier=1)]))
    assert acts == (mod.Action(lane=0, lut_every=8, vdd_cap=3, shed=False,
                               tier=1),)
    s._level = 0
    acts = s.decide(_obs_lanes(mod, [_lane(mod, 2, 1, tier=1)]))
    assert acts == (mod.Action(lane=2, lut_every=2, vdd_cap=3, shed=False,
                               tier=0),)
    assert s.scheduler_stats()["ladder_transitions"] == 2

    s = mod.DegradationLadder((128, 256, 512))
    assert s.order({128: 0, 256: 4, 512: 1}) == (256, 512, 128)
    assert s.order({}) == (128, 256, 512)
    assert (s.policy, s.needs_backlog, s.needs_observation,
            s.needs_pump_observation) == ("ladder", True, False, True)


@pytest.mark.parametrize("mod", [tsched, jsched], ids=["torch", "jax"])
def test_ladder_pack_rung_and_unpack_home(mod):
    """tests/test_scheduler.py:450-507 on both packages: the pack rung
    fires only pinned at the top level, packed lanes go home at level 0,
    ``forget`` clears a recycled slot's home, ``pack=False`` never packs."""
    L = lambda *a, **k: _lob(mod, *a, **k)  # noqa: E731
    lad = mod.DegradationLadder(
        (128, 512),
        ladder=mod.LadderConfig(classes=(("standard", 2),), patience=1,
                                recover_patience=1, hi_rounds=1.0,
                                lo_rounds=0.5),
        base_lut_every=2, vdd_top=3)

    def hot(lanes):
        o = _ref_obs(mod, lanes, (128, 512))
        return o._replace(lanes=tuple(
            lob._replace(backlog_rounds=9) for lob in o.lanes))

    acts = lad.decide(hot([L(0, 128, 96), L(1, 512, 100)]))
    assert lad.level == 1 and acts and all(a.migrate is None for a in acts)
    acts = lad.decide(hot([L(0, 128, 96, tier=1), L(1, 512, 100, tier=1)]))
    assert lad.level == 2
    assert [(a.lane, a.migrate) for a in acts if a.migrate] == [(1, 128)]
    assert lad._pack_home == {1: 512}
    acts = lad.decide(_ref_obs(mod, [L(0, 128, 96, tier=2),
                                     L(1, 128, 100, tier=2)], (128, 512)))
    assert lad.level == 1 and all(a.migrate is None for a in acts)
    acts = lad.decide(_ref_obs(mod, [L(0, 128, 96, tier=1),
                                     L(1, 128, 100, tier=1)], (128, 512)))
    assert lad.level == 0
    assert [(a.lane, a.migrate) for a in acts if a.migrate] == [(1, 512)]
    assert lad._pack_home == {}
    assert lad.scheduler_stats()["pack_moves"] == 2
    lad._pack_home[1] = 512
    lad.forget(1)
    assert lad._pack_home == {}
    off = mod.DegradationLadder(
        (128, 512), ladder=mod.LadderConfig(
            classes=(("standard", 1),), patience=1, recover_patience=1,
            pack=False), base_lut_every=2, vdd_top=3)
    off.decide(hot([L(0, 128, 96), L(1, 512, 100)]))
    acts = off.decide(hot([L(0, 128, 96, tier=1), L(1, 512, 100, tier=1)]))
    assert off.level == 1 and all(a.migrate is None for a in acts)


LADDERS = [
    dict(),
    dict(patience=1, recover_patience=1, hi_rounds=1.0, lo_rounds=0.5),
    dict(classes=(("bronze", 2), ("silver", 1), ("premium", 0)),
         patience=1, recover_patience=2, lut_stretch=3, vdd_drop=2),
    dict(classes=(("standard", 3),), patience=1, recover_patience=1,
         pack=False),
    dict(patience=1, recover_patience=1, pack_min_gain=0.0),
]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("lad_kw", LADDERS, ids=[str(i) for i in
                                                 range(len(LADDERS))])
def test_ladder_matches_reference(seed, lad_kw):
    """One random fleet through a burst and a recovery: the pressure rises
    and falls (backlog and reader lag), the runtime's mirrors follow the
    actions (tiers, and buckets for the moves), a lane is forgotten now
    and then.  Every level, action tuple and ``scheduler_stats()`` equal
    the JAX ladder's."""
    rng = np.random.default_rng(200 + seed)
    tl, jl = tsched.LadderConfig(**lad_kw), jsched.LadderConfig(**lad_kw)
    buckets, lanes = _fleet(rng, qos=tl.qos_names())
    top = int(rng.integers(0, 4))
    got = tsched.DegradationLadder(buckets, ladder=tl, base_lut_every=2,
                                   vdd_top=top)
    want = jsched.DegradationLadder(buckets, ladder=jl, base_lut_every=2,
                                    vdd_top=top)
    levels = []
    for step in range(70):
        hot = 10 <= step < 30
        for d in lanes:
            d["backlog_rounds"] = int(rng.integers(2, 8) if hot
                                      else rng.random() < 0.1)
            if rng.random() < 0.1:
                d["events_per_halfwin"] = float(rng.choice(RATES))
        lag = {b: int(rng.integers(0, 3)) if hot else 0 for b in buckets}
        go, wo = _both(buckets, lanes, lag=lag)
        a, b = got.decide(go), want.decide(wo)
        assert a == b, step
        assert got.level == want.level
        assert got.scheduler_stats() == want.scheduler_stats()
        assert got._pack_home == want._pack_home
        levels.append(got.level)
        for act in a:
            if act.tier is not None:
                lanes[act.lane]["tier"] = act.tier
            if act.migrate is not None:
                lanes[act.lane]["bucket"] = act.migrate
        if rng.random() < 0.05:
            lane = int(rng.integers(0, len(lanes)))
            got.forget(lane)
            want.forget(lane)
    assert max(levels) == got._max_level and levels[-1] == 0


def test_policy_counters_bind_to_the_pool_registry():
    """``bind_metrics`` moves a policy's counters onto a pool's registry,
    carrying the counts made before the bind, as the reference's does."""
    obs = _ref_obs(tsched, [_lob(tsched, 0, 128, 96),
                            _lob(tsched, 1, 512, 100)], (128, 512))
    jo = _ref_obs(jsched, [_lob(jsched, 0, 128, 96),
                           _lob(jsched, 1, 512, 100)], (128, 512))
    snaps = []
    for mod, o, obs_mod in ((tsched, obs, tobs), (jsched, jo, jobs)):
        pack = mod.PackScheduler((128, 512), patience=1)
        pack.decide(o)
        lad = mod.DegradationLadder((128, 512), ladder=mod.LadderConfig(
            patience=1))
        lad.decide(o._replace(lanes=tuple(
            lob._replace(backlog_rounds=9) for lob in o.lanes)))
        reg_p = obs_mod.MetricsRegistry(namespace="pool")
        reg_l = obs_mod.MetricsRegistry(namespace="pool")
        pack.bind_metrics(reg_p)
        lad.bind_metrics(reg_l)
        snaps.append((reg_p.snapshot(), reg_l.snapshot(),
                      pack.scheduler_stats(), lad.scheduler_stats()))
    assert snaps[0] == snaps[1]
    assert snaps[0][2]["pack_moves"] == 1
    assert snaps[0][1]["ladder_level"] == 1


@pytest.mark.parametrize("policy", ["static", "adaptive", "ladder", "pack"])
def test_make_scheduler_matches_reference(policy):
    kw = dict(patience=3, down_margin=0.8, up_margin=1.1, base_lut_every=2,
              vdd_top=3, pack_min_gain=0.1)
    got = tsched.make_scheduler(
        policy, (512, 128), ladder=tsched.LadderConfig(patience=3), **kw)
    want = jsched.make_scheduler(
        policy, (512, 128), ladder=jsched.LadderConfig(patience=3), **kw)
    assert type(got).__name__ == type(want).__name__
    assert got.buckets == want.buckets == (128, 512)
    for attr in ("policy", "needs_backlog", "needs_observation",
                 "needs_pump_observation", "patience", "min_gain",
                 "down_margin", "up_margin", "_base", "_top",
                 "_max_level"):
        assert getattr(got, attr, None) == getattr(want, attr, None), attr
    if policy == "ladder":
        assert (dataclasses.asdict(got.ladder)
                == dataclasses.asdict(want.ladder))
    assert got.scheduler_stats() == want.scheduler_stats()
    with pytest.raises(ValueError, match="pack"):
        tsched.make_scheduler("greedy", (128,))
