"""The port's per-pump control loop (``PoolRuntime.pump_pass(decide=)``,
the ``Observation``, the actions, the coalesced knob writes) and the pools
that run on it (``policy="ladder"`` and ``policy="pack"``) on the CPU,
against the JAX package's pool on the same feeds, and a packed lane
against a ``StreamingDetector.rebucket`` replay.

Bounds: every pass's ``Observation`` equal field by field apart from the
wall-clock drain waits; actions, ladder levels, per-lane ``ladder_tier`` /
``ctrl_*``, migration logs, kept masks, stats and ``pool_stats()`` (apart
from ``WALL_TIME_KEYS``) exact; scores within ``1e-5 * max|R_ref|``
(``_torch_pool_harness``); a packed lane bit-equal to its replay.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_pool_harness as hx  # noqa: E402
from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro.core import pipeline as jp  # noqa: E402
from repro.serve import DetectorPool as JPool  # noqa: E402
from repro.serve import scheduler as jsched  # noqa: E402
from repro.serve.runtime import PoolRuntime as JRuntime  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402
from repro_torch.serve import DetectorPool as TPool  # noqa: E402
from repro_torch.serve import StreamingDetector  # noqa: E402
from repro_torch.serve import scheduler as tsched  # noqa: E402
from repro_torch.serve.runtime import PoolRuntime as TRuntime  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The reference's ladder fixtures run at its default sensor (180x240).
CFG = tp.PipelineConfig(chunk=128, lut_every_chunks=2, device="cpu")
JCFG = jp.PipelineConfig(chunk=128, lut_every_chunks=2)
PAIRS = {"torch": (TPool, TRuntime, tsched, CFG),
         "jax": (JPool, JRuntime, jsched, JCFG)}


def _capture(pool):
    """Record every pass's observation and actions (the pool's scheduler
    object is the one its ``_decide`` hands the runtime)."""
    seen = []
    decide = pool.scheduler.decide

    def spy(obs):
        acts = decide(obs)
        seen.append((obs, acts))
        return acts

    pool.scheduler.decide = spy
    return seen


def assert_passes_equal(got, want):
    """Per pass: the observation field by field (no wall-clock waits) and
    the actions."""
    assert len(got) == len(want)
    for i, ((go, ga), (wo, wa)) in enumerate(zip(got, want)):
        g, w = go._asdict(), wo._asdict()
        assert g.pop("last_drain_wait_s").keys() == \
            w.pop("last_drain_wait_s").keys()
        g.pop("drain_wait_s")
        w.pop("drain_wait_s")
        g["lanes"] = [tuple(lob) for lob in g["lanes"]]
        w["lanes"] = [tuple(lob) for lob in w["lanes"]]
        assert g == w, i
        assert [tuple(a) for a in ga] == [tuple(a) for a in wa], i


def _window(st, j, half):
    m = (st.ts // half) == j
    return st.xy[m], st.ts[m]


# ---------------------------------------------------------------------------
# The runtime's loop (tests/test_ladder.py:301-389)
# ---------------------------------------------------------------------------


def test_pump_observation_matches_reference():
    """Backlog, QoS, tier, reader lag and the H2D counts (per bucket,
    1-round and K-padded blocks) of each pass's observation equal the JAX
    runtime's; the pass folds the backlog it observed."""
    st = synthetic.shapes_stream(duration_us=30_000, seed=0)
    runs = {}
    for name, (_, Runtime, _, cfg) in PAIRS.items():
        rt = Runtime(cfg, capacity=2, buckets=(128, 256), ring_rounds=4,
                     drain_mode="sync")
        a = rt.connect(128, seed=0, qos="premium")
        b = rt.connect(256, seed=1)
        seen = []

        def capture(obs):
            seen.append((obs, ()))
            return ()

        for lo, n_a, n_b in ((0, 300, 100), (300, 900, 700),
                             (1200, 129, 256), (1329, 0, 0)):
            rt.feed(a, st.xy[lo:lo + n_a], st.ts[lo:lo + n_a])
            rt.feed(b, st.xy[lo:lo + n_b], st.ts[lo:lo + n_b])
            rt.pump_pass((128, 256), decide=capture)
        runs[name] = (seen, rt.pool_stats())
        rt.close()
    got, want = runs["torch"], runs["jax"]
    assert_passes_equal(got[0], want[0])
    hx.assert_stats_equal(got[1], want[1])
    first, second = got[0][0][0], got[0][1][0]
    lob = {lo.lane: lo for lo in first.lanes}
    assert (lob[0].qos, lob[1].qos, lob[0].tier) == ("premium", "standard",
                                                     0)
    assert first.backlog_rounds == {128: 2, 256: 0}
    assert second.backlog_rounds == {128: 7, 256: 3}
    assert got[0][-1][0].h2d_event_slots > got[0][-1][0].h2d_valid_events


def _knobs_and_move(name, readout, spelling):
    """Lane 0 gets ``lut_every`` 8, ``vdd_cap`` 0, ``shed`` and a move to
    256 with a backlog of ready rounds, by one of three spellings:
    ``"budget"`` (in the pass's actions, the pass under a budget of 0
    rounds), ``"pass"`` (in the actions of a pass that then runs the lane's
    rounds) or ``"manual"`` (``set_lane_control`` before that pass,
    ``stage_migration`` after it).  Returns the stats after the staging
    pass, the final outputs, stats and pool stats."""
    _, Runtime, sched, cfg = PAIRS[name]
    st = synthetic.shapes_stream(duration_us=60_000, seed=0)
    rt = Runtime(cfg, capacity=2, buckets=(128, 256), ring_rounds=4,
                 readout=readout, drain_mode="sync")
    lane = rt.connect(128, seed=0)
    other = rt.connect(128, seed=1)
    rt.feed(lane, st.xy[:700], st.ts[:700])
    rt.feed(other, st.xy[:300], st.ts[:300])
    rt.pump_pass((128, 256))
    rt.feed(lane, st.xy[700:2000], st.ts[700:2000])
    act = sched.Action(lane=lane, lut_every=8, vdd_cap=0, shed=True, tier=3,
                       migrate=256)
    if spelling == "manual":
        rt.set_lane_control(lane, lut_every=8, vdd_cap=0, shed=True)
        rt.pump_pass((128, 256))
        rt.stage_migration(lane, 256)
    else:
        rt.pump_pass((128, 256), 0 if spelling == "budget" else None,
                     decide=lambda obs: (act,))
    mid = (rt.stats(lane), rt.staged_migrations())
    rt.feed(lane, st.xy[2000:3000], st.ts[2000:3000])
    rt.pump_pass((128, 256))
    out = {i: rt.flush(ln, (128, 256)) for i, ln in enumerate((lane, other))}
    res = (mid, rt.stats(lane), rt.stats(other), out, rt.pool_stats(),
           rt.executors_compiled_once())
    rt.close()
    return res


@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_knob_actions_and_a_move_in_one_pass(readout):
    """One pass gives a lane knob actions (shed included) and a move: the
    knobs land before the move is staged (the staging drains the old
    bucket's rounds, densified under compact readout), the tier mirror
    follows, the move applies at the next pass with the knobs kept.

    Under a budget that runs none of the lane's rounds in that pass, every
    stat and output equals the JAX runtime's.  When the pass goes on to run
    the lane's rounds in its old bucket, the port equals the manual
    spelling (the same knob write before the pass, the move staged after
    it), and that equals the JAX runtime's manual spelling; the JAX
    runtime's own in-pass spelling restores the snapshot it took at
    staging and so drops those rounds from the lane's device state
    (``ROADMAP.md``, F6)."""
    got, want = (_knobs_and_move(n, readout, "budget")
                 for n in ("torch", "jax"))
    mid, end = got[0], got[1]
    assert (mid[0]["ctrl_lut_every"], mid[0]["ctrl_vdd_cap"],
            mid[0]["ctrl_shed"], mid[0]["ladder_tier"]) == (8, 0, True, 3)
    assert mid[0]["bucket"] == 128 and mid[1] == {0: 256}
    assert mid[0]["shed_events"] > 0
    assert (end["bucket"], end["migrations"], end["ctrl_lut_every"],
            end["ladder_tier"]) == (256, 1, 8, 3)
    assert got[5]
    assert mid[1] == want[0][1]
    for g, w in zip((mid[0], *got[1:3]), (want[0][0], *want[1:3])):
        hx.assert_stats_equal(g, w)
    hx.assert_results(got[3], want[3])
    hx.assert_stats_equal(got[4], want[4])

    in_pass = _knobs_and_move("torch", readout, "pass")
    manual = _knobs_and_move("torch", readout, "manual")
    want = _knobs_and_move("jax", readout, "manual")
    assert in_pass[0][0]["buffered"] == 0 < mid[0]["buffered"]
    assert in_pass[1]["migration_log"] == manual[1]["migration_log"]
    for k in (0, 1):
        np.testing.assert_array_equal(in_pass[3][0][k], manual[3][0][k])
    for g, w in zip(in_pass[1:3], manual[1:3]):
        hx.assert_stats_equal(g, w, skip=("ladder_tier",))
    for g, w in zip(manual[1:3], want[1:3]):
        hx.assert_stats_equal(g, w)
    hx.assert_results(manual[3], want[3])
    hx.assert_stats_equal(manual[4], want[4])


def test_action_for_retired_lane_is_dropped_silently():
    """Actions for a lane retired since the observation are dropped, a
    pool-wide ``drop_policy`` flips, a bad one is refused, and a reused
    slot starts at neutral knobs; as the JAX runtime."""
    runs = {}
    for name, (_, Runtime, sched, cfg) in PAIRS.items():
        rt = Runtime(cfg, capacity=2, buckets=(128,))
        dead = rt.connect(128)
        live = rt.connect(128)
        rt.disconnect(dead)
        rt.pump_pass((128,), decide=lambda obs: (
            sched.Action(lane=dead, shed=True, tier=3),
            sched.Action(lane=live, lut_every=4, tier=1),
            sched.Action(lane=None, drop_policy="drop_oldest"),
        ))
        fresh = rt.connect(128)
        with pytest.raises(ValueError, match="drop_policy"):
            rt.pump_pass((128,), decide=lambda obs: (
                sched.Action(lane=None, drop_policy="yolo"),))
        with pytest.raises(ValueError, match="not a configured bucket"):
            rt.pump_pass((128,), decide=lambda obs: (
                sched.Action(lane=live, migrate=300),))
        runs[name] = (fresh == dead, rt._overflow, rt.stats(live),
                      rt.stats(fresh), rt.pool_stats())
        rt.close()
    got, want = runs["torch"], runs["jax"]
    assert got[:2] == (True, "drop_oldest")
    assert (got[2]["ctrl_lut_every"], got[2]["ladder_tier"]) == (4, 1)
    assert (got[3]["ctrl_shed"], got[3]["ladder_tier"],
            got[3]["ctrl_lut_every"]) == (False, 0, CFG.lut_every_chunks)
    for g, w in zip(got[2:], want[2:]):
        hx.assert_stats_equal(g, w)


def test_shed_caps_rechunk_buffer_drop_oldest():
    st = synthetic.shapes_stream(duration_us=60_000, seed=1)
    runs = {}
    for name, (_, Runtime, _, cfg) in PAIRS.items():
        rt = Runtime(cfg, capacity=1, buckets=(128,), ring_rounds=2)
        lane = rt.connect(128)
        rt.set_lane_control(lane, shed=True)
        rt.feed(lane, st.xy[:2000], st.ts[:2000])
        runs[name] = (rt.stats(lane), int(rt._lanes[lane].buf_ts[-1]),
                      rt.pool_stats())
        rt.close()
    got, want = runs["torch"], runs["jax"]
    assert got[0]["buffered"] == 2 * 128
    assert got[0]["shed_events"] == 2000 - 2 * 128
    assert got[1] == int(st.ts[1999])
    hx.assert_stats_equal(got[0], want[0])
    hx.assert_stats_equal(got[2], want[2])


# ---------------------------------------------------------------------------
# The ladder pool (tests/test_ladder.py:392-555)
# ---------------------------------------------------------------------------


def _serve_ladder(name, readout):
    """tests/test_ladder.py:392's overload and recovery, with a premium
    lane: a starvation budget of one round a window, then the recovery
    recipe (pump, non-blocking polls, until level 0, one more pump)."""
    Pool, _, sched, cfg = PAIRS[name]
    st = synthetic.burst_stream(600, 12, 2_000, burst_factor=2.0, seed=3)
    lad = sched.LadderConfig(patience=1, recover_patience=1, hi_rounds=2.0,
                             lo_rounds=0.5)
    pool = Pool(cfg, capacity=2, buckets=(128,), policy="ladder",
                ladder=lad, ring_rounds=2, drain_mode="sync",
                readout=readout)
    seen = _capture(pool)
    lanes = (pool.connect(qos="standard", seed=0),
             pool.connect(qos="premium", seed=1))
    outs = {i: [] for i in range(2)}
    traj, top_stats = [], None
    for j in range(12):
        for lane in lanes:
            pool.feed(lane, *_window(st, j, 2_000))
        pool.pump_rounds(1)
        traj.append(pool.pool_stats()["ladder_level"])
        if traj[-1] >= 3 and top_stats is None:
            top_stats = [pool.stats(lane) for lane in lanes]
    for _ in range(20):
        pool.pump()
        for i, lane in enumerate(lanes):
            outs[i].append(pool.poll(lane, wait=False))
        traj.append(pool.pool_stats()["ladder_level"])
        if traj[-1] == 0:
            break
    pool.pump()
    for i, lane in enumerate(lanes):
        outs[i].append(pool.flush(lane))
    res = dict(traj=traj, seen=seen, top=top_stats,
               stats=[pool.stats(lane) for lane in lanes],
               pool=pool.pool_stats(),
               once=pool.executors_compiled_once(),
               out={i: (np.concatenate([o[0] for o in v]),
                        np.concatenate([o[1] for o in v]))
                    for i, v in outs.items()})
    pool.close()
    return res


@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_pool_ladder_degrades_standard_spares_premium_then_recovers(
        readout):
    """The standard lane descends to shed (tier 3: ``lut_every`` x4, shed)
    while the premium lane keeps full quality, both recover to tier 0
    without a recompile; every pass, the level trajectory, the lanes'
    stats at the top and at the end, the results and ``pool_stats()``
    equal the JAX pool's."""
    got, want = (_serve_ladder(n, readout) for n in ("torch", "jax"))
    assert got["traj"] == want["traj"]
    assert max(got["traj"]) == 3 and got["traj"][-1] == 0
    std, prm = got["top"]
    assert (std["ladder_tier"], std["ctrl_shed"], std["ctrl_lut_every"]) \
        == (3, True, CFG.lut_every_chunks * 4)
    assert (prm["ladder_tier"], prm["ctrl_shed"], prm["ctrl_lut_every"]) \
        == (0, False, CFG.lut_every_chunks)
    assert got["pool"]["shed_events_total"] > 0
    assert got["pool"]["ladder_transitions"] == 6      # 0-3 and back
    assert got["pool"]["ctrl_batched_writes"] == 0     # one lane a pass
    std = got["stats"][0]
    assert (std["ladder_tier"], std["ctrl_shed"], std["ctrl_lut_every"]) \
        == (0, False, CFG.lut_every_chunks)
    assert got["once"]
    assert_passes_equal(got["seen"], want["seen"])
    for g, w in zip(got["top"] + got["stats"], want["top"] + want["stats"]):
        hx.assert_stats_equal(g, w)
    hx.assert_results(got["out"], want["out"])
    hx.assert_stats_equal(got["pool"], want["pool"])


def test_pool_ladder_poll_nonblocking_never_actuates():
    """``poll(wait=False)`` observes nothing and writes no knob; the next
    pump observes, decides and actuates; as the JAX pool."""
    st = synthetic.shapes_stream(duration_us=60_000, seed=2)
    runs = {}
    for name, (Pool, _, sched, cfg) in PAIRS.items():
        pool = Pool(cfg, capacity=1, buckets=(128,), policy="ladder",
                    ladder=sched.LadderConfig(patience=1, hi_rounds=1.0))
        seen = _capture(pool)
        lane = pool.connect(qos="standard", seed=0)
        pool.feed(lane, st.xy[:1000], st.ts[:1000])
        ctrl = [np.array(leaf) for leaf in pool._states.ctrl]
        for _ in range(4):
            pool.poll(lane, wait=False)
        before = (len(seen), pool.pool_stats()["ladder_level"],
                  pool.stats(lane)["ladder_tier"],
                  all(np.array_equal(a, np.asarray(b)) for a, b in
                      zip(ctrl, pool._states.ctrl)))
        pool.pump()
        runs[name] = (before, pool.pool_stats(), pool.stats(lane), seen)
        pool.close()
    got, want = runs["torch"], runs["jax"]
    assert got[0] == (0, 0, 0, True)
    assert (got[1]["ladder_level"], got[2]["ladder_tier"]) == (1, 1)
    assert_passes_equal(got[3], want[3])
    hx.assert_stats_equal(got[1], want[1])
    hx.assert_stats_equal(got[2], want[2])


def test_pool_ladder_tier_survives_disconnect_via_reactuation():
    """A degraded lane's slot goes to a fresh session at neutral knobs,
    which the ladder, still up, actuates again on the next pump."""
    st = synthetic.shapes_stream(duration_us=60_000, seed=4)
    runs = {}
    for name, (Pool, _, sched, cfg) in PAIRS.items():
        pool = Pool(cfg, capacity=1, buckets=(128,), policy="ladder",
                    ladder=sched.LadderConfig(patience=1,
                                              recover_patience=10,
                                              hi_rounds=1.0))
        lane = pool.connect(qos="standard", seed=0)
        pool.feed(lane, st.xy[:1000], st.ts[:1000])
        pool.pump_rounds(1)
        first = pool.stats(lane)
        pool.disconnect(lane)
        lane2 = pool.connect(qos="standard", seed=1)
        fresh = pool.stats(lane2)
        pool.feed(lane2, st.xy[:1000], st.ts[:1000])
        pool.pump_rounds(1)
        runs[name] = (lane2 == lane, first, fresh, pool.stats(lane2),
                      pool.pool_stats(), pool.executors_compiled_once())
        pool.close()
    got, want = runs["torch"], runs["jax"]
    assert got[0] and got[5]
    assert got[1]["ladder_tier"] >= 1
    assert (got[2]["ladder_tier"], got[2]["ctrl_lut_every"]) == (
        0, CFG.lut_every_chunks)
    assert got[3]["ladder_tier"] >= 1
    assert got[4]["ladder_transitions"] == 2
    for g, w in zip(got[1:5], want[1:5]):
        hx.assert_stats_equal(g, w)


def test_ladder_and_pack_pools_construct_and_refuse_unknown_qos():
    """``policy="ladder"`` / ``"pack"`` and ``ladder=`` serve (no longer
    refused); the ladder refuses a QoS class it does not know, other
    policies carry the class as a label; the scheduler is wired with the
    config's refresh interval and the runtime's top operating point."""
    cfg = dataclasses.replace(CFG, dvfs=True, dvfs_online=True)
    lad = tsched.LadderConfig(classes=(("bronze", 1), ("gold", 0)))
    pool = TPool(cfg, capacity=2, policy="ladder", ladder=lad)
    assert isinstance(pool.scheduler, tsched.DegradationLadder)
    assert pool.scheduler.ladder is lad
    assert pool.scheduler.knobs_for_tier(0) == (CFG.lut_every_chunks,
                                                pool.vdd_top, False)
    assert pool.vdd_top > 0
    with pytest.raises(ValueError, match="QoS"):
        pool.connect(qos="standard")
    assert pool.stats(pool.connect(qos="gold"))["qos"] == "gold"
    pool.close()
    pool = TPool(CFG, capacity=1, policy="pack", migrate_patience=4,
                 buckets=(128, 256))
    assert isinstance(pool.scheduler, tsched.PackScheduler)
    assert pool.scheduler.patience == 4
    assert pool.stats(pool.connect(qos="whatever"))["qos"] == "whatever"
    assert pool.pool_stats()["pack_moves"] == 0
    pool.close()


def test_lane_stats_overload_fields():
    st = synthetic.shapes_stream(duration_us=30_000, seed=0)
    runs = {}
    for name, (Pool, _, _, cfg) in PAIRS.items():
        pool = Pool(cfg, capacity=1)
        lane = pool.connect(seed=0)
        seq = [pool.stats(lane)]
        pool.feed(lane, st.xy[:300], st.ts[:300])
        seq.append(pool.stats(lane))
        pool.pump()
        pool.poll(lane)
        seq.append(pool.stats(lane))
        runs[name] = seq
        pool.close()
    got, want = runs["torch"], runs["jax"]
    assert [s["backlog_rounds"] for s in got] == [0, 2, 0]
    assert (got[2]["qos"], got[2]["ladder_tier"], got[2]["shed_events"]) \
        == ("standard", 0, 0)
    assert isinstance(got[0]["last_drain_wait_s"], float)
    for g, w in zip(got, want):
        hx.assert_stats_equal(g, w)


# ---------------------------------------------------------------------------
# Witness counters (tests/test_pump_pipeline.py:365-445)
# ---------------------------------------------------------------------------


def test_observation_memoized_on_lane_generation():
    """Idle passes reuse every lane's cached observation; a feed rebuilds
    it; the counters equal the JAX pool's pass for pass."""
    st = synthetic.ramp_stream([256] * 2, 5_000, seed=6)
    runs = {}
    for name, (Pool, _, sched, cfg) in PAIRS.items():
        pool = Pool(cfg, capacity=2, ring_rounds=2, buckets=(128,),
                    policy="ladder", ladder=sched.LadderConfig())
        lane = pool.connect()
        pool.feed(lane, st.xy, st.ts)
        while pool.pump_rounds(2):
            pass
        counts = [pool.pool_stats()]
        for _ in range(4):
            pool.pump_rounds(2)
        counts.append(pool.pool_stats())
        pool.feed(lane, st.xy[:128], st.ts[:128])
        pool.pump_rounds(2)
        counts.append(pool.pool_stats())
        pool.flush(lane)
        pool.disconnect(lane)
        runs[name] = [(c["observation_rebuilds"], c["observation_reuses"])
                      for c in counts]
        pool.close()
    got, want = runs["torch"], runs["jax"]
    assert got == want
    (b0, u0), (b1, u1), (b2, _) = got
    assert b1 == b0 and u1 >= u0 + 4 and b2 > b1


def test_knob_actions_coalesce_into_one_batched_write():
    """A ladder step that moves several lanes in one pass is one coalesced
    write (``ctrl_batched_writes`` / ``ctrl_actions_coalesced`` as the JAX
    pool's) and lands the same ``ctrl`` leaves as ``set_lane_control``
    writing the same values lane by lane, which counts no batched write.
    Both pools drain synchronously: the stats are read between pumps,
    where an async reader's fetch counts would depend on thread timing."""
    st = synthetic.ramp_stream([400] * 10, CFG.dvfs_cfg.half_us, seed=7)
    runs = {}
    for name, (Pool, _, sched, cfg) in PAIRS.items():
        lad = sched.LadderConfig(hi_rounds=0.5, lo_rounds=0.1, patience=1,
                                 recover_patience=1,
                                 classes=(("standard", 3),))
        pool = Pool(cfg, capacity=3, ring_rounds=2, buckets=(128,),
                    policy="ladder", ladder=lad, drain_mode="sync")
        lanes = [pool.connect() for _ in range(3)]
        for j in range(8):
            for lane in lanes:
                pool.feed(lane, *_window(st, j, cfg.dvfs_cfg.half_us))
            pool.pump_rounds(2)
        knobs = [(s["ctrl_lut_every"], s["ctrl_vdd_cap"], s["ctrl_shed"])
                 for s in (pool.stats(lane) for lane in lanes)]
        ctrl = [np.array(leaf) for leaf in pool._states.ctrl]
        runs[name] = (knobs, ctrl, pool.pool_stats())
        pool.close()
    (knobs, ctrl, ps), want = runs["torch"], runs["jax"]
    assert ps["ctrl_batched_writes"] >= 1 and \
        ps["ctrl_actions_coalesced"] >= 2, ps
    assert knobs == want[0]
    for g, w in zip(ctrl, want[1]):
        np.testing.assert_array_equal(g, w)
    hx.assert_stats_equal(ps, want[2])
    ref = TPool(CFG, capacity=3, ring_rounds=2, buckets=(128,))
    rlanes = [ref.connect() for _ in range(3)]
    for lane, (lut, cap, shed) in zip(rlanes, knobs):
        ref.set_lane_control(lane, lut_every=lut, vdd_cap=cap, shed=shed)
    assert ref.pool_stats()["ctrl_batched_writes"] == 0
    for g, w in zip(ref._states.ctrl, ctrl):
        np.testing.assert_array_equal(g, w)
    ref.close()


# ---------------------------------------------------------------------------
# Packing (tests/test_pump_pipeline.py:202-285)
# ---------------------------------------------------------------------------


def _replay(cfg, xy, ts, start_bucket, log):
    """A session fed the same stream, rebucketed at each logged
    ``(events_folded, from, to)`` boundary."""
    det = StreamingDetector(cfg, chunk=start_bucket, seed=cfg.seed)
    parts, cur = [], 0
    for m, _frm, to in log:
        parts.append(det.feed(xy[cur:m], ts[cur:m]))
        det.rebucket(to)
        cur = m
    parts.append(det.feed(xy[cur:], ts[cur:]))
    parts.append(det.flush())
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), det)


def _serve_pack(name, drain_mode, overflow):
    """One busy 128-chunk lane, two sparse 512-chunk lanes and a churn
    lane that joins at window 3 and leaves at window 7."""
    Pool, _, _, cfg = PAIRS[name]
    cfg = dataclasses.replace(cfg, chunk=256)
    half = cfg.dvfs_cfg.half_us
    busy = synthetic.ramp_stream([96] * 12, half, seed=21)
    sparse = [synthetic.ramp_stream([100] * 12, half, seed=31 + i)
              for i in range(2)]
    churn = synthetic.ramp_stream([300] * 4, half, seed=41)
    pool = Pool(cfg, capacity=4, ring_rounds=4, buckets=(128, 512),
                policy="pack", migrate_patience=2, drain_mode=drain_mode,
                on_overflow=overflow)
    seen = _capture(pool)
    lanes = [pool.connect(seed=cfg.seed, chunk=128)]
    lanes += [pool.connect(seed=cfg.seed, chunk=512) for _ in range(2)]
    streams = {lanes[0]: busy, lanes[1]: sparse[0], lanes[2]: sparse[1]}
    out = {lane: [] for lane in lanes}
    out["churn"] = []
    logs, churn_lane = {}, None
    for j in range(12):
        if j == 3:
            churn_lane = pool.connect(seed=cfg.seed, chunk=512)
        for lane, st in streams.items():
            pool.feed(lane, *_window(st, j, half))
        if churn_lane is not None:
            pool.feed(churn_lane, *_window(churn, j - 3, half))
        pool.pump()
        for lane in lanes:
            out[lane].append(pool.poll(lane))
        if churn_lane is not None:
            out["churn"].append(pool.poll(churn_lane))
        if j == 7:
            out["churn"].append(pool.flush(churn_lane))
            logs["churn"] = pool.disconnect(churn_lane)
            churn_lane = None
    for lane in lanes:
        out[lane].append(pool.flush(lane))
        logs[lane] = pool.disconnect(lane)
    res = dict(seen=seen, logs=logs, pool=pool.pool_stats(),
               once=pool.executors_compiled_once(), cfg=cfg,
               streams={**streams, "churn": churn},
               out={k: (np.concatenate([o[0] for o in v]),
                        np.concatenate([o[1] for o in v]))
                    for k, v in out.items()})
    pool.close()
    return res


@pytest.mark.parametrize("drain_mode,overflow", [("sync", "drain"),
                                                 ("async", "drop_oldest")])
def test_pack_policy_matches_reference_and_rebucket_replay(drain_mode,
                                                           overflow):
    """``policy="pack"`` consolidates the fleet into one bucket; every
    pass (observation and moves), the migration logs, results, stats and
    ``pool_stats()`` (``pack_moves``, ``pack_saved_slots``) equal the JAX
    pool's; each lane equals a rebucket replay at its logged boundaries,
    books included; nothing changes a block shape."""
    got, want = (_serve_pack(n, drain_mode, overflow)
                 for n in ("torch", "jax"))
    ps = got["pool"]
    assert ps["pack_moves"] >= 1 and ps["pack_saved_slots"] > 0, ps
    assert got["once"]
    finals = {got["logs"][k]["bucket"] for k in got["logs"] if k != "churn"}
    assert len(finals) == 1
    assert_passes_equal(got["seen"], want["seen"])
    hx.assert_stats_equal(ps, want["pool"])
    for key, st in got["streams"].items():
        lg = got["logs"][key]
        hx.assert_stats_equal(lg, want["logs"][key])
        start = 128 if key == 0 else 512
        s, k, det = _replay(got["cfg"], st.xy, st.ts, start,
                            lg["migration_log"])
        np.testing.assert_array_equal(got["out"][key][0], s, str(key))
        np.testing.assert_array_equal(got["out"][key][1], k)
        assert (lg["energy_pj"], lg["kept_total"]) == (det.energy_pj,
                                                       det.kept_total)
    hx.assert_results(got["out"], want["out"])
