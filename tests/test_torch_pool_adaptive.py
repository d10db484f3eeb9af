"""The port's adaptive serving pool (``policy="adaptive"``: rate-aware live
bucket migration, ``set_lane_control`` and shedding) on the CPU, against
the JAX package's pool, its golden adaptive replay and a
``StreamingDetector.rebucket`` replay.

Bounds: ``tests/data/golden_stats.json`` value for value apart from the
wall-clock keys; a migrated lane bit-equal to the port's own rebucket
replay (scores, kept, books, final state); against the JAX pool, kept
masks, states, stats, migration logs and ``pool_stats()`` exact, scores
within ``1e-5 * max|R_ref|`` (``_torch_pool_harness``).
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_golden_stats as golden_ref  # noqa: E402
import _torch_pool_harness as hx  # noqa: E402
from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro.core import pipeline as jp  # noqa: E402
from repro.serve import AdaptiveScheduler as JAdaptive  # noqa: E402
from repro.serve import DetectorPool as JPool  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import state as ts_  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402
from repro_torch.serve import AdaptiveScheduler, DetectorPool  # noqa: E402
from repro_torch.serve import DegradationLadder, PackScheduler  # noqa: E402
from repro_torch.serve import StaticScheduler, StreamingDetector  # noqa: E402
from repro_torch.serve import runtime as runtime_mod  # noqa: E402
from repro_torch.serve.scheduler import make_scheduler  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# The reference's migration fixtures run at its default sensor (180x240).
CFG = tp.PipelineConfig(chunk=256, lut_every_chunks=2, device="cpu")
JCFG = jp.PipelineConfig(chunk=256, lut_every_chunks=2)
HALF = CFG.dvfs_cfg.half_us


def _ramp(rates, seed, cfg=CFG):
    st = synthetic.ramp_stream(rates, cfg.dvfs_cfg.half_us,
                               height=cfg.height, width=cfg.width, seed=seed)
    return st.xy, st.ts


def _window(stream, j, half=HALF):
    xy, ts = stream
    m = (ts // half) == j
    return xy[m], ts[m]


# ---------------------------------------------------------------------------
# The golden adaptive replay (tests/test_golden_stats.py)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def golden_replay(one_torch_thread):
    """The reference's fleet (``test_golden_stats.replay``) through the
    port's pool and session on the CPU."""
    cfg = tp.PipelineConfig(chunk=64, lut_every_chunks=2, device="cpu")
    half = cfg.dvfs_cfg.half_us
    streams = [synthetic.ramp_stream(golden_ref.RATES, half,
                                     seed=golden_ref.SEED + s)
               for s in range(golden_ref.N_LANES)]
    pool = DetectorPool(cfg, capacity=golden_ref.N_LANES, ring_rounds=4,
                        buckets=(64, 256), policy="adaptive",
                        migrate_patience=2, drain_mode="sync",
                        pipeline_depth=2)
    lanes = {i: pool.connect(seed=golden_ref.SEED + i, chunk=64)
             for i in range(golden_ref.N_LANES)}
    pool.set_lane_control(lanes[1], lut_every=3, shed=True)
    for j in range(len(golden_ref.RATES)):
        for i, lane in lanes.items():
            pool.feed(lane, *_window((streams[i].xy, streams[i].ts), j,
                                     half))
        pool.pump()
        for lane in lanes.values():
            pool.poll(lane)
    pool.flush(lanes[2])
    lane_stats = {str(i): pool.stats(lanes[i])
                  for i in range(golden_ref.N_LANES)}
    ps = pool.pool_stats()
    snap = pool.metrics.snapshot()
    compiled_once = pool.executors_compiled_once()
    pool.close()

    det = StreamingDetector(cfg, seed=golden_ref.SEED)
    det.feed(streams[0].xy, streams[0].ts)
    det.flush()
    return dict(lane=lane_stats, pool=ps, session=det.stats(), snap=snap,
                compiled_once=compiled_once,
                golden=json.loads(Path(golden_ref.GOLDEN).read_text()))


def test_golden_replay_lane_stats(golden_replay):
    live = golden_ref._jsonify(golden_replay["lane"])
    golden_ref._assert_same(golden_replay["golden"]["lane_stats"], live,
                            "lane_stats")
    assert live["1"]["shed_events"] == 232
    assert golden_replay["compiled_once"]


def test_golden_replay_pool_stats(golden_replay):
    ps = dict(golden_replay["pool"])
    ps["buckets"] = {str(b): d for b, d in ps["buckets"].items()}
    live = golden_ref._jsonify(ps)
    golden_ref._assert_same(golden_replay["golden"]["pool_stats"], live,
                            "pool_stats")
    assert (live["migrations_total"], live["shed_events_total"]) == (3, 232)
    for name in ("migrations_total", "host_fetches", "rounds_executed"):
        assert golden_replay["snap"][name] == ps[name], name


def test_golden_replay_session_stats(golden_replay):
    live = golden_ref._jsonify(golden_replay["session"])
    golden_ref._assert_same(golden_replay["golden"]["session_stats"], live,
                            "session_stats")


# ---------------------------------------------------------------------------
# Migration against the rebucket replay and the JAX pool
# (tests/test_pool_ring.py:389, :465)
# ---------------------------------------------------------------------------

RATES = [100] * 5 + [512] * 8                 # ~100 -> 512 events/half-win


def _serve_migrating(Pool, cfg, drain_mode, overflow):
    """The reference's migration fleet: two ramp lanes connect at 128 and
    grow into 512, a churn lane joins at window 3 and leaves at window 7.
    Returns per-lane results, final states and stats, the churn lane's
    flushed scores, and the pool."""
    ramps = [_ramp(RATES, 11 + i) for i in range(2)]
    churn = _ramp([300] * 4, 40)
    pool = Pool(cfg, capacity=3, ring_rounds=4, buckets=(128, 512),
                policy="adaptive", migrate_patience=2,
                drain_mode=drain_mode, on_overflow=overflow)
    try:
        lanes = [pool.connect(seed=cfg.seed, chunk=128) for _ in range(2)]
        out = {i: ([], []) for i in range(2)}
        churn_lane, churn_out = None, None
        for j in range(len(RATES)):
            if j == 3:
                churn_lane = pool.connect(seed=cfg.seed, chunk=512)
                pool.feed(churn_lane, *churn)
            for i, lane in enumerate(lanes):
                pool.feed(lane, *_window(ramps[i], j))
            pool.pump()
            for i, lane in enumerate(lanes):
                s, k = pool.poll(lane)
                out[i][0].append(s)
                out[i][1].append(k)
            if j == 7:
                churn_out = pool.flush(churn_lane)
                assert pool.disconnect(churn_lane)["migrations"] == 0
        states, stats = {}, {}
        for i, lane in enumerate(lanes):
            s, k = pool.flush(lane)
            out[i][0].append(s)
            out[i][1].append(k)
            if Pool is DetectorPool:
                states[i] = ts_.state_to_numpy(ts_.lane_state(pool._states,
                                                              lane))
            stats[i] = pool.disconnect(lane)
        res = {i: (np.concatenate(out[i][0]), np.concatenate(out[i][1]))
               for i in range(2)}
        return dict(res=res, states=states, stats=stats,
                    churn=churn_out, ramps=ramps, churn_stream=churn,
                    pool_stats=pool.pool_stats(),
                    compiled_once=pool.executors_compiled_once())
    finally:
        pool.close()


def _rebucket_replay(cfg, xy, ts, start_bucket, log):
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


@pytest.mark.parametrize("drain_mode", ["sync", "async"])
@pytest.mark.parametrize("overflow", ["drain", "drop_oldest"])
def test_adaptive_migration_bitexact_vs_rebucket_replay(drain_mode,
                                                        overflow):
    """Each ramp lane migrates up, and its readout (scores, kept, float64
    books, final state) equals a rebucket replay at its logged
    boundaries; the churn lane equals ``run_pipeline`` at 512 and never
    migrates; nothing recompiles.  The migration logs, results, final
    stats and ``pool_stats()`` equal the JAX pool's on the same streams."""
    got = _serve_migrating(DetectorPool, CFG, drain_mode, overflow)
    want = _serve_migrating(JPool, JCFG, drain_mode, overflow)
    assert got["compiled_once"]
    ref = tp.run_pipeline(*got["churn_stream"],
                          dataclasses.replace(CFG, chunk=512))
    np.testing.assert_array_equal(got["churn"][0], ref.scores)
    np.testing.assert_array_equal(got["churn"][1], ref.kept)
    assert got["pool_stats"]["migrations_total"] >= 2
    for i in range(2):
        st = got["stats"][i]
        assert st["migrations"] >= 1 and st["bucket"] == 512, st
        s, k, det = _rebucket_replay(CFG, *got["ramps"][i], 128,
                                     st["migration_log"])
        np.testing.assert_array_equal(got["res"][i][0], s)
        np.testing.assert_array_equal(got["res"][i][1], k)
        assert (st["energy_pj"], st["kept_total"]) == (det.energy_pj,
                                                       det.kept_total)
        one = got["states"][i]
        solo = ts_.state_to_numpy(det.state)
        for f in ("surface", "sae", "lut", "key", "chunk_idx", "kept_total",
                  "energy_pj", "latency_ns"):
            np.testing.assert_array_equal(np.asarray(getattr(one, f)),
                                          np.asarray(getattr(solo, f)),
                                          err_msg=f)
        # the JAX pool on the same streams
        assert st["migration_log"] == want["stats"][i]["migration_log"]
        hx.assert_stats_equal(st, want["stats"][i])
    hx.assert_results(got["res"], want["res"])
    hx.assert_stats_equal(got["pool_stats"], want["pool_stats"])


def test_adaptive_migration_poll_cadence_collects_everything():
    """A lane drained only by non-blocking polls and a final flush still
    reads its whole stream once: staging delivered the pre-move rounds."""
    xy, ts = _ramp([100] * 4 + [512] * 6, 5)
    pool = DetectorPool(CFG, capacity=1, ring_rounds=8, buckets=(128, 512),
                        policy="adaptive", migrate_patience=2)
    lane = pool.connect(chunk=128, seed=CFG.seed)
    scored = 0
    for j in range(int(ts[-1] // HALF) + 1):
        pool.feed(lane, *_window((xy, ts), j))
        pool.pump()
        scored += pool.poll(lane, wait=False)[0].size
    scored += pool.flush(lane)[0].size
    assert pool.stats(lane)["migrations"] >= 1
    assert scored == len(ts)
    pool.close()


def test_nonblocking_poll_defers_migration_staging():
    """``poll(wait=False)`` never stages (staging may wait on the reader):
    the decision is parked and staged, then applied, by the next pump."""
    st = _ramp([512] * 4, 1)
    pool = DetectorPool(CFG, capacity=1, buckets=(128, 512),
                        policy="adaptive", migrate_patience=1)
    lane = pool.connect(chunk=128, seed=CFG.seed)
    for j in range(4):
        pool.feed(lane, *_window(st, j))
        pool.pump()
        pool.poll(lane, wait=False)
        if pool._deferred:
            break
    assert pool._deferred == {lane: 512}
    assert pool._rt.staged_migrations() == {}
    pool.pump()
    assert pool._deferred == {}
    s_ = pool.stats(lane)
    assert (s_["bucket"], s_["migrations"]) == (512, 1)
    pool.close()


# ---------------------------------------------------------------------------
# Staging edge cases (tests/test_donation.py, tests/test_pool_async.py)
# ---------------------------------------------------------------------------


def test_restage_and_cancel_migration():
    """Re-staging replaces the pending move; staging the current bucket
    cancels it; a wrong bucket is refused."""
    xy, ts = hx.make_streams([256])[0]
    cfg = dataclasses.replace(CFG, height=hx.H, width=hx.W)
    pool = DetectorPool(cfg, capacity=1, buckets=(128, 256, 512),
                        policy="adaptive")
    lane = pool.connect(seed=cfg.seed, chunk=128)
    pool.feed(lane, xy, ts)
    pool.pump()
    pool._rt.stage_migration(lane, 512)
    pool._rt.stage_migration(lane, 256)
    assert pool._rt.staged_migrations() == {lane: 256}
    assert pool.pool_stats()["migrations_staged"] == 1
    pool._rt.stage_migration(lane, 128)
    assert pool._rt.staged_migrations() == {}
    with pytest.raises(ValueError, match="not a configured bucket"):
        pool._rt.stage_migration(lane, 300)
    pool.pump()
    assert pool.stats(lane)["migrations"] == 0
    pool.close()


def test_knob_write_between_stage_and_apply_persists():
    """The port moves a lane without restoring a snapshot, so a knob write
    that falls between staging and the applying pump stays in force, on
    the state the step reads and in ``stats()`` alike.  (The JAX pool
    restores the snapshot taken at staging and so undoes such a write on
    its device state while its mirrors keep it.)"""
    xy, ts = hx.make_streams([512])[0]
    cfg = dataclasses.replace(CFG, height=hx.H, width=hx.W)
    pool = DetectorPool(cfg, capacity=1, buckets=(128, 512),
                        policy="adaptive")
    lane = pool.connect(seed=cfg.seed, chunk=128)
    pool.feed(lane, xy[:256], ts[:256])
    pool.pump()
    pool._rt.stage_migration(lane, 512)
    pool.set_lane_control(lane, lut_every=5)
    pool.feed(lane, xy[256:], ts[256:])
    pool.pump()
    st = pool.stats(lane)
    assert (st["bucket"], st["ctrl_lut_every"]) == (512, 5)
    assert int(pool._states.ctrl.lut_every[lane]) == 5
    pool.close()


@pytest.mark.parametrize("drain_mode", ["sync", "async"])
def test_disconnect_mid_migration_discards_staged_move(drain_mode):
    """A lane retired with a move staged takes the move with it: the
    slot's next tenant serves as ``run_pipeline`` at its own bucket."""
    xy, ts = hx.make_streams([512])[0]
    cfg = dataclasses.replace(CFG, height=hx.H, width=hx.W)
    pool = DetectorPool(cfg, capacity=1, buckets=(128, 512),
                        policy="adaptive", ring_rounds=2,
                        drain_mode=drain_mode)
    lane = pool.connect(seed=cfg.seed, chunk=128)
    pool.feed(lane, xy, ts)
    pool.pump()
    pool.poll(lane)
    pool._rt.stage_migration(lane, 512)
    assert pool.stats(lane)["migration_staged"]
    assert pool.disconnect(lane)["migrations"] == 0
    assert pool._rt.staged_migrations() == {}
    lane2 = pool.connect(seed=cfg.seed, chunk=128)
    assert lane2 == lane
    pool.feed(lane2, xy, ts)
    pool.pump()
    s, k = pool.flush(lane2)
    ref = tp.run_pipeline(xy, ts, dataclasses.replace(cfg, chunk=128))
    np.testing.assert_array_equal(s, ref.scores)
    np.testing.assert_array_equal(k, ref.kept)
    st = pool.stats(lane2)
    assert (st["bucket"], st["migrations"]) == (128, 0)
    assert pool.executors_compiled_once()
    pool.close()


def test_stage_migration_drops_decision_for_recycled_slot():
    """A decision that waited for the pump token while its session was
    retired and the slot reconnected is dropped, not applied to the new
    tenant."""
    xy, ts = hx.make_streams([256])[0]
    cfg = dataclasses.replace(CFG, height=hx.H, width=hx.W)
    pool = DetectorPool(cfg, capacity=1, buckets=(128, 512),
                        policy="adaptive")
    lane = pool.connect(seed=cfg.seed, chunk=128)
    pool.feed(lane, xy, ts)
    pool.pump()
    rt = pool._rt
    before = rt._lanes[lane]
    acquire = rt._acquire_pump

    def acquire_then_swap_tenant():
        acquire()
        if rt._lanes[lane] is before:
            rt._lanes[lane] = runtime_mod._Lane(128)

    rt._acquire_pump = acquire_then_swap_tenant
    rt.stage_migration(lane, 512)
    rt._acquire_pump = acquire
    assert rt.staged_migrations() == {}
    pool.pump()
    st = pool.stats(lane)
    assert (st["bucket"], st["migrations"]) == (128, 0)
    pool.close()


# ---------------------------------------------------------------------------
# AdaptiveScheduler against the reference's (tests/test_scheduler.py:56-153)
# ---------------------------------------------------------------------------

BUCKETS = (128, 256, 512)


@pytest.mark.parametrize("kw", [dict(), dict(patience=1, down_margin=0.9),
                                dict(patience=3, down_margin=0.5,
                                     up_margin=1.25)])
def test_adaptive_scheduler_matches_reference(kw):
    """``desired``, ``observe`` (with and without ``win``, several lanes,
    ``forget``) and ``order`` on seeded sequences, call for call."""
    rng = np.random.default_rng(len(kw))
    got, want = AdaptiveScheduler(BUCKETS, **kw), JAdaptive(BUCKETS, **kw)
    for b in BUCKETS:
        for w in np.concatenate([rng.uniform(0, 800, 200),
                                 [0, 115.2, 128, 129, 230.4, 512, 513]]):
            assert got.desired(b, w) == want.desired(b, w), (b, w)
    for use_win in (False, True):
        buckets = {lane: 128 for lane in range(3)}
        win = 0
        for _ in range(400):
            lane = int(rng.integers(0, 3))
            if rng.random() < 0.05:
                got.forget(lane)
                want.forget(lane)
                continue
            win += int(rng.random() < 0.4)
            rate = float(rng.choice([60.0, 120.0, 200.0, 300.0, 600.0]))
            w = win if use_win else None
            a = got.observe(lane, buckets[lane], rate, win=w)
            assert a == want.observe(lane, buckets[lane], rate, win=w)
            if a is not None:
                buckets[lane] = a
    for _ in range(50):
        backlog = {b: int(rng.integers(0, 4)) for b in BUCKETS
                   if rng.random() < 0.8}
        assert got.order(backlog) == want.order(backlog)
    assert got.order({}) == BUCKETS


def test_adaptive_scheduler_contract():
    s = AdaptiveScheduler(BUCKETS, patience=2)
    assert (s.policy, s.needs_backlog, s.needs_observation,
            s.needs_pump_observation) == ("adaptive", True, True, False)
    assert s.observe(0, 128, 200.0, win=7) is None
    assert s.observe(0, 128, 200.0, win=7) is None     # same window
    assert s.observe(0, 128, 200.0, win=8) == 256
    assert s.order({128: 0, 256: 4, 512: 1}) == (256, 512, 128)
    assert make_scheduler("adaptive", BUCKETS).policy == "adaptive"
    for bad in (dict(patience=0), dict(down_margin=1.5),
                dict(up_margin=0.0)):
        with pytest.raises(ValueError):
            AdaptiveScheduler(BUCKETS, **bad)
    assert isinstance(make_scheduler("ladder", BUCKETS), DegradationLadder)
    assert isinstance(make_scheduler("pack", BUCKETS), PackScheduler)
    with pytest.raises(ValueError, match="policy"):
        make_scheduler("greedy", BUCKETS)


def test_pool_scheduler_argument():
    cfg = dataclasses.replace(CFG, chunk=128)
    with pytest.raises(ValueError, match="do not match"):
        DetectorPool(cfg, capacity=1, buckets=(128, 256),
                     scheduler=StaticScheduler((128,)))
    sched = AdaptiveScheduler((128, 256), patience=5)
    pool = DetectorPool(cfg, capacity=1, buckets=(128, 256),
                        scheduler=sched)
    assert pool.scheduler is sched and pool.policy == "adaptive"
    pool.close()


# ---------------------------------------------------------------------------
# set_lane_control and shedding against the JAX pool
# ---------------------------------------------------------------------------

KNOB_RATES = [60] * 3 + [700] * 5 + [60] * 6      # up to 1024, back down


def _serve_knobs(Pool, cfg):
    """Three online-DVFS lanes with knob writes (clamped ones included)
    before and during a ramp that moves them up two buckets and back
    down; returns the results, the knob views after each write, the final
    stats and the pool."""
    streams = [_ramp(KNOB_RATES, 60 + i, cfg) for i in range(3)]
    pool = Pool(cfg, capacity=3, ring_rounds=2, buckets=(64, 256, 1024),
                policy="adaptive", migrate_patience=2, drain_mode="sync")
    try:
        lanes = [pool.connect(seed=5 + i, chunk=64) for i in range(3)]
        views = []

        def write(lane, **kw):
            pool.set_lane_control(lane, **kw)
            views.append([{k: v for k, v in pool.stats(ln).items()
                           if k.startswith("ctrl_") or k == "shed_events"}
                          for ln in lanes])

        write(lanes[0], lut_every=0, vdd_cap=99)     # both clamped
        write(lanes[1], shed=True, lut_every=3)
        write(lanes[2], vdd_cap=-4)                  # clamped to 0
        out = {i: [] for i in range(3)}
        for j in range(len(KNOB_RATES)):
            for i, lane in enumerate(lanes):
                pool.feed(lane, *_window(streams[i], j))
            if j == 5:
                write(lanes[1], shed=False)
                write(lanes[2], vdd_cap=1, lut_every=4)
                write(lanes[0], shed=True)           # sheds on entry
            pool.pump()
            for i, lane in enumerate(lanes):
                out[i].append(pool.poll(lane))
        for i, lane in enumerate(lanes):
            out[i].append(pool.flush(lane))
        res = {i: (np.concatenate([o[0] for o in v]),
                   np.concatenate([o[1] for o in v])) for i, v in out.items()}
        stats = [pool.stats(lane) for lane in lanes]
        return dict(res=res, views=views, stats=stats, vdd_top=pool.vdd_top,
                    pool_stats=pool.pool_stats(), pool=pool)
    finally:
        pool.close()


@pytest.fixture(scope="module")
def knobs(one_torch_thread):
    jc, tc = hx.cfg_pair("dvfs_online")
    return _serve_knobs(DetectorPool, tc), _serve_knobs(JPool, jc)


def test_set_lane_control_mirrors_and_clamps_match_reference(knobs):
    got, want = knobs
    assert got["vdd_top"] == want["vdd_top"] > 1
    assert hx._normal(got["views"]) == hx._normal(want["views"])
    first = got["views"][0][0]
    assert (first["ctrl_lut_every"], first["ctrl_vdd_cap"]) == (
        1, got["vdd_top"])
    assert got["views"][2][2]["ctrl_vdd_cap"] == 0


def test_shedding_and_stats_after_fold_match_reference(knobs):
    got, want = knobs
    hx.assert_results(got["res"], want["res"])
    for g, w in zip(got["stats"], want["stats"]):
        hx.assert_stats_equal(g, w)
    hx.assert_stats_equal(got["pool_stats"], want["pool_stats"])
    hx.assert_pool_states_equal(got["pool"], want["pool"])
    assert got["stats"][1]["shed_events"] > 0
    assert got["stats"][0]["shed_events"] > 0           # shed on entry
    assert got["pool_stats"]["shed_events_total"] == sum(
        s["shed_events"] for s in got["stats"])
    logs = [s["migration_log"] for s in got["stats"]]
    assert any(len(log) >= 2 and log[-1][2] < log[-1][1] for log in logs)
