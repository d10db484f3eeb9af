"""The port's ``DetectorPool`` (``policy="static"``) on the CPU against
``repro.serve.DetectorPool`` on the same feeds, and against the port's own
``run_pipeline`` per stream.  Bounds: see ``_torch_pool_harness``."""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_pool_harness as hx  # noqa: E402
from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import state as ts_  # noqa: E402
from repro_torch.serve import DetectorPool, LadderConfig  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = Path(__file__).parent / "data" / "golden_stats.json"


def _staggered(pool, cfg, streams):
    return hx.serve_staggered(pool, streams, seeds=[7, 8, 9, 10],
                              slab_rng_seed=cfg.chunk)


@pytest.fixture(scope="module", params=["ber_0.6V", "dvfs_online"])
def staggered(request, one_torch_thread):
    """Four streams joining and leaving a 5-lane pool, on both pools."""
    jc, tc = hx.cfg_pair(request.param)
    streams = hx.make_streams([900, 650, 1100, 500], seed=20)
    (t, tstats, tpool), (j, jstats, jpool) = hx.run_both(jc, tc, streams,
                                                         _staggered)
    return dict(cfg=tc, streams=streams, t=t, j=j, tstats=tstats,
                jstats=jstats, tpool=tpool, jpool=jpool)


def test_staggered_results_match_reference(staggered):
    hx.assert_results(staggered["t"][0], staggered["j"][0])


def test_staggered_lanes_equal_run_pipeline(staggered):
    cfg = staggered["cfg"]
    for i, (xy, ts) in enumerate(staggered["streams"]):
        ref = tp.run_pipeline(xy, ts, dataclasses.replace(cfg, seed=7 + i))
        got = staggered["t"][0][i]
        np.testing.assert_array_equal(got[0], ref.scores)
        np.testing.assert_array_equal(got[1], ref.kept)
        assert staggered["t"][1][i]["energy_pj"] == ref.energy_pj


def test_staggered_final_stats_and_states_match_reference(staggered):
    for i, want in staggered["j"][1].items():
        hx.assert_stats_equal(staggered["t"][1][i], want)
    hx.assert_stats_equal(staggered["tstats"], staggered["jstats"])
    hx.assert_pool_states_equal(staggered["tpool"], staggered["jpool"])
    assert staggered["tpool"].executors_compiled_once()


def test_stats_key_sets_match_golden(staggered):
    golden = json.loads(GOLDEN.read_text())
    pool_stats = staggered["tstats"]
    assert pool_stats.keys() == golden["pool_stats"].keys()
    bucket = next(iter(golden["pool_stats"]["buckets"].values()))
    for b in pool_stats["buckets"].values():
        assert b.keys() == bucket.keys()
        assert b["executables"].keys() == bucket["executables"].keys()
    lane_stats = staggered["t"][1][0]
    assert lane_stats.keys() == golden["lane_stats"]["0"].keys()


def _reuse(pool, cfg, streams):
    out = []
    for i, (xy, ts) in enumerate(streams):
        lane = pool.connect(seed=3 + i)
        pool.feed(lane, xy, ts)
        pool.pump()
        out.append(pool.flush(lane))
        out.append(pool.disconnect(lane))
    return out


def test_lane_reuse_after_disconnect():
    """A freed lane serves the next session from a clean state."""
    jc, tc = hx.cfg_pair("ber_0.6V")
    streams = hx.make_streams([700, 500], seed=30)
    tpool = DetectorPool(tc, capacity=1, drain_mode="sync")
    got = _reuse(tpool, tc, streams)
    tpool.close()
    from repro.serve import DetectorPool as JPool
    jpool = JPool(jc, capacity=1, drain_mode="sync")
    want = _reuse(jpool, jc, streams)
    jpool.close()
    for i, (xy, ts) in enumerate(streams):
        ref = tp.run_pipeline(xy, ts, dataclasses.replace(tc, seed=3 + i))
        np.testing.assert_array_equal(got[2 * i][0], ref.scores)
        np.testing.assert_array_equal(got[2 * i][1], ref.kept)
        hx.assert_results({0: got[2 * i]}, {0: want[2 * i]})
        hx.assert_stats_equal(got[2 * i + 1], want[2 * i + 1])
    hx.assert_pool_states_equal(tpool, jpool)


def test_idle_lane_state_is_untouched():
    """A connected lane that gets no events while another pumps keeps its
    state exactly (BER bits reach it in K1; the masked select undoes
    them), cursors and key included."""
    _, tc = hx.cfg_pair("ber_0.6V")
    pool = DetectorPool(tc, capacity=2, drain_mode="sync")
    busy = pool.connect(seed=1)
    idle = pool.connect(seed=2)
    before = ts_.state_to_numpy(ts_.lane_state(pool._states, idle))
    xy, ts = hx.make_streams([800], seed=40)[0]
    pool.feed(busy, xy, ts)
    assert pool.pump() == 800 // tc.chunk
    after = ts_.state_to_numpy(ts_.lane_state(pool._states, idle))
    pool.close()
    for name in ts_.DetectorState._fields:
        for x, y in zip(np.atleast_1d(getattr(before, name)),
                        np.atleast_1d(getattr(after, name))):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                          err_msg=name)
    busy_after = ts_.state_to_numpy(ts_.lane_state(pool._states, busy))
    assert int(busy_after.chunk_idx) == 800 // tc.chunk


def test_pool_refusals():
    _, tc = hx.cfg_pair("fixed")
    with pytest.raises(ValueError, match="8192"):
        DetectorPool(tc, capacity=2, buckets=(128, 16384))
    pool = DetectorPool(tc, capacity=2, shard=True)
    ps = pool.pool_stats()
    assert ps["sharded"] and ps["devices"] == 1     # a 1-wide lane mesh
    pool.close()
    for policy in ("adaptive", "ladder", "pack"):
        pool = DetectorPool(tc, capacity=2, policy=policy)
        assert pool.policy == policy
        pool.close()
    with pytest.raises(ValueError, match="lo_rounds"):
        LadderConfig(hi_rounds=1.0, lo_rounds=2.0)
    pool = DetectorPool(tc, capacity=2, policy="ladder",
                        ladder=LadderConfig(classes=(("gold", 0),)))
    with pytest.raises(ValueError, match="unknown QoS class"):
        pool.connect(qos="standard")
    pool.close()
    with pytest.raises(ValueError, match="policy"):
        DetectorPool(tc, capacity=2, policy="greedy")
    with pytest.raises(ValueError, match="incompatible with streaming"):
        DetectorPool(dataclasses.replace(tc, dvfs=True), capacity=2)
    pool = DetectorPool(tc, capacity=1, drain_mode="sync")
    lane = pool.connect()
    with pytest.raises(RuntimeError, match="pool full"):
        pool.connect()
    pool.disconnect(lane)
    with pytest.raises(KeyError):
        pool.feed(lane, np.zeros((1, 2), np.int32), np.zeros((1,), np.int64))
    pool.close()
