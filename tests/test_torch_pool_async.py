"""The port's pool against the reference's across the async half of the
{sync, async} x {drain, drop_oldest} x {dense, compact} sweep, with
membership churn, and the port's results across pump pipeline depths
(1 = 2) and ring-of-rings depths (2 = 3).  Bounds: see
``_torch_pool_harness``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_pool_harness as hx  # noqa: E402
from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro_torch.serve import DetectorPool  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _churn(pool, cfg, streams):
    return hx.serve_churn(pool, cfg, streams, slab=600)


@pytest.fixture(scope="module")
def streams():
    return hx.make_streams([1700, 1500, 1300], seed=60)


@pytest.fixture(scope="module", params=["drain", "drop_oldest"])
def served(request, streams, one_torch_thread):
    """One reference pool (dense) and the port pool in both readouts: the
    reference's compact readout equals its dense one
    (``tests/test_compact_ring.py``); ``test_compact_cap_one_overflows_
    every_slot`` holds the port's compact accounting against the
    reference's compact pool."""
    jc, tc = hx.cfg_pair("dvfs_online")
    kw = dict(ring_rounds=3, drain_mode="async", on_overflow=request.param)
    ref = hx.run_pool(hx.JPool, jc, streams, _churn, **kw)
    return {r: hx.run_pool(hx.TPool, tc, streams, _churn, readout=r, **kw)
            for r in ("dense", "compact")}, ref


@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_async_sweep_results_match_reference(served, readout):
    ports, (j, _, _) = served
    hx.assert_results(ports[readout][0], j)


@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_async_sweep_stats_and_states_match_reference(served, readout):
    ports, (_, jstats, jpool) = served
    _, tstats, tpool = ports[readout]
    hx.assert_stats_equal(tstats, jstats,
                          skip=hx.READOUT_KEYS if readout == "compact"
                          else ())
    hx.assert_pool_states_equal(tpool, jpool)
    if tstats["on_overflow"] == "drop_oldest":
        assert tstats["dropped_rounds_confirmed"] > 0


@pytest.fixture(scope="module")
def default_depths(streams, one_torch_thread):
    _, tc = hx.cfg_pair("dvfs_online")
    return {r: hx.run_pool(hx.TPool, tc, streams, _churn, ring_rounds=3,
                           readout=r) for r in ("dense", "compact")}


def test_async_compact_accounting_matches_reference(streams):
    """The compact readout's D2H accounting (records, overflow rows, bytes
    saved) against the reference's compact pool, default cap."""
    jc, tc = hx.cfg_pair("dvfs_online")
    kw = dict(ring_rounds=3, readout="compact")
    (t, tstats, _), (j, jstats, _) = hx.run_both(jc, tc, streams, _churn,
                                                 **kw)
    hx.assert_results(t, j)
    hx.assert_stats_equal(tstats, jstats)
    assert tstats["d2h_bytes_saved"] > 0


@pytest.mark.parametrize("kw", [dict(pipeline_depth=1),
                                dict(pipeline_depth=3),
                                dict(ring_depth=3)],
                         ids=["pipeline_depth1", "pipeline_depth3",
                              "ring_depth3"])
@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_depths_do_not_change_results(default_depths, streams, kw,
                                      readout):
    """Against the port pool at the default depths (pipeline 2, ring 2)."""
    want, wstats, _ = default_depths[readout]
    _, tc = hx.cfg_pair("dvfs_online")
    got, gstats, _ = hx.run_pool(hx.TPool, tc, streams, _churn,
                                 ring_rounds=3, readout=readout, **kw)
    for k in want:
        np.testing.assert_array_equal(got[k][0], want[k][0])
        np.testing.assert_array_equal(got[k][1], want[k][1])
    assert gstats["rounds_executed"] == wstats["rounds_executed"]
    assert gstats["d2h_bytes"] == wstats["d2h_bytes"]
    if kw.get("pipeline_depth") == 1:
        assert gstats["pump_stages_overlapped"] == 0


def test_concurrent_clients_with_async_reader():
    """Four client threads feed, pump and poll their own lanes at once
    while the reader thread drains (thread switches forced often): every
    lane's results still equal ``run_pipeline`` on its stream, so no round
    was lost, duplicated or handed to the wrong lane."""
    import dataclasses
    import sys
    import threading

    from repro_torch.core import pipeline as tp

    _, tc = hx.cfg_pair("ber_0.6V")
    streams = hx.make_streams([1100, 900, 1000, 800], seed=70)
    pool = DetectorPool(tc, len(streams), ring_rounds=2, ring_depth=2)
    lanes = [pool.connect(seed=10 + i) for i in range(len(streams))]
    got = {i: [] for i in range(len(streams))}
    errors = []

    def client(i):
        try:
            xy, ts = streams[i]
            for start in range(0, len(ts), 170):
                pool.feed(lanes[i], xy[start:start + 170],
                          ts[start:start + 170])
                pool.pump()
                got[i].append(pool.poll(lanes[i]))
            got[i].append(pool.flush(lanes[i]))
        except Exception as e:          # reported by the main thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(streams))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        pool.close()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    for i, (xy, ts) in enumerate(streams):
        ref = tp.run_pipeline(xy, ts, dataclasses.replace(tc, seed=10 + i))
        np.testing.assert_array_equal(
            np.concatenate([s for s, _ in got[i]]), ref.scores)
        np.testing.assert_array_equal(
            np.concatenate([k for _, k in got[i]]), ref.kept)
