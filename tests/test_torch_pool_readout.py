"""The port's pool against the reference's across the sync half of the
{sync, async} x {drain, drop_oldest} x {dense, compact} sweep, with
membership churn, plus a compact readout whose one-record cap overflows
every slot.  The async half is ``test_torch_pool_async.py``.  Bounds: see
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
    return hx.make_streams([1700, 1500, 1300], seed=50)


@pytest.fixture(scope="module", params=["drain", "drop_oldest"])
def served(request, streams, one_torch_thread):
    """One reference pool (dense) and the port pool in both readouts: the
    reference's compact readout equals its dense one
    (``tests/test_compact_ring.py``); ``test_compact_cap_one_overflows_
    every_slot`` holds the port's compact accounting against the
    reference's compact pool."""
    jc, tc = hx.cfg_pair("dvfs_online")
    kw = dict(ring_rounds=3, drain_mode="sync", on_overflow=request.param)
    ref = hx.run_pool(hx.JPool, jc, streams, _churn, **kw)
    return {r: hx.run_pool(hx.TPool, tc, streams, _churn, readout=r, **kw)
            for r in ("dense", "compact")}, ref


@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_sync_sweep_results_match_reference(served, readout):
    ports, (j, _, _) = served
    hx.assert_results(ports[readout][0], j)


@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_sync_sweep_stats_and_states_match_reference(served, readout):
    ports, (_, jstats, jpool) = served
    _, tstats, tpool = ports[readout]
    hx.assert_stats_equal(tstats, jstats,
                          skip=hx.READOUT_KEYS if readout == "compact"
                          else ())
    hx.assert_pool_states_equal(tpool, jpool)
    if tstats["on_overflow"] == "drop_oldest":
        assert tstats["dropped_rounds_confirmed"] > 0
    else:
        assert tstats["pump_forced_drains"] > 0
    if tstats["readout"] == "compact":
        assert tstats["d2h_bytes_saved"] > 0


def test_compact_cap_one_overflows_every_slot(streams):
    jc, tc = hx.cfg_pair("ber_0.6V")
    kw = dict(ring_rounds=3, drain_mode="sync", readout="compact",
              compact_cap=1)
    (t, tstats, _), (j, jstats, _) = hx.run_both(jc, tc, streams, _churn,
                                                 **kw)
    hx.assert_results(t, j)
    hx.assert_stats_equal(tstats, jstats)
    assert tstats["d2h_compact_overflow_slots"] > 0
    dense = DetectorPool(tc, len(streams) + 1, ring_rounds=3,
                         drain_mode="sync")
    want = _churn(dense, tc, streams)
    dense.close()
    for k in want:
        np.testing.assert_array_equal(t[k][0], want[k][0])
        np.testing.assert_array_equal(t[k][1], want[k][1])
