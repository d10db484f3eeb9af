"""The pool's driver-facing API on the port against the reference:
``DetectorPool.warmup``, ``.scheduler``, ``.emit_metrics`` and
``PoolRuntime.compile_cache_size`` (the calls the benches and the
``serve_events`` CLI make).  A port pool and a ``repro.serve.DetectorPool``
take the same warmup slab and the same churn of connects, feeds and
disconnects afterwards.  Bounds: see ``_torch_pool_harness`` (stats equal
apart from wall-clock keys; results exact, scores within ``1e-5 *
max|R|``)."""
import pytest

torch = pytest.importorskip("torch")

import _torch_pool_harness as hx  # noqa: E402
from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro_torch.obs.schema import steady_record  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


class _MemorySink:
    def __init__(self):
        self.records = []

    def emit(self, record):
        self.records.append(record)


def _drive(Pool, cfg, streams, ring_rounds):
    """Warm a 3-lane pool on stream 0, then churn: two tenants, one leaves
    and a third takes its slot, every lane flushed and released."""
    pool = Pool(cfg, 3, ring_rounds=ring_rounds)
    sink = _MemorySink()
    pool.metrics.attach(sink)
    try:
        pool.warmup(*streams[0])
        got = dict(warm_stats=pool.pool_stats(),
                   warm_sizes=pool.compile_cache_sizes(),
                   warm_size=pool.compile_cache_size(),
                   policy=pool.scheduler.policy)
        out = {}
        a, b = pool.connect(seed=3), pool.connect(seed=4)
        for i, lane in ((1, a), (2, b)):
            xy, ts = streams[i]
            pool.feed(lane, xy[:300], ts[:300])
        pool.pump()
        out[1] = pool.flush(a)
        pool.disconnect(a)
        c = pool.connect(seed=5)
        xy, ts = streams[3]
        pool.feed(c, xy, ts)
        xy, ts = streams[2]
        pool.feed(b, xy[300:], ts[300:])
        pool.pump()
        out[3] = pool.flush(c)
        out[2] = pool.flush(b)
        pool.disconnect(b)
        pool.disconnect(c)
        got.update(out=out, churn_sizes=pool.compile_cache_sizes(),
                   churn_size=pool.compile_cache_size(),
                   once=pool.executors_compiled_once(),
                   record=pool.emit_metrics(), sink=sink.records)
        return got
    finally:
        pool.close()


@pytest.fixture(scope="module", params=[4, 1], ids=["K4", "K1"])
def warmed(request, one_torch_thread):
    """Both pools through ``_drive`` with ``ring_rounds`` K (the K-block
    executor and the 1-round path; with K=1 both pumps take the block)."""
    jc, tc = hx.cfg_pair("dvfs_online")
    streams = hx.make_streams([700, 650, 800, 400], seed=30)
    return (_drive(hx.TPool, tc, streams, request.param),
            _drive(hx.JPool, jc, streams, request.param))


def test_warmup_pool_stats_match_reference(warmed):
    t, j = warmed
    hx.assert_stats_equal(t["warm_stats"], j["warm_stats"])
    assert t["warm_stats"]["active"] == 0


def test_compile_cache_size_matches_reference(warmed):
    t, j = warmed
    for key in ("warm_sizes", "warm_size", "churn_sizes", "churn_size"):
        assert t[key] == j[key], key
    assert t["warm_size"] == sum(n for d in t["warm_sizes"].values()
                                 for n in d.values())
    assert t["churn_size"] == t["warm_size"]
    assert t["once"] and j["once"]


def test_scheduler_policy_matches_reference(warmed):
    t, j = warmed
    assert t["policy"] == j["policy"] == "static"


def test_emit_metrics_record_matches_reference(warmed):
    """The record equals the reference's apart from wall-clock keys, and
    the attached sink received it."""
    t, j = warmed
    rec, want = t["record"], j["record"]
    assert rec.keys() == want.keys()
    assert rec["kind"] == "pool"
    assert rec["scheduler"] == want["scheduler"] == {"policy": "static"}

    hx.assert_stats_equal(steady_record(rec), steady_record(want))
    assert t["sink"] == [rec]
    assert len(j["sink"]) == 1


def test_results_after_warmup_match_reference(warmed):
    t, j = warmed
    hx.assert_results(t["out"], j["out"])
