"""The port's ``DetectorPool`` on the TOS-update backends ``"nmc"`` /
``"batched"`` against ``repro.serve.DetectorPool`` on ``"pallas_nmc"`` /
``"pallas_batched"`` (interpret mode), with a mid-run join and leave as in
``tests/test_pool_ring.py``.  Bounds: see ``_torch_pool_harness``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_pool_harness as hx  # noqa: E402
from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro.core import pipeline as jp  # noqa: E402
from repro.serve import DetectorPool as JPool  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.serve import DetectorPool as TPool  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _streams():
    rng = np.random.default_rng(0)
    e, h, w = 768, 64, 64

    def one():
        return (np.stack([rng.integers(0, w, e), rng.integers(0, h, e)],
                         1).astype(np.int32),
                np.sort(rng.integers(0, 20_000, e)).astype(np.int64))
    return one(), one()


def _join_and_leave(pool, s0, s1, seed):
    """Lane a starts alone, b joins mid-run, a leaves while b is live."""
    a = pool.connect(seed=seed)
    pool.feed(a, s0[0][:400], s0[1][:400])
    pool.pump()
    b = pool.connect(seed=seed + 1)
    pool.feed(a, s0[0][400:], s0[1][400:])
    pool.feed(b, *s1)
    pool.pump()
    res_a = pool.flush(a)
    stats_a = pool.disconnect(a)
    res_b = pool.flush(b)
    return {0: res_a, 1: res_b}, stats_a


@pytest.mark.parametrize("ring_rounds", [1, 3])
@pytest.mark.parametrize("backend", ["nmc", "batched"])
def test_pool_tos_backends_match_reference(backend, ring_rounds):
    s0, s1 = _streams()
    base = dict(height=64, width=64, chunk=128, lut_every_chunks=2,
                **hx.MODES["dvfs_online"])
    jc = jp.PipelineConfig(backend=f"pallas_{backend}", **base)
    tc = tp.PipelineConfig(backend=backend, device="cpu", **base)
    pools = {}
    for key, Pool, cfg in (("t", TPool, tc), ("j", JPool, jc)):
        pool = Pool(cfg, capacity=2, ring_rounds=ring_rounds)
        try:
            pools[key] = (*_join_and_leave(pool, s0, s1, seed=5),
                          pool.pool_stats(), pool)
        finally:
            pool.close()
    (t, t_a, tstats, tpool), (j, j_a, jstats, jpool) = pools["t"], pools["j"]
    hx.assert_results(t, j)
    hx.assert_stats_equal(t_a, j_a)
    hx.assert_stats_equal(tstats, jstats)
    hx.assert_pool_states_equal(tpool, jpool)
    assert tpool.executors_compiled_once()
    for i, (st, seed) in enumerate(((s0, 5), (s1, 6))):
        ref = tp.run_pipeline(st[0], st[1], dataclasses.replace(tc,
                                                                seed=seed))
        np.testing.assert_array_equal(t[i][0], ref.scores)
        np.testing.assert_array_equal(t[i][1], ref.kept)
