"""The port's lane mesh (``repro_torch.launch.sharding``'s lane helpers) and
the serving pool's ``shard=True`` on the CPU, against the JAX package's
helpers, its ``run_pipeline`` and its pool built with ``shard=True``.

A CPU host has one CPU device, so the multi-shard pools here run on a
``LaneMesh`` of repeated CPU devices, patched in for ``local_lane_mesh``
(the counterpart of the reference's forced host devices).

Bounds: the helpers equal the reference's; every lane's kept mask
bit-equal to the JAX ``run_pipeline``, its scores bit-equal to the port's
own ``run_pipeline`` and within ``1e-5 * max|R_ref|`` of the JAX one (the
port's bound against the reference, ``_torch_pool_harness``); a sharded
pool's results, lane stats, migration logs, knobs and final states equal
to the unsharded port pool's; ``pool_stats()`` equal apart from the keys
named at each comparison (wall-clock keys are always dropped).
"""
import dataclasses
import types
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import _torch_pool_harness as hx  # noqa: E402
from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro.core import pipeline as jp  # noqa: E402
from repro.launch import sharding as jsh  # noqa: E402
from repro.serve import DetectorPool as JPool  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import state as ts_  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402
from repro_torch.launch import sharding as tsh  # noqa: E402
from repro_torch.meshctx import mesh_axes  # noqa: E402
from repro_torch.serve import DetectorPool  # noqa: E402
from repro_torch.serve.scheduler import Action  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CPU = torch.device("cpu")
# The reference's sharded-pool config and feeds (tests/test_pool_ring.py).
BASE = dict(chunk=256, lut_every_chunks=2, dvfs=True, dvfs_online=True)
CFG = tp.PipelineConfig(device="cpu", **BASE)
JCFG = jp.PipelineConfig(**BASE)
# The keys a padded lane moves: every upload and every ring slot is
# ``phys`` lanes wide.
PADDING_KEYS = ("h2d_event_slots", "h2d_padding_bytes", "d2h_bytes",
                "d2h_bytes_saved")


def _cpu_mesh(n):
    return tsh.LaneMesh((CPU,) * n)


def _patched(n):
    """``local_lane_mesh`` patched to return ``n`` CPU shards."""
    return mock.patch.object(tsh, "local_lane_mesh",
                             lambda *a, **k: _cpu_mesh(n))


def _stats_equal(got, want, skip):
    """``pool_stats()`` equal apart from ``skip`` (also in each bucket)."""
    g, w = hx._normal(got), hx._normal(want)
    for d in (g, w, *g["buckets"].values(), *w["buckets"].values()):
        for k in skip:
            d.pop(k, None)
    assert g == w


@pytest.fixture(scope="module")
def streams(one_torch_thread):
    """Three 25 ms shapes streams and the JAX and port ``run_pipeline`` of
    the prefixes the churn schedule serves (2,500, 2,500 and 1,500
    events)."""
    sts = [synthetic.shapes_stream(duration_us=25_000, seed=s)
           for s in range(3)]
    refs = {}
    for i, e in ((0, 2500), (1, 2500), (2, 1500)):
        refs[i] = (jp.run_pipeline(sts[i].xy[:e], sts[i].ts[:e], JCFG),
                   tp.run_pipeline(sts[i].xy[:e], sts[i].ts[:e], CFG))
    return sts, refs


def _assert_lane(scores, kept, ref):
    """A lane against (JAX, port) ``run_pipeline`` (the module's bounds)."""
    jref, tref = ref
    np.testing.assert_array_equal(kept, jref.kept)
    np.testing.assert_array_equal(kept, tref.kept)
    np.testing.assert_array_equal(scores, tref.scores)
    hx.close(scores, jref.scores)


# ---------------------------------------------------------------------------
# The helpers against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_lane_padded_capacity_matches_reference(n):
    mesh = types.SimpleNamespace(shape={"lanes": n})
    for cap in range(1, 18):
        got = tsh.lane_padded_capacity(cap, mesh)
        assert got == jsh.lane_padded_capacity(cap, mesh)
        assert got % n == 0 and cap <= got < cap + n


@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_lane_spec_matches_reference(k):
    assert tsh.lane_spec(k) == tuple(jsh.lane_spec(k))


def test_pinned_host_probe_and_local_mesh_on_cpu():
    assert tsh.pinned_host_sharding(CPU) is None
    assert jsh.pinned_host_sharding(jax.devices()[0]) is None
    assert not tsh.HostStager(CPU).pinned
    mesh = tsh.local_lane_mesh(device="cpu")
    assert mesh.devices == (CPU,)
    assert mesh_axes(mesh) == (("lanes",), {"lanes": 1})
    with pytest.raises(ValueError, match="2 devices asked for"):
        tsh.local_lane_mesh(2, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tsh.local_lane_mesh(device="cuda")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DetectorPool(dataclasses.replace(CFG, device="cuda"), 2,
                         shard=True)


def test_mesh_of_another_device_type_refused():
    """A CPU pool refuses a mesh of CUDA devices (built, never touched)."""
    cuda_mesh = tsh.LaneMesh((torch.device("cuda", 0),))
    with mock.patch.object(tsh, "local_lane_mesh",
                           lambda *a, **k: cuda_mesh):
        with pytest.raises(ValueError, match="cannot serve a pool on 'cpu'"):
            DetectorPool(CFG, 2, shard=True)


def test_lane_put_splits_replicates_and_gathers_back():
    mesh = _cpu_mesh(4)
    state = ts_.detector_init(CFG, seed=list(range(8)), device="cpu")
    state = state._replace(kept_total=torch.arange(8, dtype=torch.int32))
    tree = {"state": state, "scalar": torch.tensor(5), "host": np.int32(3)}
    shards = tsh.lane_put(mesh, tree)
    assert len(shards) == 4
    for j, part in enumerate(shards):
        assert part["state"].kept_total.tolist() == [2 * j, 2 * j + 1]
        assert part["state"].ctrl.lut_every.shape == (2,)
        assert part["state"].key.is_contiguous()
        assert part["state"].key.data_ptr() != state.key.data_ptr()
        assert int(part["scalar"]) == 5 and part["host"] == 3
    back = tsh._lane_gather(shards)
    assert int(back["scalar"]) == 5
    got = ts_.state_to_numpy(back["state"])
    want = ts_.state_to_numpy(state)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    # the sharded pool's tuple of shard states converts to the same tree
    tup = ts_.state_to_numpy(tuple(p["state"] for p in shards))
    for g, w in zip(jax.tree.leaves(tup), jax.tree.leaves(want)):
        np.testing.assert_array_equal(g, w)
    one = ts_.state_to_numpy(ts_.lane_state(
        tuple(p["state"] for p in shards), 5))
    assert int(one.kept_total) == 5
    # a ring: lane axis second, cursors replicated
    ring = ts_.ring_init(3, 8, 16, device="cpu")
    parts = tsh.lane_put(mesh, ring, 1)
    assert parts[2].scores.shape == (3, 2, 16) and parts[2].head.dim() == 0
    with pytest.raises(ValueError, match="do not split"):
        tsh.lane_put(_cpu_mesh(3), ring, 1)


# ---------------------------------------------------------------------------
# shard=True on the CPU's one device: a 1-wide mesh
# (tests/test_pool_ring.py:634)
# ---------------------------------------------------------------------------


def _serve_one(pool, xy, ts):
    lane = pool.connect(seed=CFG.seed)
    pool.feed(lane, xy, ts)
    pool.pump()
    out = pool.flush(lane)
    return out, pool.pool_stats()


def test_shard_true_on_one_device_equals_reference(streams):
    """``shard=True`` on one device runs the 1-wide lane mesh: lane 0 equal
    to ``run_pipeline`` (the module's bounds), every block shape run once,
    ``pool_stats()`` equal to the JAX pool's with ``shard=True``
    (``sharded``, ``devices`` included).  The reference's sharded path stages nothing, the port's
    stages each shard's slice (``h2d_staged_uploads``), so that one key
    is held to the unsharded port pool's instead."""
    sts, refs = streams
    xy, ts = sts[0].xy[:2500], sts[0].ts[:2500]
    pool = DetectorPool(CFG, capacity=2, ring_rounds=3, shard=True)
    try:
        assert isinstance(pool._states, ts_.DetectorState)
        (s, k), got = _serve_one(pool, xy, ts)
        assert pool.executors_compiled_once(), pool.compile_cache_sizes()
    finally:
        pool.close()
    _assert_lane(s, k, refs[0])
    assert got["sharded"] and got["devices"] == 1
    jpool = JPool(JCFG, capacity=2, ring_rounds=3, shard=True)
    try:
        _, want = _serve_one(jpool, xy, ts)
    finally:
        jpool.close()
    _stats_equal(got, want, skip=("h2d_staged_uploads",))
    plain = DetectorPool(CFG, capacity=2, ring_rounds=3, shard=False)
    try:
        _, unsharded = _serve_one(plain, xy, ts)
    finally:
        plain.close()
    assert not unsharded["sharded"] and unsharded["devices"] == 1
    assert got["h2d_staged_uploads"] == unsharded["h2d_staged_uploads"] > 0
    _stats_equal(got, unsharded, skip=("sharded",))


# ---------------------------------------------------------------------------
# Four shards: capacity 3 padded to 4, async drain, churn
# (tests/test_pool_ring.py:654)
# ---------------------------------------------------------------------------


def _serve_churn(pool, sts):
    """The reference's churn schedule: three lanes, 1,500 events each,
    lane 2 retired and its slot reused, lanes 0 and 1 fed to 2,500."""
    lanes = [pool.connect(seed=CFG.seed) for _ in range(3)]
    for i, ln in enumerate(lanes):
        pool.feed(ln, sts[i].xy[:1500], sts[i].ts[:1500])
    pool.pump()
    first = pool.flush(lanes[2])
    pool.disconnect(lanes[2])
    lanes[2] = pool.connect(seed=CFG.seed)
    pool.feed(lanes[2], sts[2].xy[:1500], sts[2].ts[:1500])
    for i in (0, 1):
        pool.feed(lanes[i], sts[i].xy[1500:2500], sts[i].ts[1500:2500])
    pool.pump()
    out = {i: pool.flush(lanes[i]) for i in range(3)}
    return first, out, pool.pool_stats(), pool.compile_cache_sizes()


@pytest.fixture(scope="module", params=["dense", "compact"])
def four_shards(request, streams):
    sts, _ = streams
    kw = dict(capacity=3, ring_rounds=4, drain_mode="async",
              readout=request.param)
    with _patched(4):
        pool = DetectorPool(CFG, **kw)          # shard="auto" takes it
    try:
        assert pool._phys == 4 and len(pool._shards) == 4
        got = _serve_churn(pool, sts)
        states = ts_.state_to_numpy(pool._states)
    finally:
        pool.close()
    plain = DetectorPool(CFG, shard=False, **kw)
    try:
        want = _serve_churn(plain, sts)
        want_states = ts_.state_to_numpy(plain._states)
    finally:
        plain.close()
    return dict(got=got, want=want, states=states, want_states=want_states)


def test_four_shards_lanes_equal_run_pipeline(four_shards, streams):
    _, refs = streams
    first, out, ps, sizes = four_shards["got"]
    _assert_lane(*first, refs[2])
    for i, ref in refs.items():
        _assert_lane(*out[i], ref)
    assert ps["sharded"] and ps["devices"] == 4
    assert ps["drain_mode"] == "async"
    assert all(n <= 1 for d in sizes.values() for n in d.values()), sizes
    assert sizes[256]["block"] == 1, sizes


def test_four_shards_stats_and_states_equal_unsharded(four_shards):
    """Against the unsharded port pool (capacity 3): ``pool_stats()``
    equal apart from ``sharded``, ``devices`` and the tallies the padding
    lane widens (``PADDING_KEYS``); the real lanes' final states equal."""
    got, want = four_shards["got"], four_shards["want"]
    _stats_equal(got[2], want[2],
                 skip=("sharded", "devices") + PADDING_KEYS)
    assert got[2]["h2d_event_slots"] * 3 == want[2]["h2d_event_slots"] * 4
    assert got[3] == want[3]
    for g, w in zip(jax.tree.leaves(four_shards["states"]),
                    jax.tree.leaves(four_shards["want_states"])):
        np.testing.assert_array_equal(np.asarray(g)[:3], w)


# ---------------------------------------------------------------------------
# The control plane across two shards
# ---------------------------------------------------------------------------

CP_CFG = tp.PipelineConfig(chunk=64, lut_every_chunks=2, device="cpu")
CP_RATES = [40] * 3 + [300] * 5        # the golden replay's ramp


def _serve_control(pool):
    """Four ramp lanes (two per shard) under ``policy="adaptive"``, one
    knob write by hand on a lane of each shard, and a pass whose decide
    writes knobs of both shards in one batched write."""
    half = CP_CFG.dvfs_cfg.half_us
    sts = [synthetic.ramp_stream(CP_RATES, half, seed=11 + s)
           for s in range(4)]
    lanes = [pool.connect(seed=11 + i, chunk=64) for i in range(4)]
    pool.set_lane_control(lanes[1], lut_every=3, shed=True)
    pool.set_lane_control(lanes[2], lut_every=5)
    outs = {i: [] for i in range(4)}
    for j in range(len(CP_RATES)):
        for i, lane in enumerate(lanes):
            m = (sts[i].ts // half) == j
            pool.feed(lane, sts[i].xy[m], sts[i].ts[m])
        if j == 4:
            pool._rt.pump_pass(pool.buckets, decide=lambda obs: [
                Action(lane=lanes[0], lut_every=4),
                Action(lane=lanes[3], lut_every=2, shed=True)])
        pool.pump()
        for i, lane in enumerate(lanes):
            outs[i].append(pool.poll(lane))
    for i, lane in enumerate(lanes):
        outs[i].append(pool.flush(lane))
    stats = [pool.stats(lane) for lane in lanes]
    return ({i: tuple(np.concatenate(x) for x in zip(*o))
             for i, o in outs.items()}, stats, pool.pool_stats(),
            ts_.state_to_numpy(pool._states))


def test_control_plane_across_two_shards_equals_unsharded():
    kw = dict(capacity=4, ring_rounds=4, buckets=(64, 256),
              policy="adaptive", migrate_patience=2, drain_mode="sync")
    with _patched(2):
        pool = DetectorPool(CP_CFG, shard=True, **kw)
    try:
        assert [sh.lo for sh in pool._shards] == [0, 2]
        got = _serve_control(pool)
    finally:
        pool.close()
    plain = DetectorPool(CP_CFG, **kw)
    try:
        want = _serve_control(plain)
    finally:
        plain.close()
    for i in range(4):
        for g, w in zip(got[0][i], want[0][i]):
            np.testing.assert_array_equal(g, w, err_msg=str(i))
    for g, w in zip(got[1], want[1]):
        hx.assert_stats_equal(g, w)
    logs = [s["migration_log"] for s in got[1]]
    assert all(logs), logs
    assert [(s["ctrl_lut_every"], s["ctrl_shed"]) for s in got[1]] == [
        (4, False), (3, True), (5, False), (2, True)]
    assert got[2]["sharded"] and got[2]["devices"] == 2
    assert got[2]["ctrl_batched_writes"] == 1
    assert got[2]["ctrl_actions_coalesced"] == 2
    _stats_equal(got[2], want[2], skip=("sharded", "devices"))
    for g, w in zip(jax.tree.leaves(got[3]), jax.tree.leaves(want[3])):
        np.testing.assert_array_equal(g, w)
