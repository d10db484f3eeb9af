"""Shared helpers for the port's pool parity tests: the same feeds go to a
``repro.serve.DetectorPool`` and a ``repro_torch.serve.DetectorPool``.

Bounds: kept masks, states, counters and books exact; finite scores within
``1e-5 * max|R_ref|`` with the same ``-inf`` positions; ``pool_stats()``
and ``stats()`` values equal apart from wall-clock keys.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as jp
from repro.serve import DetectorPool as JPool
from repro_torch.core import pipeline as tp
from repro_torch.core import state as ts_
from repro_torch.events import synthetic
from repro_torch.obs.schema import WALL_TIME_KEYS
from repro_torch.serve import DetectorPool as TPool

H, W, CHUNK = 64, 96, 128
REL = 1e-5

MODES = {
    "fixed": dict(),
    "ber_0.6V": dict(inject_ber=True, vdd=0.6),
    "dvfs_online": dict(dvfs=True, dvfs_online=True, inject_ber=True),
}


# The stats a readout changes: the rest of pool_stats() must not move.
READOUT_KEYS = ("readout", "d2h_bytes", "d2h_bytes_saved",
                "d2h_compact_overflow_slots")


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's port pools on one intra-op thread: their tensors are
    tiny, and the test workers run side by side on the same cores.  No
    reduction in the port sums floats, so results do not depend on it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cfg_pair(mode="dvfs_online", **kw):
    base = dict(height=H, width=W, chunk=CHUNK, lut_every_chunks=2,
                **MODES[mode], **kw)
    return (jp.PipelineConfig(backend="jnp", **base),
            tp.PipelineConfig(backend="fused", device="cpu", **base))


def make_streams(lengths, seed=0):
    """Streams of the given lengths, cut from a few synthetic scenes."""
    out = []
    for i, n in enumerate(lengths):
        st = synthetic.shapes_stream(height=H, width=W, duration_us=40_000,
                                     n_shapes=2, seed=seed + i)
        out.append((st.xy[:n], st.ts[:n]))
    return out


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if fin.any():
        assert np.abs(got[fin] - want[fin]).max() <= (
            REL * np.abs(want[fin]).max())


def assert_results(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k][1], want[k][1], err_msg=str(k))
        close(got[k][0], want[k][0])


def _normal(obj):
    """JSON round trip (numpy scalars -> python, int keys -> str) with the
    wall-clock witnesses dropped."""
    def drop(o):
        if isinstance(o, dict):
            return {k: drop(v) for k, v in o.items()
                    if k not in WALL_TIME_KEYS}
        return o

    def default(o):
        if isinstance(o, np.generic):
            return o.item()
        raise TypeError(type(o))
    return drop(json.loads(json.dumps(obj, sort_keys=True, default=default)))


def assert_stats_equal(got: dict, want: dict, skip=()):
    assert got.keys() == want.keys()
    g, w = _normal(got), _normal(want)
    for k in skip:
        g.pop(k), w.pop(k)
    assert g == w


def assert_pool_states_equal(tpool, jpool):
    """Every lane of the stacked states, active or not, equal."""
    got = ts_.state_to_numpy(tpool._states)
    want = jax.device_get(jpool._states)
    if got.surface.ndim == 2:        # one lane: the port drops the lane axis
        want = jax.tree.map(lambda a: np.asarray(a)[0], want)
    for name in ("surface", "sae", "key", "chunk_idx", "lut_ready",
                 "kept_total", "energy_pj", "latency_ns"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w in zip((*got.rate, *got.ctrl), (*want.rate, *want.ctrl)):
        np.testing.assert_array_equal(g, np.asarray(w))
    close(got.lut, want.lut)


def serve_staggered(pool, streams, seeds, *, slab_rng_seed=0):
    """Interleave the streams with staggered joins and leaves (one join
    every other round, a lane leaves when its stream ends); returns
    per-stream (scores, kept) and each lane's final ``disconnect`` stats."""
    rng = np.random.default_rng(slab_rng_seed)
    n = len(streams)
    lanes, cursors = {}, {i: 0 for i in range(n)}
    results = {i: ([], []) for i in range(n)}
    final = {}
    step = 0
    lanes[0] = pool.connect(seed=seeds[0])
    while lanes or any(cursors[i] < len(streams[i][1]) for i in range(n)):
        step += 1
        joined = len([i for i in range(n) if i in lanes or cursors[i] > 0])
        if step % 2 == 1 and joined < n:
            nxt = next(i for i in range(n)
                       if i not in lanes and cursors[i] == 0)
            lanes[nxt] = pool.connect(seed=seeds[nxt])
        for i, lane in list(lanes.items()):
            xy, ts = streams[i]
            c = cursors[i]
            if c >= len(ts):
                s, k = pool.flush(lane)
                results[i][0].append(s)
                results[i][1].append(k)
                final[i] = pool.disconnect(lane)
                del lanes[i]
                continue
            slab = int(rng.integers(40, 400))
            pool.feed(lane, xy[c:c + slab], ts[c:c + slab])
            cursors[i] = c + slab
        pool.pump()
        for i, lane in lanes.items():
            s, k = pool.poll(lane)
            results[i][0].append(s)
            results[i][1].append(k)
    out = {i: (np.concatenate(results[i][0]), np.concatenate(results[i][1]))
           for i in range(n)}
    return out, final


def serve_churn(pool, cfg, streams, *, slab=150):
    """Lockstep feeding with mid-stream churn: lane 0 leaves halfway and a
    fresh tenant takes its slot for two chunks.  Returns the per-stream
    poll outputs, concatenated."""
    lanes = [pool.connect(seed=i) for i in range(len(streams))]
    outs = {i: [] for i in range(len(streams))}
    n = max(len(s[1]) for s in streams)
    starts = list(range(0, n, slab))
    for step, start in enumerate(starts):
        for i, lane in enumerate(lanes):
            if lane is not None:
                xy, ts = streams[i]
                pool.feed(lane, xy[start:start + slab], ts[start:start + slab])
        pool.pump()
        for i, lane in enumerate(lanes):
            if lane is not None:
                outs[i].append(pool.poll(lane))
        if step == len(starts) // 2:
            outs[0].append(pool.flush(lanes[0]))
            pool.disconnect(lanes[0])
            lanes[0] = None
            fresh = pool.connect(seed=99)
            xy, ts = make_streams([2 * cfg.chunk], seed=99)[0]
            pool.feed(fresh, xy, ts)
            pool.pump()
            outs["fresh"] = [pool.poll(fresh)]
            outs["fresh"].append(pool.flush(fresh))
            pool.disconnect(fresh)
    for i, lane in enumerate(lanes):
        if lane is not None:
            outs[i].append(pool.flush(lane))
    assert pool.executors_compiled_once(), pool.compile_cache_sizes()
    return {k: (np.concatenate([o[0] for o in v]),
                np.concatenate([o[1] for o in v])) for k, v in outs.items()}


def run_pool(Pool, cfg, streams, drive, **pool_kw):
    """Drive one pool through ``drive(pool, cfg, streams)``; returns
    ``(out, pool_stats, pool)`` (the pool closed, its state readable)."""
    pool = Pool(cfg, len(streams) + 1, **pool_kw)
    try:
        out = drive(pool, cfg, streams)
        return out, pool.pool_stats(), pool
    finally:
        pool.close()


def run_both(jcfg, tcfg, streams, drive, **pool_kw):
    """``run_pool`` for a port pool, then a reference pool."""
    return [run_pool(TPool, tcfg, streams, drive, **pool_kw),
            run_pool(JPool, jcfg, streams, drive, **pool_kw)]
