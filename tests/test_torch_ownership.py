"""Who owns a state when K1 steps surfaces in place (on the CPU, where the
plain ``fused_step_ref_`` stands in for the kernel and runs the same
ownership logic).

Every entry point that folds many chunks steps its own working copy of the
TOS and the SAE in place; a caller's state is never mutated.  Each test
takes a clone of what the caller holds before the call and checks it bit
for bit after.  A masked pool round leaves the inactive lanes' surfaces as
they were.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import state as ts_  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402
from repro_torch.serve import DetectorPool, StreamingDetector  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

H, W, CHUNK = 64, 96, 96
MODES = {
    "ber_0.6V": dict(inject_ber=True, vdd=0.6),
    "dvfs_online": dict(dvfs=True, dvfs_online=True, inject_ber=True),
}


def _cfg(mode="ber_0.6V", backend="fused", **kw):
    return tp.PipelineConfig(height=H, width=W, chunk=CHUNK,
                             lut_every_chunks=2, backend=backend,
                             device="cpu", **MODES[mode], **kw)


def _stream(seed=0, n=6 * CHUNK):
    st = synthetic.shapes_stream(height=H, width=W, duration_us=40_000,
                                 n_shapes=2, seed=seed)
    return st.xy[:n], st.ts[:n]


def _tensors(state):
    """Every tensor leaf of a state, by name."""
    out = {f: getattr(state, f) for f in ts_._TENSOR_FIELDS}
    out.update({f"rate.{i}": r for i, r in enumerate(state.rate)})
    return out


def _clone(state):
    return {k: t.clone() for k, t in _tensors(state).items()}


def _assert_unchanged(state, before):
    for k, t in _tensors(state).items():
        assert torch.equal(t, before[k]), k


def _chunks(cfg, seed=0, n_chunks=4, lanes=1):
    """``n_chunks`` stacked chunks for ``lanes`` lanes."""
    rng = np.random.default_rng(seed)
    xy = rng.integers(0, (W, H), (n_chunks, lanes, CHUNK, 2)).astype(
        np.int32)
    ts = np.sort(rng.integers(0, 20_000, (n_chunks, lanes, CHUNK)),
                 axis=-1).astype(np.int32)
    valid = rng.random((n_chunks, lanes, CHUNK)) < 0.9
    ber, e, lat = ts_.chunk_input_riders(n_chunks, np.full(n_chunks, 0.6),
                                         cfg)
    rep = lambda a: torch.from_numpy(np.repeat(a[:, None], lanes, 1))
    return ts_.ChunkInput(torch.from_numpy(xy), torch.from_numpy(ts),
                          torch.from_numpy(valid), rep(ber), rep(e),
                          rep(lat))


def _busy_state(cfg, lanes=1):
    """A state some chunks into a stream, so surfaces are not blank."""
    state = ts_.detector_init(cfg, seed=list(range(lanes)))
    state, _ = ts_.detector_scan(cfg, state, _chunks(cfg, 7, 3, lanes))
    return state


@pytest.mark.parametrize("backend", ["fused", "torch"])
def test_detector_scan_leaves_caller_state(backend):
    """``detector_scan`` steps a working copy: the caller's state is bit
    for bit as it was, and the fold equals one of functional steps."""
    cfg = _cfg(backend=backend)
    state = _busy_state(cfg, lanes=2)
    before = _clone(state)
    chunks = _chunks(cfg, 1, 4, lanes=2)
    fin, outs = ts_.detector_scan(cfg, state, chunks)
    _assert_unchanged(state, before)
    assert fin.surface is not state.surface and fin.sae is not state.sae

    ref = state
    for c in range(chunks.xy.shape[0]):
        ref, out = ts_.detector_step(cfg, ref,
                                     ts_.ChunkInput(*(t[c] for t in chunks)))
        assert torch.equal(out.keep, outs.keep[c])
        assert torch.equal(out.scores, outs.scores[c])
    for k, t in _tensors(fin).items():
        assert torch.equal(t, _tensors(ref)[k]), k
    _assert_unchanged(state, before)


@pytest.mark.parametrize("backend", ["fused", "torch", "nmc"])
@pytest.mark.parametrize("masked", [False, True])
def test_detector_step_is_functional(backend, masked):
    """``detector_step`` called directly leaves its state alone, masked or
    not; ``detector_step_`` on a copy gives the same new state, sharing
    the copy's surfaces on the fused and plain backends."""
    cfg = _cfg(backend=backend)
    state = _busy_state(cfg, lanes=3)
    before = _clone(state)
    chunk = ts_.ChunkInput(*(t[0] for t in _chunks(cfg, 2, 1, lanes=3)))
    mask = np.array([True, False, True]) if masked else None
    new, out = ts_.detector_step(cfg, state, chunk, mask=mask)
    _assert_unchanged(state, before)

    own = state._replace(surface=state.surface.clone(),
                         sae=state.sae.clone())
    new_, out_ = ts_.detector_step_(cfg, own, chunk, mask=mask)
    if backend != "nmc":
        assert new_.surface is own.surface and new_.sae is own.sae
    for k, t in _tensors(new).items():
        assert torch.equal(t, _tensors(new_)[k]), k
    assert torch.equal(out.keep, out_.keep)
    if masked:
        for f in ("surface", "sae"):
            assert torch.equal(getattr(new, f)[1], before[f][1]), f
    _assert_unchanged(state, before)


@pytest.mark.parametrize("mode", list(MODES))
def test_run_pipeline_leaves_inputs_and_repeats(mode):
    """``run_pipeline`` / ``run_pipeline_batched`` leave the caller's
    arrays as they were, and a second call gives the same result (no
    surface survives from one call into the next)."""
    cfg = _cfg(mode)
    xy, ts = _stream(0)
    xy2, ts2 = _stream(1)
    bxy, bts = np.stack([xy, xy2]), np.stack([ts, ts2])
    keep = [a.copy() for a in (xy, ts, bxy, bts)]
    one = tp.run_pipeline(xy, ts, cfg)
    batch = tp.run_pipeline_batched(bxy, bts, cfg, seeds=[3, 4])
    for a, b in zip((xy, ts, bxy, bts), keep):
        np.testing.assert_array_equal(a, b)
    again = tp.run_pipeline(xy, ts, cfg)
    again_b = tp.run_pipeline_batched(bxy, bts, cfg, seeds=[3, 4])
    for got, want in ((again, one), *zip(again_b, batch)):
        for f in ("scores", "kept", "tos", "lut"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert not np.array_equal(batch[0].tos, batch[1].tos)


def test_streaming_feed_and_snapshot_leave_callers_state():
    """A session steps its own surfaces in place: a state read from
    ``.state``, a snapshot and the snapshot a session was restored from
    all stay as they were while the session goes on feeding."""
    cfg = _cfg("dvfs_online")
    xy, ts = _stream(2)
    det = StreamingDetector(cfg, seed=5)
    det.feed(xy[:2 * CHUNK], ts[:2 * CHUNK])
    held = det.state
    before = _clone(held)
    snap = det.snapshot()
    snap_before = ts_.state_to_numpy(ts_.state_from_numpy(snap["state"],
                                                          device="cpu"))
    det.feed(xy[2 * CHUNK:4 * CHUNK], ts[2 * CHUNK:4 * CHUNK])
    _assert_unchanged(held, before)
    assert not torch.equal(det.state.surface, before["surface"])

    again = StreamingDetector.restore(snap)
    again.feed(xy[2 * CHUNK:4 * CHUNK], ts[2 * CHUNK:4 * CHUNK])
    for f in ("surface", "sae", "key"):
        np.testing.assert_array_equal(getattr(snap["state"], f),
                                      getattr(snap_before, f), err_msg=f)
        assert torch.equal(getattr(again.state, f), getattr(det.state, f))


def test_feed_device_chunk_leaves_loader_tensors_and_held_state():
    """``feed_device_chunk`` reads the loader's tensors and steps only the
    session's own state: the chunk tensors and a state read from
    ``.state`` before the feed are unchanged after it, while the session's
    surfaces move."""
    from repro_torch.events import stream as stream_mod
    from repro_torch.serve import session_base_us
    cfg = _cfg("dvfs_online")
    st = synthetic.shapes_stream(height=H, width=W, duration_us=40_000,
                                 n_shapes=2, seed=2)
    base = session_base_us(int(st.ts[0]), cfg)
    det = StreamingDetector(cfg, seed=5, base_ts=base)
    held, n = det.state, 0
    before = _clone(held)
    with stream_mod.PrefetchingLoader(st, CHUNK, device_slabs=True,
                                      rebase_us=base, device="cpu") as ld:
        for xy, ts, valid in ld:
            copies = [t.clone() for t in (xy, ts, valid)]
            det.feed_device_chunk(xy, ts, valid)
            for t, c in zip((xy, ts, valid), copies):
                assert torch.equal(t, c)
            n += 1
            if n == 4:
                break
    _assert_unchanged(held, before)
    assert not torch.equal(det.state.surface, before["surface"])
    assert det.n_chunks == 4


def test_pool_masked_rounds_leave_inactive_lanes():
    """A ``DetectorPool`` round folds only the lanes with a full chunk:
    across rounds with churn (a lane leaves, a fresh one joins its slot),
    every inactive lane's TOS and SAE stay byte-identical."""
    cfg = _cfg("ber_0.6V")
    streams = [_stream(s) for s in range(3)]
    pool = DetectorPool(cfg, 4, ring_rounds=2)
    try:
        lanes = [pool.connect(seed=s) for s in range(3)]
        plans = [(0, 1), (1, 2), (0, 2), (2,), (0, 1, 2)]
        cursor = [0, 0, 0]
        for step, fed in enumerate(plans):
            if step == 3:       # churn: lane 1 leaves, a fresh one joins
                pool.disconnect(lanes[1])
                lanes[1] = pool.connect(seed=9)
                cursor[1] = 0
            for i in fed:
                xy, ts = streams[i]
                c = cursor[i]
                pool.feed(lanes[i], xy[c:c + CHUNK], ts[c:c + CHUNK])
                cursor[i] = c + CHUNK
            idle = [lanes[i] for i in range(3) if i not in fed]
            s = pool._states
            before = {ln: (s.surface[ln].clone(), s.sae[ln].clone())
                      for ln in idle}
            assert pool.pump() >= 1
            for ln, (tos, sae) in before.items():
                assert torch.equal(pool._states.surface[ln], tos), (step, ln)
                assert torch.equal(pool._states.sae[ln], sae), (step, ln)
            for i in fed:
                pool.poll(lanes[i])
    finally:
        pool.close()


def _serve_after(cfg, streams, warm):
    """A lane holding half a chunk, optionally a ``warmup`` (its scratch
    lane takes the next slot), then a new tenant in that slot; returns
    both lanes' results and the held lane's surfaces around the warmup."""
    pool = DetectorPool(cfg, 3, ring_rounds=2)
    try:
        held = pool.connect(seed=1)
        xy, ts = streams[0]
        pool.feed(held, xy[:CHUNK // 2], ts[:CHUNK // 2])
        s = pool._states
        before = (s.surface[held].clone(), s.sae[held].clone())
        if warm:
            pool.warmup(*streams[2])
        s = pool._states
        after = (s.surface[held].clone(), s.sae[held].clone())
        lane = pool.connect(seed=7)
        pool.feed(lane, *streams[1])
        pool.feed(held, xy[CHUNK // 2:], ts[CHUNK // 2:])
        out = (pool.flush(lane), pool.flush(held))
        return lane, out, before, after
    finally:
        pool.close()


def test_pool_warmup_leaves_lanes_and_next_tenant():
    """``warmup``'s scratch lane folds rounds without touching a connected
    lane's surfaces, and the tenant that next takes its slot serves
    exactly as in a pool that never warmed up."""
    cfg = _cfg("dvfs_online")
    streams = [_stream(s) for s in range(3)]
    lane, got, before, after = _serve_after(cfg, streams, warm=True)
    lane0, want, _, _ = _serve_after(cfg, streams, warm=False)
    assert lane == lane0 == 1
    for b, a in zip(before, after):
        assert torch.equal(b, a)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        np.testing.assert_array_equal(g[1], w[1])


def test_pool_migration_and_knob_write_alias_nothing():
    """A knob write replaces the ``ctrl`` leaves (a view read before keeps
    its values), shedding drops events from the pool's own buffer (the
    caller's slabs stay as fed), ``stats()`` hands out a copy of the
    migration log, results polled before a move keep their values, and
    applying a move writes no lane's surfaces."""
    cfg = _cfg("dvfs_online")
    xy, ts = _stream(3, n=12 * CHUNK)
    fed = (xy.copy(), ts.copy())
    pool = DetectorPool(cfg, 2, ring_rounds=2, buckets=(CHUNK, 4 * CHUNK),
                        policy="adaptive")
    try:
        lane = pool.connect(seed=1, chunk=CHUNK)
        other = pool.connect(seed=2, chunk=CHUNK)
        held = pool._states.ctrl
        held_values = [leaf.copy() for leaf in held]
        pool.set_lane_control(lane, shed=True, lut_every=3, vdd_cap=1)
        for leaf, value in zip(held, held_values):
            np.testing.assert_array_equal(leaf, value)
        assert int(pool._states.ctrl.lut_every[lane]) == 3
        pool.feed(lane, xy, ts)                       # sheds the oldest
        pool.feed(other, xy[:3 * CHUNK], ts[:3 * CHUNK])
        assert pool.stats(lane)["shed_events"] > 0
        np.testing.assert_array_equal(xy, fed[0])
        np.testing.assert_array_equal(ts, fed[1])
        pool.pump()
        polled = pool.poll(lane)
        polled_values = (polled[0].copy(), polled[1].copy())

        pool._rt.stage_migration(lane, 4 * CHUNK)
        s = pool._states
        before = [t.clone() for t in (s.surface, s.sae, s.lut)]
        pool.pump()                                   # applies; no rounds
        st = pool.stats(lane)
        assert st["migrations"] == 1 and st["bucket"] == 4 * CHUNK
        for b, a in zip(before, (s.surface, s.sae, s.lut)):
            assert torch.equal(b, a)
        st["migration_log"].append((0, 0, 0))
        assert pool.stats(lane)["migration_log"] == [
            (st["migration_log"][0])]
        pool.feed(lane, xy[:8 * CHUNK], ts[:8 * CHUNK] + 60_000)
        pool.pump()
        pool.poll(lane)
        np.testing.assert_array_equal(polled[0], polled_values[0])
        np.testing.assert_array_equal(polled[1], polled_values[1])
    finally:
        pool.close()


@pytest.mark.parametrize("lanes", [1, 3])
def test_pool_decide_pass_knob_writes_alias_nothing(lanes):
    """A pump pass whose ``decide`` writes knobs (one lane: the single
    write; several: the coalesced one) replaces the ``ctrl`` leaves, so a
    ``ctrl`` read taken before the pass keeps its values, and an
    ``Observation`` handed out before keeps its lanes' tiers."""
    from repro_torch.serve.scheduler import LadderConfig
    cfg = _cfg("dvfs_online")
    xy, ts = _stream(4, n=8 * CHUNK)
    pool = DetectorPool(cfg, lanes, ring_rounds=2, policy="ladder",
                        ladder=LadderConfig(classes=(("standard", 3),),
                                            patience=1, hi_rounds=1.0))
    try:
        ids = [pool.connect(seed=i) for i in range(lanes)]
        for lane in ids:
            pool.feed(lane, xy, ts)
        seen = []
        decide = pool.scheduler.decide
        pool.scheduler.decide = lambda obs: seen.append(obs) or decide(obs)
        held = pool._states.ctrl
        held_values = [leaf.copy() for leaf in held]
        pool.pump_rounds(1)
        for leaf, value in zip(held, held_values):
            np.testing.assert_array_equal(leaf, value)
        assert [int(pool._states.ctrl.lut_every[lane]) for lane in ids] \
            == [cfg.lut_every_chunks * 4] * lanes
        assert pool.pool_stats()["ctrl_batched_writes"] == int(lanes > 1)
        pool.pump_rounds(1)
        assert [lob.tier for lob in seen[0].lanes] == [0] * lanes
        assert [lob.tier for lob in seen[1].lanes] == [1] * lanes
    finally:
        pool.close()
