"""The port's ``StreamingDetector`` on the CPU against
``repro.serve.StreamingDetector`` fed the same slabs.

Bounds: kept masks, the whole state (TOS, SAE, key, cursors, rate
estimator, knobs, on-device accumulators), vdd traces and the float64
books exact; the LUT and finite scores within ``1e-5 * max|R_ref|`` with
the same ``-inf`` positions.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import pipeline as jp  # noqa: E402
from repro.serve import StreamingDetector as JSession  # noqa: E402
from repro.serve import streaming as j_streaming  # noqa: E402
from repro_torch.core import dvfs as t_dvfs  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import state as ts_  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402
from repro_torch.serve import StreamingDetector as TSession  # noqa: E402
from repro_torch.serve import streaming as t_streaming  # noqa: E402

H, W, CHUNK = 64, 96, 128
REL = 1e-5
GOLDEN = Path(__file__).parent / "data" / "golden_stats.json"

MODES = {
    "fixed": dict(),
    "ber_0.6V": dict(inject_ber=True, vdd=0.6),
    "dvfs_online": dict(dvfs=True, dvfs_online=True, inject_ber=True),
}


@pytest.fixture(scope="module")
def stream():
    return synthetic.shapes_stream(height=H, width=W, duration_us=24_000,
                                   n_shapes=2, seed=1)


def _cfgs(mode, **kw):
    base = dict(height=H, width=W, chunk=CHUNK, lut_every_chunks=2,
                **MODES[mode], **kw)
    return (jp.PipelineConfig(backend="jnp", **base),
            tp.PipelineConfig(backend="fused", device="cpu", **base))


def close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if fin.any():
        assert np.abs(got[fin] - want[fin]).max() <= (
            REL * np.abs(want[fin]).max())


def _feed(det, xy, ts, slabs, *, flush=True):
    scores, kept, i = [], [], 0
    for n in slabs:
        s, k = det.feed(xy[i:i + n], ts[i:i + n])
        scores.append(s)
        kept.append(k)
        i += n
    if flush:
        s, k = det.flush()
        scores.append(s)
        kept.append(k)
    return np.concatenate(scores), np.concatenate(kept)


def assert_states_equal(tstate, jstate):
    got = ts_.state_to_numpy(tstate)
    want = jax.device_get(jstate)
    for name in ("surface", "sae", "key", "chunk_idx", "lut_ready",
                 "kept_total", "energy_pj", "latency_ns"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w in zip((*got.rate, *got.ctrl), (*want.rate, *want.ctrl)):
        np.testing.assert_array_equal(g, np.asarray(w))
    close(got.lut, want.lut)


def assert_sessions_equal(tdet, jdet, tout, jout):
    np.testing.assert_array_equal(tout[1], jout[1])
    close(tout[0], jout[0])
    assert_states_equal(tdet.state, jdet.state)
    for name in ("n_events", "n_chunks", "kept_total", "energy_pj",
                 "latency_ns", "vdd_trace", "rebuckets"):
        assert getattr(tdet, name) == getattr(jdet, name), name
    assert tdet.base_ts == jdet.base_ts


def _plans(n):
    rng = np.random.default_rng(7)
    rand = []
    while sum(rand) < n:
        rand.append(int(rng.integers(1, 2 * CHUNK)))
    return {"sub_chunk": [CHUNK // 3] * (3 * n // CHUNK + 3),
            "non_multiple": [CHUNK + 17] * (n // CHUNK + 2),
            "random_uneven": rand}


@pytest.mark.parametrize("mode,plan", [
    ("ber_0.6V", "sub_chunk"), ("ber_0.6V", "non_multiple"),
    ("ber_0.6V", "random_uneven"), ("dvfs_online", "random_uneven"),
    ("fixed", "non_multiple"),
])
def test_session_matches_reference(stream, mode, plan):
    jc, tc = _cfgs(mode)
    slabs = _plans(len(stream))[plan]
    jdet, tdet = JSession(jc, seed=3), TSession(tc, seed=3)
    jout = _feed(jdet, stream.xy, stream.ts, slabs)
    tout = _feed(tdet, stream.xy, stream.ts, slabs)
    assert_sessions_equal(tdet, jdet, tout, jout)
    if plan == "sub_chunk":        # streaming is the batch fold, re-cut
        ref = tp.run_pipeline(stream.xy, stream.ts,
                              dataclasses.replace(tc, seed=3))
        np.testing.assert_array_equal(tout[0], ref.scores)
        np.testing.assert_array_equal(tout[1], ref.kept)
        assert tdet.energy_pj == ref.energy_pj


def test_chunk_override(stream):
    jc, tc = _cfgs("dvfs_online")
    jdet, tdet = JSession(jc, chunk=96), TSession(tc, chunk=96)
    slabs = [200] * (len(stream) // 200 + 1)
    assert_sessions_equal(tdet, jdet, _feed(tdet, stream.xy, stream.ts,
                                            slabs),
                          _feed(jdet, stream.xy, stream.ts, slabs))
    assert tdet.stats()["chunk"] == 96


def test_rejects_precomputed_dvfs():
    _, tc = _cfgs("fixed", dvfs=True)
    with pytest.raises(ValueError, match="precomputed DVFS"):
        TSession(tc)


def test_snapshot_restore_resumes_exactly(stream):
    jc, tc = _cfgs("dvfs_online")
    n = len(stream)
    slabs = [150] * (n // 150 + 1)
    half = len(slabs) // 2
    tdet = TSession(tc, seed=5)
    first = _feed(tdet, stream.xy, stream.ts, slabs[:half], flush=False)
    snap = tdet.snapshot()
    cut = 150 * half
    rest = (stream.xy[cut:], stream.ts[cut:], slabs[half:])
    a = _feed(tdet, *rest)
    b_det = TSession.restore(snap)
    b = _feed(b_det, *rest)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert b_det.energy_pj == tdet.energy_pj
    assert_states_equal(b_det.state, ts_.state_to_numpy(tdet.state))

    jdet = JSession(jc, seed=5)
    jout = _feed(jdet, stream.xy, stream.ts, slabs)
    both = (np.concatenate([first[0], a[0]]), np.concatenate([first[1],
                                                              a[1]]))
    assert_sessions_equal(b_det, jdet, both, jout)


def _port_numpy(jstate):
    """A ``jax.device_get`` state as numpy arrays in the port's records."""
    s = jax.device_get(jstate)
    return ts_.DetectorState(
        *(np.asarray(getattr(s, f)) for f in ts_.DetectorState._fields[:6]),
        rate=t_dvfs.RateState(*map(np.asarray, s.rate)),
        kept_total=np.asarray(s.kept_total),
        energy_pj=np.asarray(s.energy_pj),
        latency_ns=np.asarray(s.latency_ns),
        ctrl=ts_.ControlState(*map(np.asarray, s.ctrl)))


@pytest.mark.parametrize("mode", ["ber_0.6V", "dvfs_online"])
def test_handoff_from_reference_snapshot(stream, mode):
    """A reference session's snapshot, restored into the port halfway,
    finishes exactly as the reference does."""
    jc, tc = _cfgs(mode)
    slabs = [170] * (len(stream) // 170 + 1)
    half = len(slabs) // 2
    cut = 170 * half
    jdet = JSession(jc, seed=2)
    _feed(jdet, stream.xy, stream.ts, slabs[:half], flush=False)
    jsnap = jdet.snapshot()
    tsnap = dict(jsnap, cfg=tc, state=_port_numpy(jsnap["state"]))
    tdet = TSession.restore(tsnap)
    rest = (stream.xy[cut:], stream.ts[cut:], slabs[half:])
    assert_sessions_equal(tdet, jdet, _feed(tdet, *rest), _feed(jdet, *rest))


@pytest.mark.parametrize("mode,limit", [("fixed", 1 << 22),
                                        ("dvfs_online", 1 << 14)])
def test_rebases_past_int32(monkeypatch, mode, limit):
    """Two gaps of 3 * 2**30 us push the clock past 2**32: both sessions
    re-base (several hops each) and stay equal."""
    monkeypatch.setattr(j_streaming, "REBASE_LIMIT_US", limit)
    monkeypatch.setattr(t_streaming, "REBASE_LIMIT_US", limit)
    st = synthetic.shapes_stream(height=H, width=W, duration_us=30_000,
                                 n_shapes=2, seed=3)
    third = 6 * CHUNK
    gap = np.int64(3) << 30
    ts = np.concatenate([st.ts[:third], st.ts[third:2 * third] + gap,
                         st.ts[2 * third:3 * third] + 2 * gap])
    xy = st.xy[:3 * third]
    assert int(ts[-1]) > 2**32
    jc, tc = _cfgs(mode)
    jdet, tdet = JSession(jc), TSession(tc)
    slabs = [500] * (len(ts) // 500 + 1)
    jout = _feed(jdet, xy, ts, slabs)
    tout = _feed(tdet, xy, ts, slabs)
    assert_sessions_equal(tdet, jdet, tout, jout)
    assert tdet.base_ts > 2**32


def test_set_control_and_rebucket(stream):
    jc, tc = _cfgs("dvfs_online")
    jdet, tdet = JSession(jc, seed=4), TSession(tc, seed=4)
    n = len(stream)
    parts = [(0, n // 3), (n // 3, 2 * n // 3), (2 * n // 3, n)]
    outs = {"j": [], "t": []}
    for step, (lo, hi) in enumerate(parts):
        for key, det in (("j", jdet), ("t", tdet)):
            if step == 1:
                det.set_control(lut_every=3, vdd_cap=1)
            if step == 2:
                det.set_control(shed=True, vdd_cap=99).rebucket(64)
            outs[key].append(det.feed(stream.xy[lo:hi], stream.ts[lo:hi]))
        assert tdet.control == jdet.control
    for key, det in (("j", jdet), ("t", tdet)):
        outs[key].append(det.flush())
    cat = {k: (np.concatenate([o[0] for o in v]),
               np.concatenate([o[1] for o in v])) for k, v in outs.items()}
    assert_sessions_equal(tdet, jdet, cat["t"], cat["j"])
    top = len(t_dvfs.op_point_table(tc.dvfs_cfg).caps) - 1
    assert tdet.control == {"lut_every": 3, "vdd_cap": top, "shed": True}


def test_stats_match_reference_and_golden_keys(stream):
    jc, tc = _cfgs("dvfs_online")
    jdet, tdet = JSession(jc), TSession(tc)
    slabs = [300] * 5
    _feed(jdet, stream.xy, stream.ts, slabs, flush=False)
    _feed(tdet, stream.xy, stream.ts, slabs, flush=False)
    golden = json.loads(GOLDEN.read_text())["session_stats"]
    got, want = tdet.stats(), jdet.stats()
    assert got.keys() == golden.keys()
    assert got == want


@pytest.mark.parametrize("mode", ["fixed", "dvfs_online"])
@pytest.mark.parametrize("backend", ["nmc", "batched"])
def test_session_tos_backends(backend, mode):
    """Backends ``"nmc"`` / ``"batched"`` fed in slabs of 97
    (tests/test_streaming.py) against the reference session on
    ``"pallas_nmc"`` / ``"pallas_batched"``, and against the port's batch
    fold of the same stream."""
    rng = np.random.default_rng(0)
    e, h, w = 512, 64, 64
    xy = np.stack([rng.integers(0, w, e), rng.integers(0, h, e)],
                  1).astype(np.int32)
    ts = np.sort(rng.integers(0, 20_000, e)).astype(np.int64)
    base = dict(height=h, width=w, chunk=CHUNK, lut_every_chunks=2,
                **MODES[mode])
    jc = jp.PipelineConfig(backend=f"pallas_{backend}", **base)
    tc = tp.PipelineConfig(backend=backend, device="cpu", **base)
    jdet, tdet = JSession(jc, seed=3), TSession(tc, seed=3)
    slabs = [97] * 6
    tout = _feed(tdet, xy, ts, slabs)
    assert_sessions_equal(tdet, jdet, tout, _feed(jdet, xy, ts, slabs))
    ref = tp.run_pipeline(xy, ts, dataclasses.replace(tc, seed=3))
    np.testing.assert_array_equal(tout[0], ref.scores)
    np.testing.assert_array_equal(tout[1], ref.kept)
