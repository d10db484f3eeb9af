"""The port's batch path on the CPU against the reference ``run_pipeline``.

Bounds (the port's parity contract):
  * exact — kept mask, final TOS, vdd trace, float64 energy books, and in
    the state: sae, key, RateState, chunk_idx, kept_total, the float32
    energy/latency accumulators;
  * allclose — the LUT and finite scores within ``1e-5 * max|R_ref|``,
    with identical ``-inf`` positions and |delta PR-AUC| <= 1e-3.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dvfs as j_dvfs  # noqa: E402
from repro.core import pipeline as jp  # noqa: E402
from repro.core import pr_eval  # noqa: E402
from repro.core import state as js  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import state as ts_  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402

H, W, CHUNK = 64, 96, 128
REL = 1e-5


@pytest.fixture(scope="module")
def stream():
    return synthetic.dynamic_stream(height=H, width=W, duration_us=40_000,
                                    n_shapes=3, seed=2)


def _configs(**kw):
    base = dict(height=H, width=W, chunk=CHUNK, lut_every_chunks=2, **kw)
    return jp.PipelineConfig(backend="jnp", **base), tp.PipelineConfig(
        backend="torch", device="cpu", **base)


def _with_backend(cfg_pair, fused):
    jc, tc = cfg_pair
    if fused:
        return (dataclasses.replace(jc, backend="pallas_fused"),
                dataclasses.replace(tc, backend="fused"))
    return jc, tc


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    if fin.any():
        bound = REL * np.abs(want[fin]).max()
        assert np.abs(got[fin] - want[fin]).max() <= bound


def _assert_results(t, j, labels=None):
    np.testing.assert_array_equal(t.kept, j.kept)
    np.testing.assert_array_equal(t.tos, j.tos)
    np.testing.assert_array_equal(t.vdd_trace, j.vdd_trace)
    assert t.energy_pj == j.energy_pj
    assert t.latency_ns_per_event == j.latency_ns_per_event
    _close(t.scores, j.scores)
    _close(t.lut, j.lut)
    assert t.host_syncs == 1
    if labels is not None:
        ok = np.isfinite(j.scores)
        assert abs(pr_eval.pr_auc(t.scores[ok], labels[ok])
                   - pr_eval.pr_auc(j.scores[ok], labels[ok])) <= 1e-3


MODES = {
    "fixed": dict(),
    "dvfs_online": dict(dvfs=True, dvfs_online=True),
    "ber_0.61V": dict(inject_ber=True, vdd=0.61),
    "ber_0.6V": dict(inject_ber=True, vdd=0.6),
    "dvfs_precomputed_ber": dict(dvfs=True, inject_ber=True),
}


@pytest.mark.parametrize("fused", [False, True], ids=["torch", "fused"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_run_pipeline_matches_reference(stream, mode, fused):
    jc, tc = _with_backend(_configs(**MODES[mode]), fused)
    want = jp.run_pipeline(stream.xy, stream.ts, jc)
    got = tp.run_pipeline(stream.xy, stream.ts, tc)
    _assert_results(got, want, stream.is_corner)


def _scan_both(stream, jc, tc, *, ctrl=None, lo=0, hi=None):
    """Fold chunks [lo, hi) through both detectors from fresh states with
    the given knobs; returns (jax final state, jax outs, port state, port
    outs)."""
    jprep = jp._prepare(stream.xy, stream.ts, jc)
    tprep = tp._prepare(stream.xy, stream.ts, tc)
    jstate = js.detector_init(jc)
    tstate = ts_.detector_init(tc, device="cpu")
    if ctrl is not None:
        jstate = jstate._replace(ctrl=js.ControlState(
            lut_every=jnp.int32(ctrl[0]), vdd_cap=jnp.int32(ctrl[1]),
            shed=jnp.asarray(ctrl[2])))
        tstate = tstate._replace(ctrl=ts_.ControlState(*ctrl))
    jchunks = jax.tree.map(lambda a: a[lo:hi], jp._chunk_inputs(jprep))
    tchunks = ts_.ChunkInput(*(t[lo:hi] for t in tp._chunk_inputs(
        [tprep], "cpu")))
    jfin, jouts = jax.jit(lambda s, c: js.detector_scan(jc, s, c))(
        jstate, jchunks)
    tfin, touts = ts_.detector_scan(tc, tstate, tchunks)
    return jax.device_get(jfin), jax.device_get(jouts), tfin, touts


def _assert_state(tstate, jstate):
    got = ts_.state_to_numpy(tstate)
    for name in ("surface", "sae", "key", "chunk_idx", "kept_total",
                 "energy_pj", "latency_ns", "lut_ready"):
        g, w = getattr(got, name), np.asarray(getattr(jstate, name))
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    for g, w in zip(got.rate, jstate.rate):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(got.ctrl, jstate.ctrl):
        np.testing.assert_array_equal(g, np.asarray(w))
    _close(got.lut, jstate.lut)


def _assert_outs(touts, jouts):
    np.testing.assert_array_equal(touts.keep[:, 0].numpy(), jouts.keep)
    np.testing.assert_array_equal(touts.n_kept[:, 0].numpy(), jouts.n_kept)
    np.testing.assert_array_equal(touts.vdd_idx[:, 0].numpy(),
                                  jouts.vdd_idx)
    _close(touts.scores[:, 0].numpy(), jouts.scores)


@pytest.mark.parametrize("case", [
    ("dvfs_online", (3, 2, False)),        # refresh every 3rd, cap at 0.8 V
    ("ber_0.6V", (5, 0, False)),
    ("fixed", (2, 0, True)),               # refresh shed
])
def test_moved_control_knobs(stream, case):
    mode, ctrl = case
    jc, tc = _with_backend(_configs(**MODES[mode]), fused=True)
    jfin, jouts, tfin, touts = _scan_both(stream, jc, tc, ctrl=ctrl)
    _assert_state(tfin, jfin)
    _assert_outs(touts, jouts)


@pytest.mark.parametrize("mode", ["dvfs_online", "ber_0.6V"])
def test_state_carry_across(stream, mode):
    """A mid-stream reference state restored into the port continues
    bit-exact, and a port state handed back to the reference does too."""
    jc, tc = _with_backend(_configs(**MODES[mode]), fused=True)
    jfull, jouts, _, _ = _scan_both(stream, jc, tc)
    n = jouts.keep.shape[0]
    half = n // 2
    jmid, _, tmid, _ = _scan_both(stream, jc, tc, hi=half)
    _assert_state(tmid, jmid)

    tprep = tp._prepare(stream.xy, stream.ts, tc)
    rest = ts_.ChunkInput(*(t[half:] for t in tp._chunk_inputs([tprep],
                                                                "cpu")))
    tfin, touts = ts_.detector_scan(
        tc, ts_.state_from_numpy(jmid, device="cpu"), rest)
    _assert_state(tfin, jfull)
    np.testing.assert_array_equal(touts.keep[:, 0].numpy(),
                                  jouts.keep[half:])

    back = ts_.state_to_numpy(tmid)
    jback = js.DetectorState(
        *[jnp.asarray(v) for v in back[:6]],
        rate=j_dvfs.RateState(*map(jnp.asarray, back.rate)),
        kept_total=jnp.asarray(back.kept_total),
        energy_pj=jnp.asarray(back.energy_pj),
        latency_ns=jnp.asarray(back.latency_ns),
        ctrl=js.ControlState(*map(jnp.asarray, back.ctrl)),
    )
    jprep = jp._prepare(stream.xy, stream.ts, jc)
    jrest = jax.tree.map(lambda a: a[half:], jp._chunk_inputs(jprep))
    jfin2, _ = jax.jit(lambda s, c: js.detector_scan(jc, s, c))(jback,
                                                                jrest)
    np.testing.assert_array_equal(np.asarray(jfin2.surface), jfull.surface)
    np.testing.assert_array_equal(np.asarray(jfin2.key), jfull.key)


@pytest.mark.parametrize("fused", [False, True], ids=["torch", "fused"])
def test_batched_equals_per_stream(fused):
    streams = [synthetic.shapes_stream(height=H, width=W, duration_us=20_000,
                                       n_shapes=1, seed=s) for s in (5, 6)]
    e = min(len(s) for s in streams)
    xy = np.stack([s.xy[:e] for s in streams])
    ts = np.stack([s.ts[:e] for s in streams])
    _, tc = _with_backend(_configs(inject_ber=True, dvfs=True,
                                   dvfs_online=True), fused)
    seeds = [4, 9]
    batch = tp.run_pipeline_batched(xy, ts, tc, seeds=seeds)
    for i, seed in enumerate(seeds):
        one = tp.run_pipeline(xy[i], ts[i], dataclasses.replace(tc,
                                                                seed=seed))
        for field in ("scores", "kept", "tos", "lut", "vdd_trace"):
            np.testing.assert_array_equal(getattr(batch[i], field),
                                          getattr(one, field))
        assert batch[i].energy_pj == one.energy_pj


def test_default_device_is_cuda_and_raises_without_it(monkeypatch, stream):
    assert tp.PipelineConfig().device == "cuda"
    assert tp.PipelineConfig().backend == "fused"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        tp.run_pipeline(stream.xy, stream.ts,
                        tp.PipelineConfig(height=H, width=W))


@pytest.mark.parametrize("entry", ["detector_init", "state_from_numpy"])
def test_state_entry_points_default_to_cuda_and_raise_without_it(
        monkeypatch, entry):
    """The step API builds its state on the card unless told otherwise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tp.PipelineConfig(height=H, width=W)
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "detector_init":
            ts_.detector_init(cfg)
        else:
            ts_.state_from_numpy(ts_.state_to_numpy(ts_.detector_init(
                cfg, device="cpu")))


def test_detector_init_follows_cfg_device():
    _, tc = _configs()
    state = ts_.detector_init(tc)
    assert all(t.device.type == "cpu" for t in (
        state.surface, state.sae, state.lut, state.key, state.kept_total,
        *state.rate))


# The one-hot update is ported (``tests/test_torch_pipeline_reference.py``
# holds it); with it, interpret is still refused.
@pytest.mark.parametrize("option", [dict(use_onehot_update=True,
                                         interpret=True),
                                    dict(interpret=True),
                                    dict(interpret=False)])
def test_reference_only_options_rejected(option):
    with pytest.raises(ValueError, match="reference"):
        tp.PipelineConfig(device="cpu", **option)


@pytest.mark.parametrize("backend", ["pallas_nmc", "pallas_batched", "jnp",
                                     "pallas_fused"])
def test_unported_backends_rejected(stream, backend):
    """The reference's backend names are refused with the port's twin."""
    twin = {"pallas_nmc": "nmc", "pallas_batched": "batched", "jnp": "torch",
            "pallas_fused": "fused"}[backend]
    cfg = tp.PipelineConfig(height=H, width=W, backend=backend, device="cpu")
    with pytest.raises(ValueError, match=f"twin is '{twin}'"):
        tp.run_pipeline(stream.xy, stream.ts, cfg)


# The TOS-update backends and the reference backend each is the twin of.
TOS_BACKENDS = {"nmc": "pallas_nmc", "batched": "pallas_batched"}
TOS_MODES = {
    "fixed": dict(),
    "ber_0.6V": dict(inject_ber=True, vdd=0.6),
    "dvfs_online_ber": dict(dvfs=True, dvfs_online=True, inject_ber=True),
}
TH, TW = 128, 128


def _random_events(seed, e=512):
    """The reference's backend-parity stream (tests/test_scan_pipeline.py):
    uniform events on 128 x 128."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.integers(0, TW, e), rng.integers(0, TH, e)],
                  1).astype(np.int32)
    return xy, np.sort(rng.integers(0, 20_000, e)).astype(np.int64)


def _tos_configs(backend, mode):
    base = dict(height=TH, width=TW, chunk=128, lut_every_chunks=2,
                **TOS_MODES[mode])
    return (jp.PipelineConfig(backend=TOS_BACKENDS[backend], **base),
            tp.PipelineConfig(backend=backend, device="cpu", **base))


@pytest.mark.parametrize("mode", sorted(TOS_MODES))
@pytest.mark.parametrize("backend", sorted(TOS_BACKENDS))
def test_tos_backends_match_reference(backend, mode):
    """``"nmc"`` / ``"batched"`` equal the reference's ``"pallas_nmc"`` /
    ``"pallas_batched"`` (interpret mode) and the port's ``"fused"``."""
    xy, ts = _random_events(0)
    jc, tc = _tos_configs(backend, mode)
    got = tp.run_pipeline(xy, ts, tc)
    _assert_results(got, jp.run_pipeline(xy, ts, jc))
    fused = tp.run_pipeline(xy, ts, dataclasses.replace(tc, backend="fused"))
    for field in ("scores", "kept", "tos", "lut", "vdd_trace"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(fused, field))


@pytest.mark.parametrize("backend", sorted(TOS_BACKENDS))
def test_tos_backends_batched_lanes_match_reference(backend):
    """``run_pipeline_batched`` with two lanes (own streams and seeds)."""
    evs = [_random_events(s) for s in (1, 2)]
    xy = np.stack([x for x, _ in evs])
    ts = np.stack([t for _, t in evs])
    jc, tc = _tos_configs(backend, "dvfs_online_ber")
    got = tp.run_pipeline_batched(xy, ts, tc, seeds=[3, 4])
    want = jp.run_pipeline_batched(xy, ts, jc, seeds=[3, 4])
    for g, w in zip(got, want):
        _assert_results(g, w)


@pytest.mark.parametrize("backend", sorted(TOS_BACKENDS))
def test_tos_backends_carry_reference_state(stream, backend):
    """A mid-stream reference state (``pallas_*`` backend) restored into
    the port finishes exactly as the reference does."""
    jc, tc = _with_backend(_configs(**MODES["ber_0.6V"]), False)
    jc = dataclasses.replace(jc, backend=TOS_BACKENDS[backend])
    tc = dataclasses.replace(tc, backend=backend)
    jfull, jouts, _, _ = _scan_both(stream, jc, tc)
    half = jouts.keep.shape[0] // 2
    jmid, _, tmid, _ = _scan_both(stream, jc, tc, hi=half)
    _assert_state(tmid, jmid)
    tprep = tp._prepare(stream.xy, stream.ts, tc)
    rest = ts_.ChunkInput(*(t[half:] for t in tp._chunk_inputs([tprep],
                                                                "cpu")))
    tfin, touts = ts_.detector_scan(
        tc, ts_.state_from_numpy(jmid, device="cpu"), rest)
    _assert_state(tfin, jfull)
    np.testing.assert_array_equal(touts.keep[:, 0].numpy(),
                                  jouts.keep[half:])
    _close(touts.scores[:, 0].numpy(), jouts.scores[half:])


def test_empty_stream_matches_reference():
    xy, ts = np.zeros((0, 2), np.int32), np.zeros((0,), np.int64)
    jc, tc = _configs()
    want = jp.run_pipeline(xy, ts, jc)
    got = tp.run_pipeline(xy, ts, tc)
    _assert_results(got, want)
    assert got.scores.shape == (0,) and got.tos.shape == (H, W)
