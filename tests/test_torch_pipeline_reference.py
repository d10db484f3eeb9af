"""The port's host-loop oracle (``pipeline.run_pipeline_reference``), its
``state.select_update`` and the one-hot TOS update, on the CPU.

The cases of ``tests/test_scan_pipeline.py`` (chunk 128/256/384/512 on
3,001 events, precomputed DVFS with BER, 0.6 V with BER, a LUT never
ready).  Bounds: against the JAX oracle, kept mask, final TOS, vdd trace,
float64 books and ``host_syncs`` exact, LUT and scores within
``1e-5 * max|R|``; against the port's own scan (the default ``"fused"``
backend), every output bit for bit.  Backends ``torch``, ``nmc`` and
``batched``; ``use_onehot_update=True`` against the JAX run with the same
flag; ``tos_update_batched_onehot`` bit-equal to JAX's and to
``tos_update_batched``.
"""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from _torch_pool_harness import close, one_torch_thread  # noqa: E402,F401
from repro.core import pipeline as jp  # noqa: E402
from repro.core import tos as j_tos  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.core import state as ts_  # noqa: E402
from repro_torch.core import tos as t_tos  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def stream():
    return synthetic.shapes_stream(duration_us=30_000, seed=0)


def _configs(backend="torch", **kw):
    """The JAX config (backend ``"jnp"``: the reference's backends are bit
    for bit equal) and the port's on ``backend``."""
    return (jp.PipelineConfig(backend="jnp", **kw),
            tp.PipelineConfig(backend=backend, device="cpu", **kw))


def _assert_bitexact(a, b):
    for f in ("scores", "kept", "tos", "lut", "vdd_trace"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.energy_pj == b.energy_pj
    assert a.latency_ns_per_event == b.latency_ns_per_event


def _assert_matches_jax(got, want):
    for f in ("kept", "tos", "vdd_trace"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.energy_pj == want.energy_pj
    assert got.latency_ns_per_event == want.latency_ns_per_event
    assert got.host_syncs == want.host_syncs
    close(got.scores, want.scores)
    close(got.lut, want.lut)


def _check(xy, ts, backend="torch", **kw):
    jc, tc = _configs(backend, **kw)
    want = jp.run_pipeline_reference(xy, ts, jc)
    got = tp.run_pipeline_reference(xy, ts, tc)
    _assert_matches_jax(got, want)
    scan = tp.run_pipeline(xy, ts, dataclasses.replace(tc, backend="fused"))
    _assert_bitexact(scan, got)
    assert scan.host_syncs == 1
    return got


@pytest.mark.parametrize("chunk", [128, 256, 384, 512])
def test_oracle_across_chunk_sizes(stream, chunk):
    # 3001 events: never a multiple of any chunk size -> padded tail chunk.
    got = _check(stream.xy[:3001], stream.ts[:3001], chunk=chunk,
                 lut_every_chunks=2)
    assert got.host_syncs >= 3001 // chunk


@pytest.mark.parametrize("backend", ["torch", "nmc", "batched"])
def test_oracle_dvfs_ber(stream, backend):
    """Per-chunk Vdd and BER from the host: draw-exact to the JAX oracle,
    on every backend."""
    _check(stream.xy[:3001], stream.ts[:3001], backend, chunk=256,
           lut_every_chunks=3, dvfs=True, inject_ber=True)


def test_oracle_fixed_low_vdd_ber(stream):
    _check(stream.xy[:2048], stream.ts[:2048], chunk=256,
           lut_every_chunks=2, vdd=0.6, inject_ber=True)


def test_oracle_lut_never_ready(stream):
    got = _check(stream.xy[:512], stream.ts[:512], chunk=256,
                 lut_every_chunks=8)
    assert not np.isfinite(got.scores).any()
    assert got.host_syncs == 4     # n_kept and kept per chunk, no scores


def test_oracle_empty_stream():
    cfg = tp.PipelineConfig(chunk=256, backend="torch", device="cpu")
    got = tp.run_pipeline_reference(np.zeros((0, 2), np.int32),
                                    np.zeros((0,), np.int64), cfg)
    assert got.scores.shape == (0,) and got.kept.shape == (0,)
    assert got.energy_pj == 0.0 and got.host_syncs == 0


def test_onehot_flag_matches_jax(stream):
    """``use_onehot_update=True`` on ``"torch"``: the oracle and the scan
    equal the JAX runs with the same flag."""
    kw = dict(chunk=256, lut_every_chunks=2, vdd=0.6, inject_ber=True,
              use_onehot_update=True)
    xy, ts = stream.xy[:2048], stream.ts[:2048]
    jc, tc = _configs("torch", **kw)
    got = tp.run_pipeline_reference(xy, ts, tc)
    _assert_matches_jax(got, jp.run_pipeline_reference(xy, ts, jc))
    scan = tp.run_pipeline(xy, ts, tc)
    want = jp.run_pipeline(xy, ts, jc)
    for f in ("kept", "tos", "vdd_trace"):
        np.testing.assert_array_equal(getattr(scan, f), getattr(want, f))
    assert scan.energy_pj == want.energy_pj
    close(scan.scores, want.scores)
    _assert_bitexact(scan, got)


def _events(rng, h, w, e, layout):
    if layout == "clustered":
        c = rng.integers(0, (w, h))
        xy = np.clip(c + rng.integers(-4, 5, (e, 2)), 0, (w - 1, h - 1))
    elif layout == "edges":
        xy = np.stack([rng.choice([0, 1, w - 2, w - 1], e),
                       rng.choice([0, 1, h - 2, h - 1], e)], 1)
    else:
        xy = rng.integers(0, (w, h), (e, 2))
    return xy.astype(np.int32), rng.random(e) < 0.8


@pytest.mark.parametrize("h,w,e,patch,layout", [
    (180, 240, 1024, 7, "uniform"), (64, 96, 300, 7, "clustered"),
    (37, 101, 257, 3, "edges"), (64, 96, 64, 1, "uniform"),
    (64, 96, 200, 31, "clustered")])
def test_onehot_update_is_bit_equal(h, w, e, patch, layout):
    rng = np.random.default_rng(e + patch)
    xy, valid = _events(rng, h, w, e, layout)
    tos = np.where(rng.random((h, w)) < 0.5,
                   rng.integers(200, 256, (h, w)), 0).astype(np.uint8)
    args = (torch.from_numpy(tos), torch.from_numpy(xy),
            torch.from_numpy(valid))
    got = t_tos.tos_update_batched_onehot(*args, patch=patch, th=225)
    assert torch.equal(got, t_tos.tos_update_batched(*args, patch=patch,
                                                     th=225))
    want = j_tos.tos_update_batched_onehot(
        jnp.asarray(tos), jnp.asarray(xy), jnp.asarray(valid), patch=patch,
        th=225)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_select_update_routes():
    tos = torch.zeros((64, 96), dtype=torch.uint8)
    rng = np.random.default_rng(1)
    xy, valid = _events(rng, 64, 96, 128, "clustered")
    xy, valid = torch.from_numpy(xy), torch.from_numpy(valid)
    want = t_tos.tos_update_batched(tos, xy, valid)
    for backend, onehot in (("torch", False), ("torch", True),
                            ("nmc", False), ("batched", False)):
        cfg = tp.PipelineConfig(height=64, width=96, backend=backend,
                                use_onehot_update=onehot, device="cpu")
        assert torch.equal(ts_.select_update(cfg)(tos, xy, valid), want)


def test_select_update_refuses_fused_and_reference_names():
    with pytest.raises(ValueError, match="no standalone TOS update"):
        ts_.select_update(tp.PipelineConfig(device="cpu"))
    for name, twin in (("jnp", "torch"), ("pallas_nmc", "nmc"),
                       ("pallas_fused", "fused")):
        with pytest.raises(ValueError, match=f"twin is '{twin}'"):
            ts_.select_update(tp.PipelineConfig(backend=name, device="cpu"))


def test_oracle_refuses_fused_and_online_dvfs(stream):
    xy, ts = stream.xy[:512], stream.ts[:512]
    with pytest.raises(ValueError, match="no standalone TOS update"):
        tp.run_pipeline_reference(xy, ts, tp.PipelineConfig(device="cpu"))
    online = tp.PipelineConfig(backend="torch", dvfs=True, dvfs_online=True,
                               device="cpu")
    with pytest.raises(ValueError, match="online DVFS runs inside"):
        tp.run_pipeline_reference(xy, ts, online)


def test_oracle_refuses_cuda_without_it(stream):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.run_pipeline_reference(stream.xy[:512], stream.ts[:512],
                                  tp.PipelineConfig(backend="nmc"))
