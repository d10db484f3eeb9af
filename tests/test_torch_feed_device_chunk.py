"""``StreamingDetector.feed_device_chunk`` of the port against the JAX
pipeline, on the CPU: a session fed through the port's
``PrefetchingLoader(device_slabs=True)`` gives the reference
``run_pipeline``'s kept mask, final surface and float64 energy book
exactly and its scores within ``1e-5 * max|R|`` (the case of
``tests/test_streaming.py``'s device-slab feed), and the port's own batch
scan bit for bit.  The reference's two ``RuntimeError``s hold, and tensors
on another device, of another dtype or of another length are refused."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

from _torch_pool_harness import close, one_torch_thread  # noqa: E402,F401
from repro.core import pipeline as jp  # noqa: E402
from repro_torch.core import pipeline as tp  # noqa: E402
from repro_torch.events import stream as t_stream  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402
from repro_torch.serve import StreamingDetector, session_base_us  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 3001


@pytest.fixture(scope="module")
def stream():
    st = synthetic.shapes_stream(duration_us=30_000, seed=0)
    return synthetic.EventStream(
        xy=st.xy[:N], ts=st.ts[:N], pol=st.pol[:N],
        is_corner=st.is_corner[:N], height=st.height, width=st.width)


MODES = {"fixed": dict(), "dvfs_online_ber": dict(dvfs=True,
                                                  dvfs_online=True,
                                                  inject_ber=True)}


def _feed(cfg, st):
    base = session_base_us(int(st.ts[0]), cfg)
    det = StreamingDetector(cfg, base_ts=base)
    scores, kept = [], []
    with t_stream.PrefetchingLoader(st, cfg.chunk, device_slabs=True,
                                    rebase_us=base, device="cpu") as loader:
        for cxy, cts, cval in loader:
            s, k = det.feed_device_chunk(cxy, cts, cval)
            scores.append(s)
            kept.append(k)
    return det, np.concatenate(scores), np.concatenate(kept)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_device_slab_feed_matches_jax_pipeline(stream, mode):
    base = dict(chunk=256, lut_every_chunks=2, **MODES[mode])
    ref = jp.run_pipeline(stream.xy, stream.ts, jp.PipelineConfig(**base))
    cfg = tp.PipelineConfig(device="cpu", **base)
    det, scores, kept = _feed(cfg, stream)
    np.testing.assert_array_equal(kept, ref.kept)
    close(scores, ref.scores)
    np.testing.assert_array_equal(det.state.surface[0].numpy(), ref.tos)
    assert det.energy_pj == ref.energy_pj
    assert det.n_events == N and det.kept_total == int(ref.kept.sum())
    assert det.vdd_trace == list(ref.vdd_trace)
    # ... and the port's own scan, bit for bit
    scan = tp.run_pipeline(stream.xy, stream.ts, cfg)
    np.testing.assert_array_equal(scores, scan.scores)
    np.testing.assert_array_equal(det.state.lut[0].numpy(), scan.lut)


def _session(chunk=256, base=0):
    return StreamingDetector(tp.PipelineConfig(chunk=chunk, device="cpu"),
                             base_ts=base)


def _chunk(e=256):
    return (torch.zeros((e, 2), dtype=torch.int32),
            torch.zeros((e,), dtype=torch.int32),
            torch.zeros((e,), dtype=torch.bool))


def test_refuses_a_buffered_session(stream):
    det = _session()
    det.feed(stream.xy[:10], stream.ts[:10])
    with pytest.raises(RuntimeError, match="flush\\(\\) first"):
        det.feed_device_chunk(*_chunk())


def test_refuses_without_a_base():
    det = StreamingDetector(tp.PipelineConfig(chunk=256, device="cpu"))
    with pytest.raises(RuntimeError, match="set base_ts"):
        det.feed_device_chunk(*_chunk())


@pytest.mark.parametrize("which", range(3))
def test_refuses_another_device(which):
    args = list(_chunk())
    args[which] = torch.empty_like(args[which], device="meta")
    with pytest.raises(ValueError, match="session's device"):
        _session().feed_device_chunk(*args)


@pytest.mark.parametrize("which,dtype", [(0, torch.int64), (1, torch.int64),
                                         (2, torch.uint8)])
def test_refuses_another_dtype(which, dtype):
    args = list(_chunk())
    args[which] = args[which].to(dtype)
    with pytest.raises(ValueError, match="session's chunk"):
        _session().feed_device_chunk(*args)


def test_refuses_another_length():
    with pytest.raises(ValueError, match="session's chunk"):
        _session(chunk=256).feed_device_chunk(*_chunk(128))
    det = _session(chunk=256)
    with pytest.raises(ValueError, match="session's chunk"):
        det.feed_device_chunk(*(t[None] for t in _chunk()))
    assert det.n_chunks == 0 and det.n_events == 0


def test_mixes_with_feed_after_flush(stream):
    """Device chunks after a flushed host feed continue the same fold: the
    session equals one fed through the host path alone."""
    cfg = dataclasses.replace(tp.PipelineConfig(device="cpu"), chunk=256,
                              lut_every_chunks=2)
    base = session_base_us(int(stream.ts[0]), cfg)
    a = StreamingDetector(cfg, base_ts=base)
    b = StreamingDetector(cfg, base_ts=base)
    cut = 4 * 256
    head = [a.feed(stream.xy[:cut], stream.ts[:cut])[0], a.flush()[0]]
    sub = synthetic.EventStream(
        xy=stream.xy[cut:], ts=stream.ts[cut:], pol=stream.pol[cut:],
        is_corner=stream.is_corner[cut:], height=stream.height,
        width=stream.width)
    with t_stream.PrefetchingLoader(sub, 256, device_slabs=True,
                                    rebase_us=base, device="cpu") as ld:
        tail = [a.feed_device_chunk(*c)[0] for c in ld]
    want = [b.feed(stream.xy, stream.ts)[0], b.flush()[0]]
    np.testing.assert_array_equal(np.concatenate(head + tail),
                                  np.concatenate(want))
    assert a.energy_pj == b.energy_pj and a.n_events == b.n_events
