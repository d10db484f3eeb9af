"""The port's ``PrefetchingLoader`` and dataset registry against the
reference's (``repro.events.stream`` / ``repro.events.datasets``), on the
CPU: the cases of ``tests/test_events.py`` (chunk order and contents,
worker-error propagation, ``close()``, the context manager, ``start_chunk``
resume, the int32 overflow guard) with every chunk equal to the
reference's, and the registry equal field for field and array for array.
Bound: exact."""
import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")
import torch  # noqa: E402

from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from repro.events import datasets as j_datasets  # noqa: E402
from repro.events import stream as j_stream  # noqa: E402
from repro.events import synthetic as j_synthetic  # noqa: E402
from repro_torch.events import datasets as t_datasets  # noqa: E402
from repro_torch.events import stream as t_stream  # noqa: E402
from repro_torch.events import synthetic as t_synthetic  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _loader(stream, chunk, **kw):
    return t_stream.PrefetchingLoader(stream, chunk, device="cpu", **kw)


def _host(items):
    return [tuple(np.asarray(t) for t in item) for item in items]


def _assert_chunks(got, want):
    assert len(got) == len(want)
    for (gx, gt, gv), (rx, rt, rv) in zip(got, want):
        assert (gx.dtype, gt.dtype, gv.dtype) == (np.int32, np.int32, bool)
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gt, rt)
        np.testing.assert_array_equal(gv, rv)


@pytest.mark.parametrize("chunk,depth,rebase", [(512, 2, 0), (64, 1, 0),
                                                (256, 3, 12_345)])
def test_chunks_equal_reference_loader(chunk, depth, rebase):
    st = t_synthetic.shapes_stream(duration_us=20_000, seed=4)
    jst = j_synthetic.shapes_stream(duration_us=20_000, seed=4)
    with _loader(st, chunk, depth=depth, rebase_us=rebase) as loader:
        got = _host(loader)
    with j_stream.PrefetchingLoader(jst, chunk, depth=depth,
                                    rebase_us=rebase) as loader:
        want = _host(loader)
    _assert_chunks(got, want)
    # ... and chunk_iterator's chunks after the rebase
    ref = [(x, (t - rebase).astype(np.int32), v)
           for x, t, v in t_stream.chunk_iterator(st, chunk)]
    _assert_chunks(got, ref)
    assert sum(int(v.sum()) for _, _, v in got) == len(st)


def test_items_are_fresh_tensors():
    st = t_synthetic.shapes_stream(duration_us=5_000, seed=4)
    with _loader(st, 128) as loader:
        items = list(loader)
    assert all(isinstance(t, torch.Tensor) and t.device.type == "cpu"
               for item in items for t in item)
    ptrs = [t.data_ptr() for item in items for t in item]
    assert len(set(ptrs)) == len(ptrs)


def test_propagates_worker_error():
    class Exploding:
        xy = np.zeros((10, 2), np.int32)
        ts = np.zeros((10,), np.int64)

        def __len__(self):
            raise RuntimeError("boom in worker")

    loader = _loader(Exploding(), 4)
    with pytest.raises(RuntimeError, match="boom in worker"):
        list(loader)
    with pytest.raises(StopIteration):   # the error is raised once
        next(loader)
    loader.close()
    assert not loader._thread.is_alive()


def test_close_stops_thread():
    st = t_synthetic.shapes_stream(duration_us=20_000, seed=4)
    loader = _loader(st, 64, depth=1)
    next(loader)                       # consume one chunk, abandon the rest
    loader.close()
    assert not loader._thread.is_alive()
    with pytest.raises(StopIteration):
        next(loader)
    loader.close()                     # idempotent


def test_context_manager():
    st = t_synthetic.shapes_stream(duration_us=20_000, seed=4)
    with _loader(st, 128, depth=1) as loader:
        next(loader)
    assert not loader._thread.is_alive()


def test_resume_matches_slice():
    """start_chunk > 0 yields exactly the chunks chunk_iterator would from
    that index, as the reference's loader does."""
    st = t_synthetic.shapes_stream(duration_us=20_000, seed=4)
    jst = j_synthetic.shapes_stream(duration_us=20_000, seed=4)
    ref = [(x, t.astype(np.int32), v)
           for x, t, v in list(j_stream.chunk_iterator(jst, 256))[3:]]
    with _loader(st, 256, start_chunk=3) as loader:
        got = _host(loader)
    _assert_chunks(got, ref)
    loader2 = _loader(st, 256, start_chunk=1, depth=1)
    next(loader2)
    loader2.close()
    assert not loader2._thread.is_alive()


def test_overflow_guard():
    class FarFuture:
        xy = np.zeros((4, 2), np.int32)
        ts = np.full((4,), 2**32, np.int64)

        def __len__(self):
            return 4

    with _loader(FarFuture(), 4, device_slabs=True, rebase_us=0) as loader:
        with pytest.raises(OverflowError, match="int32 after rebase"):
            list(loader)
    with _loader(FarFuture(), 4, device_slabs=True,
                 rebase_us=2**32) as loader:
        chunks = list(loader)
    assert len(chunks) == 1 and loader.device_slabs
    assert int(chunks[0][1][0]) == 0


def test_cuda_asked_for_without_it_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    st = t_synthetic.shapes_stream(duration_us=2_000, seed=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_stream.PrefetchingLoader(st, 128)


def test_dataset_registry_equals_reference():
    assert list(t_datasets.DATASETS) == list(j_datasets.DATASETS)
    for name, spec in j_datasets.DATASETS.items():
        assert dataclasses.asdict(t_datasets.DATASETS[name]) == \
            dataclasses.asdict(spec)
    prof = t_datasets.load_profile("driving")
    spec = t_datasets.DATASETS["driving"]
    assert prof.max() <= spec.max_rate_meps + 1e-9
    assert prof.max() > 0.5 * spec.max_rate_meps


@pytest.mark.parametrize("name", sorted(j_datasets.DATASETS))
def test_dataset_arrays_equal_reference(name):
    for kw in (dict(), dict(n_windows=240, seed=3)):
        np.testing.assert_array_equal(t_datasets.load_profile(name, **kw),
                                      j_datasets.load_profile(name, **kw))
    got, want = t_datasets.load(name, seed=1), j_datasets.load(name, seed=1)
    for field in ("xy", "ts", "pol", "is_corner"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
    assert (got.height, got.width) == (want.height, want.width)


def test_many_loaders_under_fast_thread_switching():
    """More loader threads than cores, consumed in turns with a very short
    switch interval: every loader still yields exactly chunk_iterator's
    chunks, in order, and every worker is joined."""
    import os
    import sys
    st = t_synthetic.shapes_stream(duration_us=8_000, seed=5)
    want = [(x, t.astype(np.int32), v)
            for x, t, v in t_stream.chunk_iterator(st, 32)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        loaders = [_loader(st, 32, depth=1)
                   for _ in range(2 * (os.cpu_count() or 1) + 2)]
        got = [[] for _ in loaders]
        for _ in range(len(want)):
            for out, loader in zip(got, loaders):
                out.append(tuple(np.asarray(t) for t in next(loader)))
        for loader in loaders:
            with pytest.raises(StopIteration):
                next(loader)
            loader.close()
            assert not loader._thread.is_alive()
    finally:
        sys.setswitchinterval(old)
    for out in got:
        _assert_chunks(out, want)
