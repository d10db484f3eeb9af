"""Spans inside the port (``repro_torch.obs.spans``): on exactly while the
torch profiler runs, nested as the pool's code nests, and without effect
on what the pool computes.

A small async pool on the CPU (two 64x96 lanes, 128-event chunks, write
errors and online DVFS, a ring of two rounds so the pump forces a drain)
is served once without the profiler and once under it.  The card-only
part, the device span's CUDA events, is marked ``cuda``.
"""
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.benchmarks.timing import device_rows
from repro_torch.core import pipeline
from repro_torch.events import synthetic
from repro_torch.obs import spans
from repro_torch.obs.schema import WALL_TIME_KEYS
from repro_torch.serve import DetectorPool

H, W, CHUNK, LANES = 64, 96, 128, 2
PUMP_SPANS = ("pool.pump", "pool.collect", "pool.stage", "pool.dispatch",
              "pool.forced_drain", "pool.step", "step.draw", "pool.push",
              "pool.poll", "pool.seal", "pool.poll_wait")
PARENTS = {"pool.collect": ("pool.pump",), "pool.stage": ("pool.pump",),
           "pool.dispatch": ("pool.pump",),
           "pool.forced_drain": ("pool.dispatch",),
           "pool.step": ("pool.dispatch",), "step.draw": ("pool.step",),
           "pool.push": ("pool.dispatch",),
           "pool.seal": ("pool.poll", "pool.forced_drain"),
           "pool.poll_wait": ("pool.poll",)}


@pytest.fixture(scope="module")
def one_torch_thread():
    """The pool's tensors are tiny and the test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve():
    """Three turns of six chunks a lane through a two-round ring, each
    turn a pump and a poll of every lane; returns what the pool gave."""
    cfg = pipeline.PipelineConfig(
        height=H, width=W, chunk=CHUNK, lut_every_chunks=2, dvfs=True,
        dvfs_online=True, inject_ber=True, backend="fused", device="cpu")
    streams = [synthetic.shapes_stream(height=H, width=W, duration_us=40_000,
                                       n_shapes=2, seed=i)
               for i in range(LANES)]
    pool = DetectorPool(cfg, LANES, ring_rounds=2, drain_mode="async")
    try:
        lanes = [pool.connect(seed=7 + i) for i in range(LANES)]
        got = {ln: ([], []) for ln in lanes}
        slab = 6 * CHUNK
        for t in range(3):
            for ln, st in zip(lanes, streams):
                pool.feed(ln, st.xy[t * slab:(t + 1) * slab],
                          st.ts[t * slab:(t + 1) * slab])
            pool.pump()
            for ln in lanes:
                s, k = pool.poll(ln)
                got[ln][0].append(s)
                got[ln][1].append(k)
        out = {ln: (np.concatenate(s), np.concatenate(k))
               for ln, (s, k) in got.items()}
        return out, [pool.stats(ln) for ln in lanes], pool.pool_stats()
    finally:
        pool.close()


@pytest.fixture(scope="module")
def plain(one_torch_thread):
    spans.reset()
    out = _serve()
    return out, spans.snapshot()


@pytest.fixture(scope="module")
def traced(one_torch_thread, tmp_path_factory):
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _serve()
    snap = spans.snapshot()
    spans.reset()
    path = tmp_path_factory.mktemp("trace") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["name"], e["tid"], float(e["ts"]),
               float(e["ts"]) + float(e.get("dur", 0.0)))
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    return out, snap, ranges


def test_profiler_flag_flips():
    """The span's switch; a torch that renames it fails here, loudly."""
    assert autograd_profiler._is_profiler_enabled is False
    assert spans.span("x") is spans.span("y")           # the null context
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert spans.span("x") is not spans.span("x")
    assert autograd_profiler._is_profiler_enabled is False
    assert obs.span is spans.span


def test_off_enters_no_record_function_and_records_nothing(
        one_torch_thread, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with tracing off")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    spans.reset()
    (_, _, stats) = _serve()
    assert spans.snapshot() == {}
    # the pool_stats() timers that spans feed still count with tracing off
    assert stats["pump_stage_s"] > 0 and stats["pump_drain_wait_s"] > 0
    assert stats["pump_forced_drains"] > 0


def test_trace_holds_every_pump_span_inside_its_parent(traced):
    _, _, ranges = traced
    names = {n for n, *_ in ranges}
    assert set(PUMP_SPANS) <= names, set(PUMP_SPANS) - names
    for name, tid, s, e in ranges:
        if name not in PARENTS:
            continue
        assert any(pn in PARENTS[name] and pt == tid and ps <= s
                   and e <= pe for pn, pt, ps, pe in ranges), (name, s, e)


def test_snapshot_counts_every_range_of_the_trace(traced):
    """Every span the pool opened is a range in the trace: the reader
    thread, which the profiler does not see, opens none."""
    _, snap, ranges = traced
    assert set(snap) == set(PUMP_SPANS)
    for name in PUMP_SPANS:
        assert snap[name]["count"] == sum(n == name for n, *_ in ranges)
    rounds = snap["pool.step"]["count"]
    assert rounds == 3 * 6 and snap["pool.push"]["count"] == rounds
    assert snap["step.draw"]["count"] == rounds
    assert snap["pool.collect"]["count"] == rounds
    for row in snap.values():
        assert 0 <= row["self_seconds"] <= row["seconds"] + 1e-12
        assert row["device_seconds"] is None        # no CUDA here
    pump = snap["pool.pump"]
    kids = sum(snap[n]["seconds"] for n in ("pool.collect", "pool.stage",
                                            "pool.dispatch"))
    assert pump["self_seconds"] == pytest.approx(pump["seconds"] - kids,
                                                 abs=1e-9)


def test_profiled_pool_computes_what_the_plain_one_does(plain, traced):
    (out_a, lanes_a, pool_a), snap_a = plain
    (out_b, lanes_b, pool_b), _, _ = traced
    assert snap_a == {}
    assert out_a.keys() == out_b.keys()
    for ln in out_a:
        np.testing.assert_array_equal(out_a[ln][0], out_b[ln][0])
        np.testing.assert_array_equal(out_a[ln][1], out_b[ln][1])

    def steady(d):
        return {k: v for k, v in d.items() if k not in WALL_TIME_KEYS}
    assert [steady(s) for s in lanes_a] == [steady(s) for s in lanes_b]
    assert steady(pool_a) == steady(pool_b)


def test_self_time_is_the_duration_less_the_children():
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with spans.span("outer"):
            time.sleep(0.002)
            with spans.span("a"):
                time.sleep(0.003)
            with spans.span("b"):
                with spans.span("c"):
                    time.sleep(0.002)
                time.sleep(0.001)
            # a span on another thread is no child of this one
            t = threading.Thread(target=_sleep_span)
            t.start()
            t.join(5)
            assert not t.is_alive()
    snap = spans.snapshot()
    spans.reset()
    sec = {n: r["seconds"] for n, r in snap.items()}
    own = {n: r["self_seconds"] for n, r in snap.items()}
    assert own["outer"] == pytest.approx(
        sec["outer"] - sec["a"] - sec["b"], abs=1e-12)
    assert own["b"] == pytest.approx(sec["b"] - sec["c"], abs=1e-12)
    assert own["a"] == sec["a"] and own["c"] == sec["c"]
    assert own["other"] == sec["other"] >= 0.004
    assert own["outer"] >= 0.002 + 0.004 and own["b"] >= 0.001
    assert all(r["count"] == 1 for r in snap.values())


def _sleep_span():
    with spans.span("other"):
        time.sleep(0.004)


def test_timed_span_reads_the_clock_with_tracing_off():
    spans.reset()
    with spans.span("t", timed=True) as sp:
        time.sleep(0.001)
    assert sp.seconds >= 0.001
    with spans.span("u") as sp:
        pass
    assert sp.seconds is None
    assert spans.snapshot() == {}


def test_device_rows_leave_out_span_annotations():
    """A span that launched device work also has a device-side row as long
    as its range; a device sum counts kernels and copies only."""
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def row(key, device_type, **kw):
        return SimpleNamespace(key=key, device_type=device_type, **kw)
    rows = [row("fused_tile_kernel", cuda, is_user_annotation=False),
            row("pool.step", cuda, is_user_annotation=True),
            row("step.draw", cuda, is_user_annotation=True),
            row("Memcpy DtoH", cuda),       # a torch without the field
            row("pool.step", cpu, is_user_annotation=True),
            row("aten::add", cpu, is_user_annotation=False)]
    prof = SimpleNamespace(key_averages=lambda: rows)
    assert [r.key for r in device_rows(prof)] == ["fused_tile_kernel",
                                                  "Memcpy DtoH"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (CUDA events)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_device_span_times_the_stream_on_the_card(cuda):
    x = torch.ones(4096, 4096, device=cuda)
    torch.cuda.synchronize()
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        for _ in range(3):
            with spans.span("mm", device=x.device):
                y = x @ x
        with spans.span("host"):
            pass
        torch.cuda.synchronize()
    snap = spans.snapshot()
    spans.reset()
    assert float(y[0, 0]) == 4096.0
    assert snap["mm"]["count"] == 3
    assert snap["mm"]["device_seconds"] > 0
    assert snap["host"]["device_seconds"] is None
