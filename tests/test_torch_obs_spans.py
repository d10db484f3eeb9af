"""Spans inside the port (``repro_torch.obs.spans``): on exactly while the
torch profiler runs, nested as the pool's code nests, and without effect
on what the pool computes.

A small async pool on the CPU (two 64x96 lanes, 128-event chunks, write
errors and online DVFS, a ring of two rounds so the pump forces a drain)
is served once without the profiler and once under it, and so is an
adaptive pool of four lanes whose rates ramp up and down across its
buckets, which moves lanes (``pool.observe``, ``pool.migrate``) and ends
on flushes (``pool.flush``).  The card-only part, the device span's CUDA
events, is marked ``cuda``.
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
from repro_torch.core import state as state_mod
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
COUNTERS = ("step.lanes_stepped", "step.lanes_active")


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
    assert spans.tracing() is False
    assert spans.span("x") is spans.span("y")           # the null context
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert spans.tracing() is True
        assert spans.span("x") is not spans.span("x")
    assert autograd_profiler._is_profiler_enabled is False
    assert spans.tracing() is False
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
    assert set(snap) == set(PUMP_SPANS) | set(COUNTERS)
    for name in PUMP_SPANS:
        assert snap[name]["count"] == sum(n == name for n, *_ in ranges)
    rounds = snap["pool.step"]["count"]
    assert rounds == 3 * 6 and snap["pool.push"]["count"] == rounds
    assert snap["step.draw"]["count"] == rounds
    assert snap["pool.collect"]["count"] == rounds
    # every round steps both lanes, both active
    for name in COUNTERS:
        assert snap[name] == {"count": rounds, "total": rounds * LANES}
    for row in (snap[n] for n in PUMP_SPANS):
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


# -- an adaptive pool: moves, observations and flushes ----------------------

AD_LANES, AD_TURNS, HALF_US = 4, 24, 5_000
AD_BUCKETS = (64, 128, 256)
# events per 5 ms half-window over one cycle; lane i starts 3 i into it
RAMP = (16, 24, 40, 64, 112, 192, 320, 320, 192, 112, 64, 40)
MOVE_PARENTS = ("pool.observe", "pool.pump", "pool.flush")


def _ramp_feed(lane: int) -> list:
    """One slab per turn: the lane's next half-window of random events."""
    rng = np.random.default_rng(100 + lane)
    out = []
    for t in range(AD_TURNS):
        n = RAMP[(t + 3 * lane) % len(RAMP)]
        ts = np.sort(rng.integers(t * HALF_US, (t + 1) * HALF_US, n))
        xy = np.stack([rng.integers(0, W, n), rng.integers(0, H, n)], 1)
        out.append((xy.astype(np.int32), ts.astype(np.int64)))
    return out


def _serve_adaptive(steps=None):
    """``AD_TURNS`` turns of feed, pump and poll on an adaptive pool, then
    a flush of every lane; ``steps`` collects each detector step's lane
    count and mask sum.  Returns what the pool gave, its lanes' stats,
    its pool stats and the flushes made."""
    cfg = pipeline.PipelineConfig(
        height=H, width=W, chunk=128, lut_every_chunks=2, dvfs=True,
        dvfs_online=True, inject_ber=True, backend="fused", device="cpu")
    feeds = [_ramp_feed(i) for i in range(AD_LANES)]
    pool = DetectorPool(cfg, AD_LANES, ring_rounds=2, drain_mode="async",
                        policy="adaptive", buckets=AD_BUCKETS,
                        migrate_patience=1)
    orig = state_mod.detector_step_

    def step(cfg_, state, chunk, mask=None):
        steps.append((state.surface.shape[0], int(np.sum(mask))))
        return orig(cfg_, state, chunk, mask=mask)
    try:
        if steps is not None:
            state_mod.detector_step_ = step
        lanes = [pool.connect(seed=11 + i) for i in range(AD_LANES)]
        got = {ln: ([], []) for ln in lanes}
        for t in range(AD_TURNS):
            for ln, feed in zip(lanes, feeds):
                pool.feed(ln, *feed[t])
            pool.pump()
            for ln in lanes:
                for out, part in zip(got[ln], pool.poll(ln)):
                    out.append(part)
        for ln in lanes:
            for out, part in zip(got[ln], pool.flush(ln)):
                out.append(part)
        out = {ln: (np.concatenate(s), np.concatenate(k))
               for ln, (s, k) in got.items()}
        return (out, [pool.stats(ln) for ln in lanes], pool.pool_stats(),
                len(lanes))
    finally:
        state_mod.detector_step_ = orig
        pool.close()


@pytest.fixture(scope="module")
def adaptive_plain(one_torch_thread):
    spans.reset()
    out = _serve_adaptive()
    return out, spans.snapshot()


@pytest.fixture(scope="module")
def adaptive_traced(one_torch_thread, tmp_path_factory):
    spans.reset()
    steps = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _serve_adaptive(steps)
    snap = spans.snapshot()
    spans.reset()
    path = tmp_path_factory.mktemp("trace_ad") / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [(e["name"], e["tid"], float(e["ts"]),
               float(e["ts"]) + float(e.get("dur", 0.0)))
              for e in events if e.get("ph") == "X"
              and e.get("cat") == "user_annotation"]
    return out, snap, ranges, steps


def test_adaptive_pool_moves_every_lane(adaptive_traced):
    """The feeds do what the other adaptive tests need: every lane moves,
    up and down, and sits in every bucket."""
    (_, lane_stats, _, _), _, _, _ = adaptive_traced
    for st in lane_stats:
        log = st["migration_log"]
        assert any(new > old for _, old, new in log), log
        assert any(new < old for _, old, new in log), log
        assert {b for _, old, new in log for b in (old, new)} == set(
            AD_BUCKETS)


def test_migrate_opens_per_staged_and_per_applied_move(adaptive_traced):
    """Each move opens ``pool.migrate`` where a poll or flush stages it
    and where the next pump or flush applies it: twice the logged moves,
    plus the moves still staged when the lanes' last flushes decided
    them (each staging applies, none is cancelled or replaced here)."""
    (_, lane_stats, pool_stats, _), snap, ranges, _ = adaptive_traced
    logged = sum(len(st["migration_log"]) for st in lane_stats)
    assert logged == pool_stats["migrations_total"] > 0
    want = 2 * logged + pool_stats["migrations_staged"]
    assert snap["pool.migrate"]["count"] == want
    assert sum(n == "pool.migrate" for n, *_ in ranges) == want


@pytest.mark.parametrize("name,parents", [
    ("pool.migrate", MOVE_PARENTS),
    ("pool.observe", ()),
    ("pool.flush", ())])
def test_adaptive_spans_nest_as_the_pool_does(adaptive_traced, name,
                                             parents):
    """A move's span lies inside the observation that staged it or the
    pump or flush that applied it; an observation and a flush are
    outermost (the pool's own calls open them)."""
    _, _, ranges, _ = adaptive_traced
    mine = [r for r in ranges if r[0] == name]
    assert mine
    for _, tid, s, e in mine:
        inside = {pn for pn, pt, ps, pe in ranges
                  if pt == tid and ps <= s and e <= pe and (ps, pe) != (s, e)}
        if parents:
            assert inside & set(parents), (name, inside)
        else:
            assert not inside & {"pool.pump", "pool.poll", "pool.observe",
                                 "pool.flush"}, (name, inside)


def test_flush_opens_per_flush_and_observe_per_observation(
        adaptive_traced):
    (_, _, _, flushes), snap, _, _ = adaptive_traced
    assert snap["pool.flush"]["count"] == flushes
    # every poll and every flush is one observation
    assert snap["pool.observe"]["count"] == AD_LANES * AD_TURNS + flushes
    # the migrate spans inside an observation are its children
    assert 0 <= snap["pool.observe"]["self_seconds"] <= (
        snap["pool.observe"]["seconds"])


def test_step_counters_are_the_rounds_lanes_and_masks(adaptive_traced):
    """``step.lanes_stepped`` sums each step's lane count and
    ``step.lanes_active`` its mask; each step counts once."""
    (_, _, pool_stats, _), snap, _, steps = adaptive_traced
    assert len(steps) == pool_stats["rounds_executed"]
    assert snap["step.lanes_stepped"] == {
        "count": len(steps), "total": sum(b for b, _ in steps)}
    assert snap["step.lanes_active"] == {
        "count": len(steps), "total": sum(a for _, a in steps)}
    # a bucket's rounds step all four lanes for the few in the bucket
    assert sum(a for _, a in steps) < sum(b for b, _ in steps)


def test_counters_record_nothing_with_tracing_off(adaptive_plain):
    _, snap = adaptive_plain
    assert snap == {}
    spans.reset()
    spans.count("c", 3)
    assert spans.snapshot() == {}


def test_count_sums_under_the_profiler_and_reset_clears():
    spans.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        spans.count("c", 3)
        spans.count("c", 4)
        with spans.span("s"):
            pass
    snap = spans.snapshot()
    assert snap["c"] == {"count": 2, "total": 7}
    assert snap["s"]["count"] == 1
    spans.reset()
    assert spans.snapshot() == {}


def test_profiled_adaptive_pool_computes_what_the_plain_one_does(
        adaptive_plain, adaptive_traced):
    (out_a, lanes_a, pool_a, _), _ = adaptive_plain
    (out_b, lanes_b, pool_b, _), _, _, _ = adaptive_traced
    assert out_a.keys() == out_b.keys()
    for ln in out_a:
        np.testing.assert_array_equal(out_a[ln][0], out_b[ln][0])
        np.testing.assert_array_equal(out_a[ln][1], out_b[ln][1])

    def steady(d):
        return {k: v for k, v in d.items() if k not in WALL_TIME_KEYS}
    assert [steady(s) for s in lanes_a] == [steady(s) for s in lanes_b]
    assert [s["migration_log"] for s in lanes_a] == [
        s["migration_log"] for s in lanes_b]
    assert steady(pool_a) == steady(pool_b)


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
