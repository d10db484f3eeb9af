"""The cell ``davis240_x16_adaptive.burst``'s parts, on the CPU.

* The ``ramps`` generator gives the same stream for a seed, and each
  half-window of lane ``i`` carries ``round(rate * 5,000)`` events of the
  cycle at lane ``i``'s phase; ``lib.streams`` hands lane ``i`` phase ``i``.
* A throwaway checkout with the config cut to three lanes and a short
  cycle (``burst_root``) runs the cell's pool, mix and loop through
  ``bench.run``: correct, every lane in all three buckets, chunks at two
  Vdd levels; a move logged a chunk off is not correct.
* The three readers read the program's ``pool.migrate`` and
  ``pool.observe`` spans and its step counters, and read ``None`` against
  a program that has none of them (the parent of the change that added
  them).
* The cell's twins of the sat cell's readers (``TWINS``) are the same
  quantities: the same manifest entry but for name and cell, the same
  value on the same record."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench.lib import bench, manifest, streams  # noqa: E402
from perfbench.tests.test_pb_schedule import _log_one_chunk_off  # noqa: E402
from repro_torch import obs  # noqa: E402

CELL = "davis240_x16_adaptive.burst"
CONFIG = json.loads((REPO / "perfbench" / "configs"
                     / "davis240_x16_adaptive.json").read_text())
SEED = 2**31 + 3401
# a cycle short enough for the CPU: 0.005-0.5 Meps over 120 ms, the three
# lanes 40 ms apart; DVFS headroom 20 moves Vdd off 0.6 V above 0.25 Meps
TINY_STREAM = {"duration_us": 120_000, "peak_meps": 0.5, "rise_us": 50_000,
               "hold_us": 20_000, "fall_us": 50_000, "phase_step_us": 40_000}
READERS = {
    "migrate_ms_per_round.burst": ("program_span", "control plane", "ms"),
    "observe_self_ms_per_round.burst": ("program_span", "control plane",
                                        "ms"),
    "active_lane_share.burst": ("program_counter", "detector step", "%"),
}
# the cell's reader -> the sat cell's reader of the same quantity
TWINS = {
    "issue_ms_per_round.burst": "issue_ms_per_round.sat",
    "draw_device_ms_per_round.burst": "draw_device_ms_per_round.sat",
    "stage_ms_per_round.burst": "stage_ms_per_round.sat",
    "pump_self_ms_per_round.burst": "pump_self_ms_per_round.sat",
    "launches_per_round.burst": "launches_per_round.sat",
    "device_idle_pct.burst": "device_idle_pct.sat",
    "d2h_bytes_per_event.burst": "d2h_bytes_per_event.sat",
    "k1_roofline.burst": "k1_roofline",
    "k2_roofline.burst": "k2_roofline",
    "k3_roofline.burst": "k3_roofline",
}


def _ramps():
    return manifest.generator("ramps")


def _rate(t, s):
    """The cycle's rate, written out again: log-linear up, flat, down."""
    cyc = s["rise_us"] + s["hold_us"] + s["fall_us"]
    t = t % cyc
    ratio = s["peak_meps"] / s["floor_meps"]
    if t < s["rise_us"]:
        return s["floor_meps"] * ratio ** (t / s["rise_us"])
    if t < s["rise_us"] + s["hold_us"]:
        return s["peak_meps"]
    return s["peak_meps"] / ratio ** ((t - s["rise_us"] - s["hold_us"])
                                      / s["fall_us"])


def _params(stream):
    return {k: v for k, v in stream.items() if k != "generator"}


def _counts(ts, stream):
    half = stream["half_us"]
    return np.bincount(ts // half, minlength=stream["duration_us"] // half)


def _lanes(stream, cameras, seed):
    """The cameras' streams as a run makes them (``lib.streams``)."""
    replays, _ = streams.lane_streams(stream, CONFIG["sensor"], cameras, seed)
    return replays


@pytest.fixture(scope="module")
def full_lanes():
    return _lanes(CONFIG["stream"], 16, SEED)


def test_same_seed_same_stream(full_lanes):
    again = _lanes(CONFIG["stream"], 2, SEED)
    other = _lanes(CONFIG["stream"], 2, SEED + 1)
    for a, b in zip(full_lanes, again):
        np.testing.assert_array_equal(a.xy, b.xy)
        np.testing.assert_array_equal(a.ts, b.ts)
    assert not np.array_equal(full_lanes[0].xy, other[0].xy)
    for r in full_lanes:
        assert (np.diff(r.ts) >= 0).all() and r.ts.min() >= 0
        assert r.ts.max() < CONFIG["stream"]["duration_us"]
        assert (r.xy >= 0).all() and (r.xy[:, 0] < 240).all() and (
            r.xy[:, 1] < 180).all()


@pytest.mark.parametrize("lane", [0, 5, 15])
def test_half_windows_carry_the_cycles_counts(full_lanes, lane):
    s = CONFIG["stream"]
    half = s["half_us"]
    want = [round(_rate(k * half + half / 2 + lane * s["phase_step_us"],
                        s) * half)
            for k in range(s["duration_us"] // half)]
    assert _counts(full_lanes[lane].ts, s).tolist() == want
    assert _ramps().half_window_counts(lane=lane, **{
        k: s[k] for k in ("duration_us", "floor_meps", "peak_meps",
                          "rise_us", "hold_us", "fall_us", "half_us",
                          "phase_step_us")}).tolist() == want
    # the cycle's shape: 0.005 Meps at its floor, 4.5 at its peak, 1.044
    # Meps on average
    assert min(want) == 27 and max(want) == 22_500
    assert sum(want) / s["duration_us"] == pytest.approx(1.044, abs=1e-3)


def test_lane_streams_give_lane_i_phase_i():
    s = {**CONFIG["stream"], **TINY_STREAM}
    gen = _ramps()
    for i, r in enumerate(_lanes(s, 3, SEED)):
        want = gen.half_window_counts(lane=i, **{
            k: s[k] for k in ("duration_us", "floor_meps", "peak_meps",
                              "rise_us", "hold_us", "fall_us", "half_us",
                              "phase_step_us")})
        assert _counts(r.ts, s).tolist() == want.tolist()


def test_a_turn_is_the_streams_half_window():
    """The paced loop's turn, the stream's half-window and the pipeline's
    DVFS half-window are one length: a turn feeds each lane one
    half-window's count, which the rate estimator reads."""
    mix = json.loads((REPO / "perfbench" / "traffic" / "burst.json")
                     .read_text())
    assert (mix["turn_us"] == CONFIG["stream"]["half_us"]
            == CONFIG["pipeline"]["dvfs_tw_us"] // 2)


def burst_root(tmp: Path) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``perfbench/`` with the config
    ``tinyramp`` (``davis240_x16_adaptive`` at three lanes and
    ``TINY_STREAM``'s cycle, DVFS headroom 20), the mix ``tinyburst``
    (``burst`` with no settle seconds: the settle ends once every lane has
    sat in every bucket) and the cell ``tinyramp.tinyburst``, added as
    files and manifest entries."""
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    bench_dir = root / "perfbench"
    cfg = json.loads(json.dumps(CONFIG))
    cfg.update(name="tinyramp", cameras=3)
    cfg["pipeline"]["dvfs_headroom"] = 20.0
    cfg["stream"].update(TINY_STREAM)
    (bench_dir / "configs" / "tinyramp.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "burst.json").read_text())
    mix.update(settle_seconds=0.0, trace_turns=4)
    (bench_dir / "traffic" / "tinyburst.json").write_text(json.dumps(mix))
    entry = next(c for c in man["configs"]
                 if c["name"] == "davis240_x16_adaptive")
    man["configs"].append(dict(entry, name="tinyramp",
                               file="perfbench/configs/tinyramp.json"))
    man["workloads"].append({"name": "tinyramp.tinyburst",
                             "config": "tinyramp", "traffic": "tinyburst",
                             "chips": 1, "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].append("tinyramp.tinyburst")
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The throwaway checkout and one sound CPU run of its cell (two
    intra-op threads: the pool's tensors are small, and test workers share
    the cores)."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        root = burst_root(tmp_path_factory.mktemp("pbburst"))
        yield root, bench.run("tinyramp.tinyburst", SEED, 0.5, False,
                              device="cpu", root=root)
    finally:
        torch.set_num_threads(n)


def test_burst_run_correct(tiny):
    _, res = tiny
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"events_per_s", "setup_s"}
    for rows in res["schedules"]:
        assert {b for b, _, _ in rows} == {128, 512, 2048}, rows
    assert len(res["vdd_chunks"]) >= 2 and "0.60" in res["vdd_chunks"]
    # every lane was flushed: its last chunk is partial
    assert all(rows[-1][1] < rows[-1][0] for rows in res["schedules"])
    assert res["loop"]["turns"] >= 1 and res["attempted"] == (
        3 * res["loop"]["turns"])


def test_a_move_logged_a_chunk_off_fails(tiny, monkeypatch):
    from repro_torch.serve.runtime import PoolRuntime
    root, _ = tiny
    monkeypatch.setattr(PoolRuntime, "_apply_staged_locked",
                        _log_one_chunk_off(PoolRuntime._apply_staged_locked))
    res = bench.run("tinyramp.tinyburst", SEED, 0.2, False, device="cpu",
                    root=root)
    assert res["correct"] is False, res["checks"]


# -- the readers ----------------------------------------------------------

ROUNDS = 50
SNAP = {
    "pool.migrate": dict(count=12, seconds=0.006, self_seconds=0.001,
                         device_seconds=None),
    "pool.observe": dict(count=80, seconds=0.009, self_seconds=0.004,
                         device_seconds=None),
    "step.lanes_stepped": dict(count=ROUNDS, total=16 * ROUNDS),
    "step.lanes_active": dict(count=ROUNDS, total=200),
}
WANT = {"migrate_ms_per_round.burst": 0.12,
        "observe_self_ms_per_round.burst": 0.08,
        "active_lane_share.burst": 25.0}


def _rec(rounds=ROUNDS):
    return {"window": {"rounds": 100, "wall_s": 2.0, "spans": {},
                       "stats": {}},
            "profile": {"wall_s": 0.9, "rounds": rounds, "busy_s": 0.05,
                        "records": 1000, "by_name": {}},
            "rooflines": {}}


@pytest.fixture
def snap(monkeypatch):
    rows = {k: dict(v) for k, v in SNAP.items()}
    monkeypatch.setattr(obs.spans, "snapshot", lambda: rows)
    return rows


def test_readers_are_the_cells_manifest_entries():
    per_layer = {m["name"]: m for m in manifest.manifest()["per_layer"]}
    for name, (source, layer, unit) in READERS.items():
        m = per_layer[name]
        assert (m["source"], m["layer"], m["unit"]) == (source, layer, unit)
        assert m["workloads"] == [CELL] and m["moves"] == "events_per_s"
    cell = manifest.cell(CELL)
    assert [m["name"] for m in cell["end_to_end"]] == ["events_per_s",
                                                       "setup_s"]
    assert set(READERS) | set(TWINS) == {m["name"]
                                         for m in cell["per_layer"]}


@pytest.mark.parametrize("name", sorted(TWINS))
def test_twins_are_the_sat_cells_entries(name):
    per_layer = {m["name"]: m for m in manifest.manifest()["per_layer"]}
    twin, sat = dict(per_layer[name]), dict(per_layer[TWINS[name]])
    assert twin.pop("workloads") == [CELL]
    assert sat.pop("workloads") == ["hd720_x4_dvfs.sat"]
    assert twin.pop("name") == name and sat.pop("name") == TWINS[name]
    assert twin == sat


def _full_rec():
    """A traced record with every part a reader reads: spans, the
    profile, the window's counters and the kernels' rooflines."""
    rec = _rec()
    rec["window"].update(events=123_456, stats={"d2h_bytes": 7_654_321,
                                                "pump_drain_wait_s": 0.1})
    rec["rooflines"] = {
        k: {"bound_s": b, "bound": "bytes", "calls": 40, "kernel_s": s,
            "kernel_calls": 38}
        for k, b, s in (("k1", 1e-4, 4e-3), ("k2", 2e-4, 1e-3),
                        ("k3", 1e-6, 3e-4))}
    return rec


@pytest.mark.parametrize("name", sorted(TWINS))
@pytest.mark.parametrize("part", ["whole", "no profile", "no rooflines"])
def test_twins_read_what_the_sat_readers_read(name, part, snap):
    snap.update({
        "pool.step": dict(count=ROUNDS, seconds=0.2, self_seconds=0.15,
                          device_seconds=None),
        "pool.push": dict(count=ROUNDS, seconds=0.03, self_seconds=0.03,
                          device_seconds=None),
        "step.draw": dict(count=ROUNDS, seconds=0.01, self_seconds=0.01,
                          device_seconds=0.004),
        "pool.stage": dict(count=9, seconds=0.02, self_seconds=0.02,
                           device_seconds=None),
        "pool.pump": dict(count=9, seconds=0.4, self_seconds=0.005,
                          device_seconds=None)})
    rec = _full_rec()
    if part == "no profile":
        rec["profile"] = None
    elif part == "no rooflines":
        rec["rooflines"] = {}
    got = manifest.metric_reader(name).read(rec)
    assert got == manifest.metric_reader(TWINS[name]).read(rec)
    if part == "whole":
        assert got is not None and got > 0


@pytest.mark.parametrize("name", sorted(READERS))
def test_reads_per_traced_round(name, snap):
    got = manifest.metric_reader(name).read(_rec())
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_without_a_profiled_stretch(name, snap):
    rec = _rec()
    rec["profile"] = None
    assert manifest.metric_reader(name).read(rec) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_against_the_parents_program(name, snap):
    """The parent's snapshot has the pump's spans and no move, observation
    or counter."""
    for k in list(snap):
        del snap[k]
    snap["pool.pump"] = dict(count=2, seconds=0.9, self_seconds=0.01,
                             device_seconds=None)
    assert manifest.metric_reader(name).read(_rec()) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_none_against_a_program_without_spans(name, monkeypatch):
    monkeypatch.delattr(obs, "spans")
    assert manifest.metric_reader(name).read(_rec()) is None


def test_readers_on_a_profiled_adaptive_pool():
    """The names the readers read are the ones the program records: an
    adaptive pool of two lanes on the CPU, one lane's rate falling under
    its bucket, served under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import pipeline
    from repro_torch.serve import DetectorPool

    cfg = pipeline.PipelineConfig(height=64, width=96, chunk=128,
                                  inject_ber=True, vdd=0.6, backend="fused",
                                  device="cpu")
    rng = np.random.default_rng(5)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.spans.reset()
    pool = DetectorPool(cfg, 2, ring_rounds=4, drain_mode="async",
                        policy="adaptive", buckets=(64, 128),
                        migrate_patience=1)
    try:
        lanes = [pool.connect(seed=5 + i) for i in range(2)]
        with profile(activities=[ProfilerActivity.CPU]):
            for t in range(6):
                for i, ln in enumerate(lanes):
                    k = 256 if i == 0 else 16
                    ts = np.sort(rng.integers(t * 5000, (t + 1) * 5000, k))
                    xy = np.stack([rng.integers(0, 96, k),
                                   rng.integers(0, 64, k)], 1)
                    pool.feed(ln, xy, ts)
                pool.pump()
                for ln in lanes:
                    pool.poll(ln)
            for ln in lanes:
                pool.flush(ln)
            rounds = pool.pool_stats()["rounds_executed"]
        moved = pool.stats(lanes[1])["migrations"]
    finally:
        pool.close()
        torch.set_num_threads(n)
    assert moved >= 1
    snap = obs.spans.snapshot()
    try:
        got = {name: manifest.metric_reader(name).read(_rec(rounds))
               for name in READERS}
    finally:
        obs.spans.reset()
    assert got["migrate_ms_per_round.burst"] == pytest.approx(
        snap["pool.migrate"]["seconds"] / rounds * 1e3, rel=1e-12)
    assert got["observe_self_ms_per_round.burst"] == pytest.approx(
        snap["pool.observe"]["self_seconds"] / rounds * 1e3, rel=1e-12)
    assert got["active_lane_share.burst"] == pytest.approx(
        100.0 * snap["step.lanes_active"]["total"]
        / snap["step.lanes_stepped"]["total"], rel=1e-12)
    assert all(v > 0 for v in got.values()), got
    assert got["active_lane_share.burst"] < 100.0
