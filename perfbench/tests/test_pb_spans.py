"""The readers of the program's spans (``metrics/_spans.py`` and the four
metric files that use it): the right number from a record and a snapshot,
and ``None``, never an exception, without a profiled stretch, for a span
that never ran, or against a program without ``repro_torch.obs.spans``
(the parent of the change that added them)."""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench.lib import manifest  # noqa: E402
from repro_torch import obs  # noqa: E402

ROUNDS = 40
# metric -> (span names, field) it reads
READS = {
    "stage_ms_per_round.sat": (("pool.stage",), "seconds"),
    "pump_self_ms_per_round.sat": (("pool.pump",), "self_seconds"),
    "issue_ms_per_round.sat": (("pool.step", "pool.push"), "seconds"),
    "draw_device_ms_per_round.sat": (("step.draw",), "device_seconds"),
}
SNAP = {
    "pool.pump": dict(count=2, seconds=0.9, self_seconds=0.012,
                      device_seconds=None),
    "pool.stage": dict(count=5, seconds=0.031, self_seconds=0.031,
                       device_seconds=None),
    "pool.step": dict(count=ROUNDS, seconds=0.82, self_seconds=0.02,
                      device_seconds=None),
    "pool.push": dict(count=ROUNDS, seconds=0.004, self_seconds=0.004,
                      device_seconds=None),
    "step.draw": dict(count=ROUNDS, seconds=0.8, self_seconds=0.8,
                      device_seconds=0.808),
}
WANT = {"stage_ms_per_round.sat": 0.775, "pump_self_ms_per_round.sat": 0.3,
        "issue_ms_per_round.sat": 20.6, "draw_device_ms_per_round.sat": 20.2}


def _rec(rounds=ROUNDS):
    return {"window": {"rounds": 100, "wall_s": 2.0, "spans": {},
                       "stats": {}},
            "profile": {"wall_s": 0.9, "rounds": rounds, "busy_s": 0.85,
                        "records": 1000, "by_name": {}},
            "rooflines": {}}


@pytest.fixture
def snap(monkeypatch):
    rows = {k: dict(v) for k, v in SNAP.items()}
    monkeypatch.setattr(obs.spans, "snapshot", lambda: rows)
    return rows


def test_every_reader_is_a_manifest_entry():
    per_layer = {m["name"]: m for m in manifest.manifest()["per_layer"]}
    for name in READS:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        assert m["workloads"] == [
            "hd720_x4_dvfs." + name.rsplit(".", 1)[1]]


@pytest.mark.parametrize("name", sorted(READS))
def test_reads_its_spans_per_traced_round(name, snap):
    got = manifest.metric_reader(name).read(_rec())
    assert got == pytest.approx(WANT[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(READS))
def test_none_without_a_profiled_stretch(name, snap):
    rec = _rec()
    rec["profile"] = None
    assert manifest.metric_reader(name).read(rec) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_none_for_a_span_that_never_ran(name, snap):
    spans, field = READS[name]
    del snap[spans[-1]]
    reader = manifest.metric_reader(name)
    assert reader.read(_rec()) is None
    snap[spans[-1]] = dict(count=0, seconds=0.0, self_seconds=0.0,
                           device_seconds=None)
    assert reader.read(_rec()) is None


@pytest.mark.parametrize("name", sorted(READS))
def test_none_against_a_program_without_spans(name, monkeypatch):
    monkeypatch.delattr(obs, "spans")
    assert manifest.metric_reader(name).read(_rec()) is None


def test_draw_reader_needs_device_seconds(snap):
    snap["step.draw"]["device_seconds"] = None
    reader = manifest.metric_reader("draw_device_ms_per_round.sat")
    assert reader.read(_rec()) is None


def test_readers_on_a_profiled_pool():
    """The names the readers read are the ones the program records: a
    small async pool served under the profiler on the CPU."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import pipeline
    from repro_torch.events import synthetic
    from repro_torch.serve import DetectorPool

    cfg = pipeline.PipelineConfig(height=64, width=96, chunk=128,
                                  inject_ber=True, vdd=0.6, backend="fused",
                                  device="cpu")
    st = synthetic.shapes_stream(height=64, width=96, duration_us=20_000,
                                 n_shapes=2, seed=3)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.spans.reset()
    pool = DetectorPool(cfg, 1, ring_rounds=4, drain_mode="async")
    try:
        lane = pool.connect(seed=5)
        with profile(activities=[ProfilerActivity.CPU]):
            pool.feed(lane, st.xy[:6 * 128], st.ts[:6 * 128])
            rounds = pool.pump()
            scores, _ = pool.poll(lane)
    finally:
        pool.close()
        torch.set_num_threads(n)
    assert rounds == 6 and scores.size == 6 * 128
    assert np.isfinite(scores).any()
    snap = obs.spans.snapshot()
    rec = _rec(rounds)
    try:
        got = {name: manifest.metric_reader(name).read(rec)
               for name in READS}
    finally:
        obs.spans.reset()
    for name, (spans, field) in READS.items():
        if field == "device_seconds":      # no CUDA events on the CPU
            assert got[name] is None
            continue
        want = sum(snap[s][field] for s in spans) / rounds * 1e3
        assert got[name] == pytest.approx(want, rel=1e-12), name
        assert got[name] > 0, name
