"""The port's serving bench (``repro_torch.benchmarks.bench_streaming``)
against the reference's rows: ``rows(smoke=True)`` on the CPU has the row
names of the reference's ``streaming(serving)`` rows in
``benchmarks/BENCH_smoke_baseline.json``, and every structural row (fetches
per round, rounds per fetch, D2H bytes, migration, stage overlap, pack and
ladder transitions) equal to the baseline's value.  One live reference
case, the rate ramp at one lane, shows that the baseline is still the
reference's output.  The port's runner (``repro_torch.benchmarks.run``)
prints the reference's CSV and writes its JSON shape, only when asked."""
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[1]
# benchmarks/ is a top-level package at the repository's root
sys.path.insert(0, str(ROOT))

from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from benchmarks import bench_streaming as j_bs  # noqa: E402
from repro.core import pipeline as j_pipeline  # noqa: E402
from repro_torch.benchmarks import bench_streaming as t_bs  # noqa: E402
from repro_torch.core import pipeline as t_pipeline  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STRUCTURAL = re.compile(
    r"(_fetches_per_round|_rounds_per_fetch|_d2h_bytes_\w+"
    r"|_migration_(count|padding_saved_ratio|padding_saved_mb"
    r"|rounds_per_fetch)|_pump_stage_overlap_ratio|_pack_\w+"
    r"|_overload_ladder_transitions)$")
SMOKE_RAMP = [100] * 3 + [512] * 9        # rows(smoke=True)'s ramp


def _baseline():
    rows = json.loads((ROOT / "benchmarks" / "BENCH_smoke_baseline.json")
                      .read_text())["rows"]
    return {k: v for k, v in rows.items()
            if v["module"] == "streaming(serving)"}


@pytest.fixture(scope="module")
def port_rows():
    return t_bs.rows(smoke=True, device="cpu")


def test_sizes_are_the_references():
    for name in ("POOL_SIZES", "DURATION_US", "SLAB", "SEED", "RING_ROUNDS",
                 "DRAIN_WAIT_RING", "FUSED_SIZES"):
        assert getattr(t_bs, name) == getattr(j_bs, name), name


def test_row_names_match_baseline(port_rows):
    base = _baseline()
    names = [n for n, _, _ in port_rows]
    assert len(names) == len(set(names)) == len(base) == 68
    assert set(names) == set(base)
    for name, us, value in port_rows:
        if name.endswith("_skipped"):
            assert (us, value) == (0.0, 0.0)
            assert base[name].get("skipped")


def test_structural_rows_equal_baseline(port_rows):
    base = _baseline()
    got = {n: v for n, _, v in port_rows if STRUCTURAL.search(n)}
    assert len(got) == 32
    for name, value in got.items():
        assert value == base[name]["derived"], name


def test_timed_rows_are_measured(port_rows):
    for name, us, value in port_rows:
        if not (STRUCTURAL.search(name) or name.endswith("_skipped")):
            assert np.isfinite(value) and value > 0, name


def test_live_reference_ramp_is_the_baseline():
    """``_run_ramp`` at one lane, static and adaptive, on the reference
    and on the port: equal counters, and the reference's migration rows
    are the baseline's."""
    j_cfg = j_pipeline.PipelineConfig(chunk=256, lut_every_chunks=2)
    t_cfg = t_pipeline.PipelineConfig(chunk=256, lut_every_chunks=2,
                                      device="cpu")
    out = {}
    for policy in ("static", "adaptive"):
        want = j_bs._run_ramp(j_cfg, 1, policy=policy, rates=SMOKE_RAMP)
        got = t_bs._run_ramp(t_cfg, 1, policy=policy, rates=SMOKE_RAMP)
        assert got == want, policy
        out[policy] = want
    pad_s, pad_a = out["static"][0], out["adaptive"][0]
    _, migs, rounds, fetches = out["adaptive"]
    base = _baseline()
    assert float(migs) == base["pool1_migration_count"]["derived"]
    assert 1.0 - pad_a / max(pad_s, 1) == \
        base["pool1_migration_padding_saved_ratio"]["derived"]
    assert (pad_s - pad_a) / 1e6 == \
        base["pool1_migration_padding_saved_mb"]["derived"]
    assert rounds / max(fetches, 1) == \
        base["pool1_migration_rounds_per_fetch"]["derived"]


class _Rows:
    """A stand-in bench module: two rows, one skipped, or an error."""

    def __init__(self, fail=False):
        self.fail = fail

    def rows(self, smoke=False, *, device="cuda"):
        if self.fail:
            raise RuntimeError("boom")
        return [("a_events_per_s", 1.5, 2.0 if smoke else 3.0),
                ("b_sharded_events_per_s_skipped", 0.0, 0.0)]


def test_runner_writes_the_references_json_shape(tmp_path, capsys,
                                                  monkeypatch):
    from repro_torch.benchmarks import run as t_run
    monkeypatch.setattr(t_run, "MODULES", (("fake(mod)", _Rows()),))
    path = tmp_path / "rows.json"
    t_run.main(["--smoke", "--device", "cpu", "--json-out", str(path)])
    out = capsys.readouterr().out.splitlines()
    assert out == ["name,us_per_call,derived", "a_events_per_s,1.500,2",
                   "b_sharded_events_per_s_skipped,0.000,0"]
    got = json.loads(path.read_text())
    want = json.loads((ROOT / "benchmarks" / "BENCH_smoke_baseline.json")
                      .read_text())
    assert got.keys() == want.keys()
    assert got == {"smoke": True, "errors": [], "rows": {
        "a_events_per_s": {"us_per_call": 1.5, "derived": 2.0,
                           "module": "fake(mod)"},
        "b_sharded_events_per_s_skipped": {
            "us_per_call": 0.0, "derived": 0.0, "module": "fake(mod)",
            "skipped": True}}}
    for name, rec in want["rows"].items():
        assert set(rec) <= {"us_per_call", "derived", "module", "skipped"}


def test_runner_fails_on_a_module_error_and_writes_nothing_by_default(
        tmp_path, capsys, monkeypatch):
    from repro_torch.benchmarks import run as t_run
    monkeypatch.setattr(t_run, "MODULES", (("fake(mod)", _Rows(True)),))
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        t_run.main(["--device", "cpu"])
    assert exc.value.code == 1
    assert "fake(mod)_ERROR" in capsys.readouterr().err
    assert list(tmp_path.iterdir()) == []
