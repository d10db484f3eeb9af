"""The port runner's regression gate (``repro_torch.benchmarks.run.
check_regression``, ``--check-regression`` / ``--tol`` / ``--tol-time``)
against the reference's (``benchmarks/run.py``), on the CPU.

Bounds: the gate tables equal the reference's; on every case below the
port's gate counts the same regressions as the reference's (fail closed on
a missing, a skipped or no gated row; direction and tolerances; wall-time
rows only at equal ``smoke`` flags); ``main`` exits non-zero on a
regression and returns on a pass; every gated row of
``benchmarks/BENCH_smoke_baseline.json`` comes from a module of the port's
runner."""
import json
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
ROOT = Path(__file__).resolve().parents[1]
# benchmarks/ is a top-level package at the repository's root
sys.path.insert(0, str(ROOT))

from benchmarks import run as j_run  # noqa: E402
from repro_torch.benchmarks import bench_tos_kernels  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402

BASELINE = ROOT / "benchmarks" / "BENCH_smoke_baseline.json"


def _row(v, skipped=False):
    rec = {"derived": v, "us_per_call": 0.0, "module": "m"}
    if skipped:
        rec["skipped"] = True
    return rec


BASE = {
    "a_burst_rounds_per_fetch": _row(6.0),    # higher is better
    "b_fetches_per_round": _row(0.5),         # lower is better
    "c_slab_p99_ms": _row(10.0),              # wall time
    "d_fused_roundtrips_per_chunk": _row(1.0),
    "e_overload_p99_ladder_ms": _row(20.0),
    "f_d2h_bytes_ratio": _row(0.0),           # a zero baseline gates nothing
    "g_slo_pack_moves": _row(4.0, skipped=True),
    "unrelated_row": _row(1.0),               # never gated
}
OK = {k: dict(v) for k, v in BASE.items()}
OK["c_slab_p99_ms"] = _row(11.0)
OK["unrelated_row"] = _row(99.0)

# (id, this run's rows, baseline rows, baseline's smoke flag, regressions)
CASES = [
    ("pass", OK, BASE, True, 0),
    ("rounds_per_fetch_collapsed",
     dict(OK, a_burst_rounds_per_fetch=_row(1.0)), BASE, True, 1),
    ("higher_within_tol", dict(OK, a_burst_rounds_per_fetch=_row(4.0)),
     BASE, True, 0),
    ("fetches_per_round_ballooned", dict(OK, b_fetches_per_round=_row(1.0)),
     BASE, True, 1),
    ("lower_within_tol", dict(OK, b_fetches_per_round=_row(0.67)), BASE,
     True, 0),
    ("fused_step_split", dict(OK, d_fused_roundtrips_per_chunk=_row(2.0)),
     BASE, True, 1),
    ("wall_time_blowup", dict(OK, c_slab_p99_ms=_row(100.0)), BASE, True, 1),
    ("wall_time_within_4x", dict(OK, c_slab_p99_ms=_row(39.0)), BASE, True,
     0),
    ("wall_time_skipped_at_other_size", dict(OK, c_slab_p99_ms=_row(100.0)),
     BASE, False, 0),
    ("missing_gated_row",
     {k: v for k, v in OK.items() if k != "a_burst_rounds_per_fetch"},
     BASE, True, 1),
    ("skipped_gated_row",
     dict(OK, b_fetches_per_round=_row(0.5, skipped=True)), BASE, True, 1),
    ("nothing_gated", OK, {"unrelated_row": _row(1.0)}, True, 1),
    ("two_regressions", dict(OK, a_burst_rounds_per_fetch=_row(1.0),
                             e_overload_p99_ladder_ms=_row(90.0)),
     BASE, True, 2),
]


def _write(tmp_path, rows, smoke):
    p = tmp_path / "base.json"
    p.write_text(json.dumps({"smoke": smoke, "rows": rows}))
    return str(p)


def test_gate_tables_equal_the_references():
    assert t_run._GATE_STRUCTURAL == j_run._GATE_STRUCTURAL
    assert t_run._GATE_TIME == j_run._GATE_TIME


@pytest.mark.parametrize("records,base,smoke,want",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_gate_counts_as_the_references(tmp_path, records, base, smoke,
                                       want):
    path = _write(tmp_path, base, smoke)
    kw = dict(smoke=True, tol=0.35, tol_time=3.0)
    assert t_run.check_regression(records, path, **kw) == want
    assert j_run.check_regression(records, path, **kw) == want


def test_tolerances_are_the_callers(tmp_path):
    path = _write(tmp_path, BASE, True)
    loose = dict(OK, a_burst_rounds_per_fetch=_row(1.0),
                 c_slab_p99_ms=_row(100.0))
    assert t_run.check_regression(loose, path, smoke=True, tol=0.9,
                                  tol_time=10.0) == 0
    assert t_run.check_regression(OK, path, smoke=True, tol=0.0,
                                  tol_time=0.0) == 1     # 11 ms > 10 ms


def _main_on(tmp_path, monkeypatch, roundtrips):
    """``main`` with only the TOS-kernel module, gated against a baseline
    whose fused round-trip row is ``roundtrips``."""
    monkeypatch.setattr(t_run, "MODULES",
                        (("tos_kernels(perf)", bench_tos_kernels),))
    path = _write(tmp_path, {
        "fusedstep_180x240_E256_fused_roundtrips_per_chunk":
            _row(roundtrips)}, True)
    t_run.main(["--smoke", "--device", "cpu", "--check-regression", path])


def test_main_passes_the_gate(tmp_path, monkeypatch, capsys):
    _main_on(tmp_path, monkeypatch, 1.0)
    assert "1 row(s) checked" in capsys.readouterr().err


def test_main_exits_nonzero_on_a_regression(tmp_path, monkeypatch, capsys):
    with pytest.raises(SystemExit) as exc:
        _main_on(tmp_path, monkeypatch, 0.5)
    assert exc.value.code == 1
    assert "REGRESSION fusedstep_180x240_E256_fused_roundtrips_per_chunk" \
        in capsys.readouterr().err


def test_every_gated_baseline_row_has_a_port_module():
    rows = json.loads(BASELINE.read_text())["rows"]
    gates = t_run._GATE_STRUCTURAL + t_run._GATE_TIME
    gated = {rec["module"] for name, rec in rows.items()
             if not rec.get("skipped")
             and any(name.endswith(s) for s, _ in gates)}
    assert gated == {"streaming(serving)", "scenarios(slo)",
                     "tos_kernels(perf)"}
    assert gated <= {label for label, _ in t_run.MODULES}
