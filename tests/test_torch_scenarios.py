"""The port's fleet scenarios (``repro_torch.benchmarks.scenarios``)
against the live reference (``benchmarks/scenarios.py``): ``rows(smoke=
True)`` of both on the CPU.  Every row but the wall-clock ``p99`` ones
equal (counts and ratios of counts); the ``slo`` JSONL records of the same
shape, with equal values apart from the wall clocks (``t_wall`` and the
``p99``)."""
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")
# benchmarks/ is a top-level package at the repository's root
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from _torch_pool_harness import one_torch_thread  # noqa: E402,F401
from benchmarks import scenarios as j_sc  # noqa: E402
from repro_torch.benchmarks import scenarios as t_sc  # noqa: E402
from repro_torch.obs import read_jsonl  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("scenarios")
    want = j_sc.rows(smoke=True, jsonl_out=tmp / "ref.jsonl")
    got = t_sc.rows(smoke=True, jsonl_out=tmp / "port.jsonl", device="cpu")
    return (got, read_jsonl(tmp / "port.jsonl"),
            want, read_jsonl(tmp / "ref.jsonl"))


def test_scenario_tables_match_reference():
    assert t_sc.SCENARIOS == j_sc.SCENARIOS
    assert list(t_sc._FNS) == list(j_sc._FNS)


def test_rows_match_reference(runs):
    got, _, want, _ = runs
    assert [n for n, _, _ in got] == [n for n, _, _ in want]
    assert len(got) == 20
    for (name, us, value), (_, w_us, w_value) in zip(got, want):
        assert us == w_us == 0.0
        if "_p99_" in name:
            assert value > 0
        else:
            assert value == w_value, name


def test_slo_records_match_reference(runs):
    _, got, _, want = runs
    assert len(got) == len(want) == len(t_sc.SCENARIOS)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        assert g["metrics"].keys() == w["metrics"].keys()
        for key in ("kind", "namespace", "scenario"):
            assert g[key] == w[key]
        for name, value in w["metrics"].items():
            if name != "slo_p99_round_ms":
                assert g["metrics"][name] == value, (g["scenario"], name)


def test_low_vdd_kept_rate_is_the_references(runs):
    """The 0.61 V fleet draws BER bits every round; its kept share is
    integer counts, equal to the reference's to the last bit."""
    got = dict((n, v) for n, _, v in runs[0])
    assert got["scenario_low_vdd_slo_kept_rate"] == 0.0013020833333333333
