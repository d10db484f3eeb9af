"""The port's paper benches (``repro_torch.benchmarks.bench_hwmodel``,
``bench_throughput``, ``bench_dvfs``, ``bench_auc``) against the
reference's rows, on the CPU: ``rows(smoke=True, device="cpu")`` has the
row names of the reference's modules in
``benchmarks/BENCH_smoke_baseline.json`` (27 + 14 + 23 + 10), the model
rows (hwmodel, dvfs, ``fig1b_*``) equal to the baseline's, the pipeline
rows' host syncs 16 / 1, and the Fig. 11 AUC rows within 1e-3 of the
reference.

The baseline's BER rows of Fig. 11 were drawn by the reference under
``jax_threefry_partitionable=False``; the installed jax draws
partitionably, as the port does, so those rows are held to a live run of
the reference's ``bench_auc`` instead (and to
``tests/data/fig11_reference.json``, which ``chip_smoke.py`` holds the
card's full-size rows to); the error-free rows are held to the baseline
too.  The port's runner prints the modules in the reference's order."""
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
from benchmarks import bench_auc as j_auc  # noqa: E402
from repro_torch.benchmarks import bench_auc  # noqa: E402
from repro_torch.benchmarks import bench_dvfs  # noqa: E402
from repro_torch.benchmarks import bench_hwmodel  # noqa: E402
from repro_torch.benchmarks import bench_throughput  # noqa: E402
from repro_torch.benchmarks import run as t_run  # noqa: E402

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MODULES = {"hwmodel(fig9,fig10)": (bench_hwmodel, 27),
           "throughput(fig1b,fig10d)": (bench_throughput, 14),
           "dvfs(tableI,fig8)": (bench_dvfs, 23),
           "auc(fig11)": (bench_auc, 10)}
AUC_TOL = 1e-3
FIG11 = json.loads((ROOT / "tests" / "data" / "fig11_reference.json")
                   .read_text())


def _baseline(module):
    rows = json.loads((ROOT / "benchmarks" / "BENCH_smoke_baseline.json")
                      .read_text())["rows"]
    return {k: v["derived"] for k, v in rows.items()
            if v["module"] == module}


@pytest.fixture(scope="module")
def port_rows():
    return {label: mod.rows(smoke=True, device="cpu")
            for label, (mod, _) in MODULES.items()}


@pytest.fixture(scope="module")
def live_fig11():
    """The reference's ``bench_auc`` smoke rows under the installed jax."""
    return {n: v for n, _, v in j_auc.rows(smoke=True)}


@pytest.mark.parametrize("label", list(MODULES))
def test_row_names_match_baseline(port_rows, label):
    names = [n for n, _, _ in port_rows[label]]
    assert len(names) == len(set(names)) == MODULES[label][1]
    assert set(names) == set(_baseline(label))


@pytest.mark.parametrize("label", ["hwmodel(fig9,fig10)",
                                   "dvfs(tableI,fig8)"])
def test_model_rows_equal_baseline(port_rows, label):
    base = _baseline(label)
    for name, us, value in port_rows[label]:
        assert us == 0.0
        assert value == base[name], name


def test_throughput_rows(port_rows):
    base = _baseline("throughput(fig1b,fig10d)")
    rows = {n: (us, v) for n, us, v in port_rows["throughput(fig1b,fig10d)"]}
    for name in base:
        if name.startswith("fig1b_"):
            assert rows[name] == (0.0, base[name]), name
    assert rows["pipeline_ref_host_syncs"][1] == 16.0 == \
        base["pipeline_ref_host_syncs"]
    assert rows["pipeline_scan_host_syncs"][1] == 1.0 == \
        base["pipeline_scan_host_syncs"]
    for name in ("sw_seq_us_per_kevent", "sw_batched_us_per_kevent",
                 "sw_onehot_us_per_kevent", "pipeline_ref_us_per_event",
                 "pipeline_scan_us_per_event"):
        us, value = rows[name]
        assert us > 0 and np.isfinite(value) and value > 0, name


def test_auc_rows_match_reference(port_rows, live_fig11):
    base = _baseline("auc(fig11)")
    rows = {n: v for n, _, v in port_rows["auc(fig11)"]}
    for name, want in live_fig11.items():
        tol = 2 * AUC_TOL if "_delta_" in name else AUC_TOL
        assert abs(rows[name] - want) <= tol, name
        if "errorfree" in name:
            assert abs(rows[name] - base[name]) <= AUC_TOL, name


def test_fig11_reference_file_is_the_live_reference(live_fig11):
    assert FIG11["smoke"] == live_fig11
    assert FIG11["full"].keys() == live_fig11.keys()
    full = _baseline_full()
    for name, value in FIG11["full"].items():
        if "errorfree" in name:
            assert value == full[name], name


def _baseline_full():
    rows = json.loads((ROOT / "benchmarks" / "BENCH_serving.json")
                      .read_text())["rows"]
    return {k: v["derived"] for k, v in rows.items()
            if v["module"] == "auc(fig11)"}


def _reference_labels():
    """The module labels of the reference's runner, in its order."""
    src = (ROOT / "benchmarks" / "run.py").read_text()
    return re.findall(r'\("(\w+\([\w,]+\))", \w+\)', src)


def test_runner_order_is_the_references():
    ref = _reference_labels()
    ours = [label for label, _ in t_run.MODULES]
    assert ours == [label for label in ref if label in ours]
    assert ours[:4] == list(MODULES)
    assert ours[4:] == ["tos_kernels(perf)", "streaming(serving)",
                        "scenarios(slo)"]


def test_runner_prints_the_paper_modules(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(t_run, "MODULES", tuple(
        (label, mod) for label, mod in t_run.MODULES
        if label in ("hwmodel(fig9,fig10)", "dvfs(tableI,fig8)")))
    monkeypatch.chdir(tmp_path)
    t_run.main(["--smoke", "--device", "cpu"])
    captured = capsys.readouterr()
    assert list(tmp_path.iterdir()) == []        # no JSON by default
    lines = captured.out.splitlines()
    assert lines[0] == "name,us_per_call,derived"
    assert len(lines) == 1 + 27 + 23
    assert lines[1].startswith("fig9a_latency_ns@0.6V,")
    assert lines[-1].startswith("fig8_capacity_at_1.2V_meps,")
    done = re.findall(r"# (\S+) done", captured.err)
    assert done == ["hwmodel(fig9,fig10)", "dvfs(tableI,fig8)"]
    path = tmp_path / "rows.json"
    t_run.main(["--smoke", "--device", "cpu", "--json-out", str(path)])
    got = json.loads(path.read_text())
    assert len(got["rows"]) == 50 and got["errors"] == []


def test_benches_refuse_cuda_without_it():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for mod, _ in MODULES.values():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mod.rows(smoke=True)
