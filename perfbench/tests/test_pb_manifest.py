"""The manifest keeps to the benchmark's contract, and a cell's parts are
found by name: a config, a mix, a loop, a stream generator, a metric and a
kernel count added as files in a copy are read without an edit to any file
already there."""
from __future__ import annotations

import ast
import json
import re
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench.lib import manifest, streams  # noqa: E402
from perfbench.tests import _tiny  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = json.loads((REPO / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["perfbench"]
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_keys(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    for e in MAN[kind]:
        assert set(e) - {"workloads"} == keys, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e and kind != "end_to_end" and kind != "per_layer":
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")


def test_cells_one_chip_and_configs_used():
    cfgs = {c["name"]: c for c in MAN["configs"]}
    used = set()
    pairs = set()
    for w in MAN["workloads"]:
        assert w["chips"] == 1, w["name"]
        assert w["config"] in cfgs
        assert (REPO / "perfbench" / "traffic" / f"{w['traffic']}.json"
                ).exists()
        assert w["name"] == f"{w['config']}.{w['traffic']}"
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
    assert used == set(cfgs)
    assert len(pairs) == len(MAN["workloads"])
    for c in cfgs.values():
        data = json.loads((REPO / c["file"]).read_text())
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert c["file"].startswith("perfbench/")


def test_metrics_and_moves():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = [w["name"] for w in MAN["workloads"]]

    def reports(metric, cell):
        return "workloads" not in metric or cell in metric["workloads"]

    for cell in cells:
        assert reports(e2e["setup_s"], cell)
        assert sum(reports(m, cell) for m in e2e.values()) >= 2
        assert any(reports(m, cell) for m in MAN["per_layer"])
    layers = {}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m.get("workloads", cells):
            assert cell in cells and reports(e2e[m["moves"]], cell), (
                m["name"], cell)
        assert (REPO / "perfbench" / "metrics" / f"{m['name']}.py").exists()
        layers.setdefault(m["layer"], []).append(m["name"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_finds_its_loop_and_generator():
    for w in MAN["workloads"]:
        cell = manifest.cell(w["name"])
        loop = manifest.loop(cell["mix"]["loop"])
        for fn in ("settle", "window", "traced", "finish", "report"):
            assert callable(getattr(loop, fn)), (w["name"], fn)
        gen = manifest.generator(cell["config"]["stream"]["generator"])
        assert callable(gen.generate)


def test_live_cells_have_a_rate():
    for w in MAN["workloads"]:
        mix = json.loads((REPO / "perfbench" / "traffic"
                          / f"{w['traffic']}.json").read_text())
        if mix["loop"] == "open":
            cell = manifest.cell(w["name"])
            assert cell["cell"]["offered_events_per_s"] > 0


def test_parts_added_as_files_are_found(tmp_path):
    root = _tiny.tiny_root(tmp_path)
    before = {p: p.read_bytes() for p in (REPO / "perfbench").rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    (root / "perfbench" / "metrics" / "events_per_round.tinysat.py"
     ).write_text("def read(rec):\n"
                  "    w = rec['window']\n"
                  "    return w['events'] / w['rounds']\n")
    (root / "perfbench" / "rooflines" / "kx.py").write_text(
        "KERNELS = ('kx_kernel',)\nCALL_KERNEL = 'kx_kernel'\n"
        "def bound(rounds):\n    return 1e-6, 'bytes', len(rounds)\n")
    (root / "perfbench" / "loops" / "tinyloop.py").write_text(
        "def settle(drv, mix, cell):\n    return 'settled'\n")
    (root / "perfbench" / "generators" / "tinygen.py").write_text(
        "import numpy as np\n"
        "def generate(*, height, width, duration_us, seed):\n"
        "    ts = np.arange(duration_us, dtype=np.int64)\n"
        "    xy = np.zeros((duration_us, 2), np.int32)\n"
        "    return xy, ts\n")
    assert manifest.loop("tinyloop", root).settle(None, {}, {}) == "settled"
    lanes, keys = streams.lane_streams(
        {"generator": "tinygen", "duration_us": 8}, {"height": 4, "width": 4},
        2, 3, root)
    assert [ln.n for ln in lanes] == [8, 8] and len(keys) == 2
    assert list(lanes[0].take(6, 10)[1]) == [6, 7, 8, 9]
    cell = manifest.cell("tiny.tinysat", root)
    assert cell["config"]["name"] == "tiny"
    assert cell["mix"]["slab_events"] == 1024
    rec = {"window": {"events": 10, "rounds": 5}}
    assert manifest.metric_reader("events_per_round.tinysat",
                                  root).read(rec) == 2
    assert "kx" in manifest.rooflines(root)
    assert manifest.cell("tiny.tinylive", root)["cell"][
        "offered_events_per_s"] > 0
    after = {p: p.read_bytes() for p in (REPO / "perfbench").rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert before == after


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in (REPO / "perfbench").rglob("*.py")))
def test_no_jax_or_jax_package(path):
    mods = _imports(REPO / path)
    assert not mods & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, mods
    if path.startswith("perfbench/reference/"):
        assert "repro_torch" not in mods, mods
