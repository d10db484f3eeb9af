"""Find a cell's parts by name.

``BENCHMARK.json`` at the checkout's root names the cells; a cell
``<config>.<mix>`` reads ``perfbench/configs/<config>.json``,
``perfbench/traffic/<mix>.json`` and, where present,
``perfbench/cells/<cell>.json`` (numbers that belong to that pair alone,
such as a live mix's offered rate).  A mix's data file names its loop,
the module ``perfbench/loops/<loop>.py``, and a config's stream names its
generator, the module ``perfbench/generators/<generator>.py``.  A per-layer
metric is the module ``perfbench/metrics/<metric>.py`` and a kernel's work
count the module ``perfbench/rooflines/<kernel>.py``.  Adding any of them
is adding files.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> dict:
    """The cell's manifest entry with its config, mix and cell data, and
    the metrics it reports in each mode."""
    man = manifest(root)
    work = {w["name"]: w for w in man["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have: {sorted(work)})")
    w = work[name]
    bench = root / "perfbench"
    extra = bench / "cells" / f"{name}.json"

    def reports(metric):
        return "workloads" not in metric or name in metric["workloads"]

    return {
        "workload": w,
        "config": load_json(bench / "configs" / f"{w['config']}.json"),
        "mix": load_json(bench / "traffic" / f"{w['traffic']}.json"),
        "cell": load_json(extra) if extra.exists() else {},
        "end_to_end": [m for m in man["end_to_end"] if reports(m)],
        "per_layer": [m for m in man["per_layer"] if reports(m)],
        "run_seconds": man["run_seconds"],
    }


def _module(path: Path, prefix: str):
    if not path.exists():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(name: str, root: Path = ROOT):
    """``perfbench/loops/<name>.py``: the loop that drives a mix's traffic."""
    return _module(root / "perfbench" / "loops" / f"{name}.py", "pb_loop")


def generator(name: str, root: Path = ROOT):
    """``perfbench/generators/<name>.py``: its ``generate(height=, width=,
    seed=, **params)`` returns one stream ``(xy, ts)``."""
    return _module(root / "perfbench" / "generators" / f"{name}.py",
                   "pb_generator")


def metric_reader(name: str, root: Path = ROOT):
    """``perfbench/metrics/<name>.py``: its ``read(record)`` returns the
    value or ``None`` where the record holds nothing to read."""
    return _module(root / "perfbench" / "metrics" / f"{name}.py",
                   "pb_metric")


def rooflines(root: Path = ROOT) -> dict:
    """Every kernel's work count in ``perfbench/rooflines/``, by name."""
    return {p.stem: _module(p, "pb_roofline")
            for p in sorted((root / "perfbench" / "rooflines").glob("*.py"))
            if not p.stem.startswith("_")}
