"""A throwaway copy of the benchmark with a tiny config and mixes added as
files, for runs of the whole harness on the CPU."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]


def davis_config(cameras: int = 2) -> dict:
    """A DAVIS240C-sized config for CPU runs: the HD config's pipeline and
    pool at 240x180, dense readout, with the shapes_6dof analogue's rates
    (3 polygons, 0.25 + 0.02 events/us), at which every chunk runs at
    0.6 V with write errors."""
    cfg = json.loads((REPO / "perfbench" / "configs" / "hd720_x4_dvfs.json")
                     .read_text())
    cfg.update(name="davis240", cameras=cameras,
               sensor={"height": 180, "width": 240})
    cfg["pool"] = {**cfg["pool"], "readout": "dense"}
    cfg["stream"] = {"generator": "shapes", "duration_us": 1_000_000,
                     "n_shapes": 3, "signal_rate_per_us": 0.25,
                     "noise_rate_per_us": 0.02}
    return cfg


def tiny_root(tmp: Path, *, lanes: int = 2, duration_us: int = 60_000,
              rate: float = 40_000.0) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``perfbench/`` with the config
    ``tiny`` (``lanes`` DAVIS240 lanes), the mixes ``tinysat`` and
    ``tinylive`` and the cells ``tiny.tinysat`` and ``tiny.tinylive``
    added as files and manifest entries."""
    root = Path(tmp) / "checkout"
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads((REPO / "BENCHMARK.json").read_text())
    bench = root / "perfbench"
    cfg = davis_config(lanes)
    cfg.update(name="tiny")
    cfg["stream"]["duration_us"] = duration_us
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    sat = json.loads((bench / "traffic" / "sat.json").read_text())
    sat.update(slab_events=1024, warmup_chunks=[2, 2], trace_turns=1,
               settle_seconds=0.3)
    (bench / "traffic" / "tinysat.json").write_text(json.dumps(sat))
    live = json.loads((bench / "traffic" / "live.json").read_text())
    live.update(warmup_chunks=[2, 1], trace_seconds=0.5, settle_seconds=0.5)
    (bench / "traffic" / "tinylive.json").write_text(json.dumps(live))
    (bench / "cells" / "tiny.tinylive.json").write_text(
        json.dumps({"offered_events_per_s": rate}))
    man["configs"].append(dict(man["configs"][0], name="tiny",
                               file="perfbench/configs/tiny.json"))
    for mix in ("tinysat", "tinylive"):
        man["workloads"].append({"name": f"tiny.{mix}", "config": "tiny",
                                 "traffic": mix, "chips": 1, "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m:
            suffix = "live" if any(w.endswith(".live")
                                   for w in m["workloads"]) else "sat"
            m["workloads"].append(f"tiny.tiny{suffix}")
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root
