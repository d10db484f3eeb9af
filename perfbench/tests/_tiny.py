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
    (bench / "cells").mkdir(exist_ok=True)
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


# A test-only stream generator and loop for a pool that moves its lanes
# between chunk buckets, written into a throwaway checkout.
STEPS_GENERATOR = '''"""``steps`` (test only): the ``shapes`` stream
thinned so that its rate steps between ``high_per_us`` and ``low_per_us``
events/us every ``step_us``, starting high."""
import importlib.util
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "pb_steps_shapes", Path(__file__).with_name("shapes.py"))
shapes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(shapes)


def generate(*, height, width, seed, duration_us, n_shapes, high_per_us,
             low_per_us, step_us):
    xy, ts = shapes.generate(
        height=height, width=width, seed=seed, duration_us=duration_us,
        n_shapes=n_shapes, signal_rate_per_us=0.9 * high_per_us,
        noise_rate_per_us=0.1 * high_per_us)
    high = (ts // step_us) % 2 == 0
    keep = high | (np.random.default_rng(seed + 1).random(len(ts))
                   < low_per_us / high_per_us)
    return xy[keep], ts[keep]
'''

PACED_LOOP = '''"""``paced`` (test only): each turn feeds every lane
the events of its next ``turn_us`` of camera time, pumps and polls every
lane; a window is
``max_turns`` turns, whatever the clock says, so a seed gives the same
run on any host.  The window ends by flushing every lane, so partial
chunks are folded."""
import time

import numpy as np


def _upto(ln, t):
    r = ln.replay
    passes, rem = divmod(t, r.duration)
    return passes * r.n + int(np.searchsorted(r.ts, rem, "left"))


def _turns(drv, mix, state, n):
    for _ in range(n):
        state["t"] += int(mix["turn_us"])
        drv.turn([max(0, _upto(ln, state["t"]) - ln.fed)
                  for ln in drv.lanes])
        state["turns"] += 1


def settle(drv, mix, cell):
    return {"t": 0, "turns": 0}


def window(drv, mix, state, seconds):
    t0 = time.perf_counter()
    _turns(drv, mix, state, int(mix["max_turns"]))
    return {"wall_s": time.perf_counter() - t0, "turns": state["turns"]}


def finish(drv, mix, state, win):
    for ln in drv.lanes:
        drv.flush(ln)


def traced(drv, mix, state, win):
    _turns(drv, mix, state, int(mix["trace_turns"]))
    finish(drv, mix, state, win)


def report(drv, mix, state, win, cell):
    return {"attempted": win["turns"] * len(drv.lanes), "failed": 0,
            "values": {}, "log": f"[paced] {win['turns']} turns",
            "keep": {"turns": win["turns"]}}
'''


def adaptive_config(cameras: int = 2) -> dict:
    """The DAVIS240 config served by an adaptive pool with buckets 128,
    512 and 2048 (connecting at 512), its cameras' rates stepping between
    0.4 and 0.01 events/us every 30 ms: 2,000 and 50 events a DVFS
    half-window, above the 512 bucket and below 0.9 of the 128 one."""
    cfg = davis_config(cameras)
    cfg.update(name="tinyad")
    cfg["pool"] = {**cfg["pool"], "policy": "adaptive",
                   "buckets": [128, 512, 2048]}
    cfg["stream"] = {"generator": "steps", "duration_us": 120_000,
                     "n_shapes": 3, "high_per_us": 0.4, "low_per_us": 0.01,
                     "step_us": 30_000}
    return cfg


def adaptive_root(tmp: Path, *, lanes: int = 2, max_turns: int = 24) -> Path:
    """``tiny_root`` plus the generator ``steps``, the loop ``paced`` (5 ms
    of camera time a turn, one DVFS half-window), the config ``tinyad``
    (``adaptive_config``) and the cell ``tinyad.tinypaced``."""
    root = tiny_root(tmp, lanes=lanes)
    bench = root / "perfbench"
    (bench / "generators" / "steps.py").write_text(STEPS_GENERATOR)
    (bench / "loops" / "paced.py").write_text(PACED_LOOP)
    (bench / "configs" / "tinyad.json").write_text(
        json.dumps(adaptive_config(lanes)))
    (bench / "traffic" / "tinypaced.json").write_text(json.dumps(
        {"loop": "paced", "turn_us": 5_000, "max_turns": max_turns,
         "warmup_chunks": [], "trace_turns": 2}))
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append(dict(man["configs"][0], name="tinyad",
                               file="perfbench/configs/tinyad.json"))
    man["workloads"].append({"name": "tinyad.tinypaced", "config": "tinyad",
                             "traffic": "tinypaced", "chips": 1,
                             "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "workloads" in m and "tiny.tinysat" in m["workloads"]:
            m["workloads"].append("tinyad.tinypaced")
    (root / "BENCHMARK.json").write_text(json.dumps(man, indent=1))
    return root
