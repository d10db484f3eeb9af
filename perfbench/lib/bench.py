"""One run of one cell: set up the pool and the streams, measure a window,
optionally trace a stretch after it, then check every answer against the
plain reference.

The program under test is ``repro_torch.serve.DetectorPool``; this module
builds its ``PipelineConfig`` from the cell's config, drives it with the
loop that the cell's mix names (``perfbench/loops/<loop>.py``) and keeps
the per-lane outputs for the check.  Spans are the harness's own host
clocks around ``feed``, ``pump`` and ``poll``; counters are the pool's
``pool_stats()``; device numbers come from ``lib.trace``.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np

from perfbench.lib import check, manifest, streams

FOREIGN = ("jax", "jaxlib", "flax", "repro")   # never loaded by a run


def foreign_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (``repro_torch`` is the port: whole top-level names are compared)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FOREIGN)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def pipeline_config(config: dict, device: str):
    from repro_torch.core import dvfs, pipeline
    p = dict(config["pipeline"])
    dv = dvfs.DvfsConfig(tw_us=p.pop("dvfs_tw_us"),
                         counter_bits=p.pop("dvfs_counter_bits"),
                         headroom=p.pop("dvfs_headroom"),
                         vdd_floor=p.pop("dvfs_vdd_floor"))
    return pipeline.PipelineConfig(
        height=config["sensor"]["height"], width=config["sensor"]["width"],
        dvfs_cfg=dv, device=device, **p)


@dataclasses.dataclass
class Lane:
    id: int
    replay: streams.Replay
    key_seed: int
    fed: int = 0
    delivered: int = 0
    scores: list = dataclasses.field(default_factory=list)
    kept: list = dataclasses.field(default_factory=list)


class Rig:
    """The pool, its lanes, and what has happened to them."""

    def __init__(self, pool, lanes, chunk: int):
        self.pool, self.lanes, self.chunk = pool, lanes, chunk
        self.spans: dict = {}
        self.turns = []          # per pump: (first chunk, chunks) per lane
        self.on_delivery = None  # called with (lane, now) after a poll

    @contextmanager
    def span(self, name: str):
        """Host seconds in ``name``, summed, under a profiler range."""
        from torch.profiler import record_function
        t = time.perf_counter()
        with record_function(name):
            yield
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t

    def feed(self, lane: Lane, n: int) -> None:
        xy, ts = lane.replay.take(lane.fed, lane.fed + n)
        self.pool.feed(lane.id, xy, ts)
        lane.fed += n

    def turn(self, counts) -> None:
        """Feed each lane ``counts[i]`` events, pump, poll every lane."""
        start = [ln.fed // self.chunk for ln in self.lanes]
        with self.span("feed"):
            for ln, n in zip(self.lanes, counts):
                if n:
                    self.feed(ln, n)
        with self.span("pump"):
            self.pool.pump()
        self.turns.append([(s, ln.fed // self.chunk - s)
                           for s, ln in zip(start, self.lanes)])
        with self.span("poll"):
            for ln in self.lanes:
                s, k = self.pool.poll(ln.id)
                ln.scores.append(s)
                ln.kept.append(k)
                ln.delivered += len(s)
                if self.on_delivery is not None:
                    self.on_delivery(ln, time.perf_counter())

    def outputs(self):
        return [(np.concatenate(ln.scores) if ln.scores else np.zeros(0),
                 np.concatenate(ln.kept) if ln.kept else np.zeros(0, bool))
                for ln in self.lanes]


def warmup(drv: Rig, mix: dict, loop, cell: dict):
    """Set-up's traffic.  First the shapes the mix will use: each entry of
    ``warmup_chunks`` is one turn feeding every lane that many chunks.  Then
    the loop's own settle period, so the window opens on a pool in its
    steady state.  Returns the loop's state."""
    for n in mix["warmup_chunks"]:
        drv.turn([n * drv.chunk] * len(drv.lanes))
    return loop.settle(drv, mix, cell)


# -- one run ------------------------------------------------------------------

def run(name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", age0: float = 0.0, t_start: float = None,
        root=manifest.ROOT, offered: float = None) -> dict:
    """One run of cell ``name``; returns the result line's object.
    ``age0`` is the process's age at ``t_start`` (a ``perf_counter``
    reading), so ``setup_s`` counts from the process's start.  ``offered``
    replaces an open mix's offered rate (the knee sweep's)."""
    import torch
    from repro_torch.serve import DetectorPool
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("imports", age0 + time.perf_counter() - t_start)]
    spec = manifest.cell(name, root)
    config, mix, extra = spec["config"], spec["mix"], dict(spec["cell"])
    if offered is not None:
        extra["offered_events_per_s"] = offered
    cuda = device.startswith("cuda")
    cfg = pipeline_config(config, device)
    loop = manifest.loop(mix["loop"], root)
    replays, key_seeds = streams.lane_streams(
        config["stream"], config["sensor"], config["cameras"], seed, root)
    marks.append(("streams", age0 + time.perf_counter() - t_start))
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    pool = DetectorPool(cfg, config["cameras"], shard=False, **config["pool"])
    lanes = [Lane(pool.connect(seed=k), r, k)
             for r, k in zip(replays, key_seeds)]
    drv = Rig(pool, lanes, cfg.chunk)
    marks.append(("pool", age0 + time.perf_counter() - t_start))
    try:
        state = warmup(drv, mix, loop, extra)
        if cuda:
            torch.cuda.synchronize()
        setup_s = age0 + time.perf_counter() - t_start
        marks.append(("warm-up", setup_s))
        log("[setup] " + ", ".join(
            f"{k} {b - a:.3f} s" for (_, a), (k, b) in zip(
                [("start", 0.0)] + marks[:-1], marks))
            + f"; setup_s {setup_s:.3f}")
        before = pool.pool_stats()
        drv.spans.clear()
        delivered0 = sum(ln.delivered for ln in lanes)
        win = loop.window(drv, mix, state, seconds)
        spans = dict(drv.spans)
        after = pool.pool_stats()
        win["events"] = sum(ln.delivered for ln in lanes) - delivered0
        win["rounds"] = after["rounds_executed"] - before["rounds_executed"]
        win["spans"] = spans
        win["stats"] = {k: after[k] - before[k] for k in (
            "d2h_bytes", "pump_drain_wait_s")}
        prof = None
        if trace:
            prof = traced_stretch(drv, mix, loop, state, win)
        else:
            loop.finish(drv, mix, state, win)
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        lane_stats = [pool.stats(ln.id) for ln in lanes]
    finally:
        pool.close()
    outs = drv.outputs()
    drv.pool = None
    del pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    rep = loop.report(drv, mix, state, win, extra)
    log(rep["log"])
    result = {"correct": False, "attempted": rep["attempted"],
              "failed": rep["failed"], "metrics": {}}

    if not trace:
        vals = {"setup_s": setup_s,
                "events_per_s": win["events"] / win["wall_s"],
                **rep["values"]}
        for m in spec["end_to_end"]:
            result["metrics"][m["name"]] = {"value": vals[m["name"]],
                                            "unit": m["unit"]}
    else:
        rec = record(spec, cfg, win, prof, lanes, outs, root)
        for m in spec["per_layer"]:
            v = manifest.metric_reader(m["name"], root).read(rec)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v,
                                                "unit": m["unit"]}
    result["device"] = device_info(device, peak, prof)
    if prof is not None:
        result["breakdown"] = {"device_ops": prof["trace"].device_ops(),
                               "idle_gaps": prof["trace"].idle_gaps()}

    t = time.perf_counter()
    checks, vdd = check.check(config, lanes, outs, lane_stats, device=device)
    log(f"[check] reference over {sum(ln.fed for ln in lanes)} events on "
        f"{len(lanes)} lanes in {time.perf_counter() - t:.2f} s; chunks by "
        f"Vdd (V: chunks, the reference's DVFS picks) {vdd}")
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    result["loop"] = rep["keep"]
    result["vdd_chunks"] = vdd
    result["checks"] = checks
    return result


def traced_stretch(drv: Rig, mix: dict, loop, state, win: dict) -> dict:
    """The loop's stretch after the window, under the profiler."""
    from perfbench.lib import trace as trace_mod
    n0 = len(drv.turns)
    rounds0 = drv.pool.pool_stats()["rounds_executed"]

    def stretch():
        t = time.perf_counter()
        loop.traced(drv, mix, state, win)
        return time.perf_counter() - t

    wall, tr = trace_mod.profile(stretch)
    return {"trace": tr, "wall_s": wall,
            "rounds": drv.pool.pool_stats()["rounds_executed"] - rounds0,
            "turns": drv.turns[n0:]}


def record(spec, cfg, win, prof, lanes, outs, root) -> dict:
    """What the per-layer readers read."""
    rec = {"window": win, "profile": None, "rooflines": {}}
    if prof is None or not prof["trace"].device:
        return rec
    tr = prof["trace"]
    names = tr.by_name()
    rec["profile"] = {"wall_s": prof["wall_s"], "rounds": prof["rounds"],
                      "busy_s": tr.busy_s, "records": len(tr.device),
                      "by_name": names}
    rounds = profiled_rounds(spec["config"], cfg, prof["turns"], lanes, outs)
    for kname, mod in manifest.rooflines(root).items():
        bound_s, what, calls = mod.bound(rounds)
        hits = [v for k, v in names.items() if mod.CALL_KERNEL in k]
        k_s = sum(v[1] for k, v in names.items()
                  if any(n in k for n in mod.KERNELS))
        rec["rooflines"][kname] = {
            "bound_s": bound_s, "bound": what, "calls": calls,
            "kernel_s": k_s, "kernel_calls": sum(h[0] for h in hits)}
    return rec


def profiled_rounds(config, cfg, turns, lanes, outs) -> list:
    """Each pool round of the traced stretch, rebuilt from what the turns
    fed: round ``r`` of a pump holds the lanes that were fed more than
    ``r`` chunks."""
    e, h, w = cfg.chunk, cfg.height, cfg.width
    phys = config["cameras"]
    cap = (max(1, e // 8) if config["pool"].get("readout") == "compact"
           else 0)
    rounds = []
    for turn in turns:
        for r in range(max(n for _, n in turn)):
            act = [i for i, (_, n) in enumerate(turn) if n > r]
            xy, keep, due = [], [], 0
            for i in act:
                c = turn[i][0] + r
                xy.append(lanes[i].replay.take(c * e, (c + 1) * e)[0])
                keep.append(outs[i][1][c * e:(c + 1) * e])
                due += (c + 1) % cfg.lut_every_chunks == 0
            rounds.append(SimpleNamespace(
                xy=np.stack(xy), keep=np.stack(keep),
                valid=np.ones((len(act), e), bool), h=h, w=w,
                patch=cfg.patch, inject=cfg.inject_ber, due=due,
                sobel=cfg.sobel_size, window=cfg.window_size, phys=phys,
                e=e, cap=cap))
    return rounds


def device_info(device: str, peak: int, prof) -> dict:
    import torch
    if device.startswith("cuda"):
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": 1, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    if prof is not None:
        info["busy_s"] = prof["trace"].busy_s
        info["window_s"] = prof["wall_s"]
    return info
