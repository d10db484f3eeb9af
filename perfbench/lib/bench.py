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
        # per pump, per lane: events delivered before and after the turn.
        # A turn's polls deliver every chunk its pump folded, and only
        # those: a move staged at a poll applies at the next pump, so the
        # chunks a fed range completes may fold a turn later.
        self.turns = []
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
        start = [ln.delivered for ln in self.lanes]
        with self.span("feed"):
            for ln, n in zip(self.lanes, counts):
                if n:
                    self.feed(ln, n)
        with self.span("pump"):
            self.pool.pump()
        with self.span("poll"):
            for ln in self.lanes:
                self._deliver(ln, self.pool.poll(ln.id))
        self.turns.append(list(zip(start, (ln.delivered
                                           for ln in self.lanes))))

    def flush(self, lane: Lane) -> None:
        """Fold the lane's buffered chunks and its partial tail
        (``pool.flush``) and keep what that returns as the lane's outputs:
        how a loop whose lanes hold partial chunks ends its window."""
        start = [ln.delivered for ln in self.lanes]
        with self.span("flush"):
            self._deliver(lane, self.pool.flush(lane.id))
        self.turns.append(list(zip(start, (ln.delivered
                                           for ln in self.lanes))))

    def _deliver(self, ln: Lane, got) -> None:
        s, k = got
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

    plans = [check.schedule(config, st) for st in lane_stats]
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
        rec = record(spec, cfg, win, prof, lanes, outs, plans, root)
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
    checks, vdd = check.check(config, lanes, outs, lane_stats, plans,
                              device=device)
    folded = sum(sum(check.sizes(plan)) for plan, _ in plans)
    log(f"[check] reference over {folded} events on "
        f"{len(lanes)} lanes in {time.perf_counter() - t:.2f} s; chunks by "
        f"Vdd (V: chunks, the reference's DVFS picks) {vdd}")
    result["correct"] = all(c["value"] <= c["limit"]
                            for c in checks.values())
    result["loop"] = rep["keep"]
    result["vdd_chunks"] = vdd
    result["schedules"] = [check.runs(plan) for plan, _ in plans]
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


def record(spec, cfg, win, prof, lanes, outs, plans, root) -> dict:
    """What the per-layer readers read."""
    rec = {"window": win, "profile": None, "rooflines": {}}
    if prof is None or not prof["trace"].device:
        return rec
    tr = prof["trace"]
    names = tr.by_name()
    rec["profile"] = {"wall_s": prof["wall_s"], "rounds": prof["rounds"],
                      "busy_s": tr.busy_s, "records": len(tr.device),
                      "by_name": names}
    rounds = profiled_rounds(spec["config"], cfg, prof["turns"], lanes, outs,
                             plans)
    for kname, mod in manifest.rooflines(root).items():
        bound_s, what, calls = mod.bound(rounds)
        hits = [v for k, v in names.items() if mod.CALL_KERNEL in k]
        k_s = sum(v[1] for k, v in names.items()
                  if any(n in k for n in mod.KERNELS))
        rec["rooflines"][kname] = {
            "bound_s": bound_s, "bound": what, "calls": calls,
            "kernel_s": k_s, "kernel_calls": sum(h[0] for h in hits)}
    return rec


def profiled_rounds(config, cfg, turns, lanes, outs, plans) -> list:
    """Each pool round of the traced stretch, rebuilt from the turns: the
    chunks a turn's poll delivered, each lane's cut as its schedule
    (``plans``, ``check.schedule``'s) says, grouped by bucket; round ``r``
    of a bucket in a pump holds the lanes that folded more than ``r`` of
    its chunks, each at its ``r``-th, padded to the bucket."""
    h, w = cfg.height, cfg.width
    phys = config["cameras"]
    compact = config["pool"].get("readout") == "compact"
    ends = [np.cumsum([n for _, n in plan], dtype=np.int64)
            for plan, _ in plans]
    rounds = []
    for turn in turns:
        folded: dict = {}        # bucket -> lane -> its chunks, in order
        for i, (d0, d1) in enumerate(turn):
            for c in range(int(np.searchsorted(ends[i], d0, "right")),
                           int(np.searchsorted(ends[i], d1, "right"))):
                b = plans[i][0][c][0]
                folded.setdefault(b, {}).setdefault(i, []).append(c)
        for e in sorted(folded):
            by_lane = folded[e]
            for r in range(max(len(v) for v in by_lane.values())):
                act = [i for i in sorted(by_lane) if len(by_lane[i]) > r]
                xy, keep, valid, due = [], [], [], 0
                for i in act:
                    c = by_lane[i][r]
                    n = plans[i][0][c][1]
                    lo = int(ends[i][c]) - n
                    x = lanes[i].replay.take(lo, lo + n)[0]
                    k = outs[i][1][lo:lo + n]
                    if n < e:
                        x = np.concatenate([x, np.zeros((e - n, 2),
                                                        x.dtype)])
                        k = np.concatenate([k, np.zeros(e - n, bool)])
                    xy.append(x)
                    keep.append(k)
                    valid.append(np.arange(e) < n)
                    due += (c + 1) % cfg.lut_every_chunks == 0
                rounds.append(SimpleNamespace(
                    xy=np.stack(xy), keep=np.stack(keep),
                    valid=np.stack(valid), h=h, w=w,
                    patch=cfg.patch, inject=cfg.inject_ber, due=due,
                    sobel=cfg.sobel_size, window=cfg.window_size, phys=phys,
                    e=e, cap=max(1, e // 8) if compact else 0))
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
