"""The control of ``correct``: the reference itself, put in the program's
place and computed one precision below what the config states (the Harris
LUT and the device's books in bfloat16 instead of float32, the host's books
in float32 instead of float64), judged by the same comparison against the
float64 reference.  It has to come out not
correct.  It folds each lane in the chunks of a schedule, as the check
folds a lane the pool moved between buckets or flushed."""
from __future__ import annotations

import torch

from perfbench.lib import check, manifest, streams
from perfbench.reference import detector


def as_program(res: detector.LaneResult, n: int) -> tuple:
    """A reference lane's outputs in the shape the pool hands them out:
    ``(scores, kept)`` and ``stats(lane)``'s books."""
    stats = {"n_events": n, "buffered": 0, "n_chunks": res.n_chunks,
             "kept_total": res.kept_total,
             "device_kept_total": res.kept_total,
             "energy_pj": res.energy_pj,
             "latency_ns_per_event": res.latency_ns / max(res.kept_total, 1),
             "device_energy_pj": res.dev_energy_pj,
             "device_latency_ns": res.dev_latency_ns}
    return (res.scores.astype("float32"), res.kept), stats


def readings(config: dict, seed: int, chunks, *, device: str,
             dtype=torch.bfloat16, root=manifest.ROOT) -> dict:
    """The comparison's numbers for the control on ``seed``'s streams,
    lane ``i`` folded in the chunk sizes ``chunks[i]`` (a schedule's
    ``check.sizes``; ``constant`` for a lane that never moves)."""
    lanes, seeds = streams.lane_streams(
        config["stream"], config["sensor"], config["cameras"], seed, root)
    ns = [sum(c) for c in chunks]
    evs = [ln.take(0, n) for ln, n in zip(lanes, ns)]
    xy, ts = [v[0] for v in evs], [v[1] for v in evs]
    p = check.params(config)
    ref = detector.Reference(p, seeds, device=device).run(xy, ts, chunks)
    low = detector.Reference(p, seeds, device=device, dtype=dtype).run(
        xy, ts, chunks)
    outs, stats = zip(*(as_program(r, n) for r, n in zip(low, ns)))
    return check.compare(config, ns, list(outs), list(stats), ref)


def constant(config: dict, events_per_lane: int) -> list:
    """Every lane of ``config`` folded in ``pipeline.chunk`` throughout,
    ``events_per_lane`` rounded down to whole chunks."""
    e = config["pipeline"]["chunk"]
    return [[e] * (events_per_lane // e)] * config["cameras"]
