"""The control of ``correct``: the reference itself, put in the program's
place and computed one precision below what the config states (the Harris
LUT and the device's books in bfloat16 instead of float32, the host's books
in float32 instead of float64), judged by the same comparison against the
float64 reference.  It has to come out not
correct."""
from __future__ import annotations

import torch

from perfbench.lib import check, streams
from perfbench.reference import detector


def as_program(res: detector.LaneResult, n: int) -> tuple:
    """A reference lane's outputs in the shape the pool hands them out:
    ``(scores, kept)`` and ``stats(lane)``'s books."""
    stats = {"n_events": n, "n_chunks": res.n_chunks,
             "kept_total": res.kept_total,
             "device_kept_total": res.kept_total,
             "energy_pj": res.energy_pj,
             "latency_ns_per_event": res.latency_ns / max(res.kept_total, 1),
             "device_energy_pj": res.dev_energy_pj,
             "device_latency_ns": res.dev_latency_ns}
    return (res.scores.astype("float32"), res.kept), stats


def readings(config: dict, seed: int, events_per_lane: int, *,
             device: str, dtype=torch.bfloat16) -> dict:
    """The comparison's numbers for the control on ``seed``'s streams, each
    lane ``events_per_lane`` events long (rounded down to whole chunks)."""
    lanes, seeds = streams.lane_streams(
        config["stream"], config["sensor"], config["cameras"], seed)
    e = config["pipeline"]["chunk"]
    n = events_per_lane // e * e
    evs = [ln.take(0, n) for ln in lanes]
    xy, ts = [v[0] for v in evs], [v[1] for v in evs]
    p = check.params(config)
    ref = detector.Reference(p, seeds, device=device).run(xy, ts)
    low = detector.Reference(p, seeds, device=device, dtype=dtype).run(xy, ts)
    outs, stats = zip(*(as_program(r, n) for r in low))
    return check.compare(config, [n] * len(lanes), list(outs), list(stats),
                         ref)
