"""What decides ``correct``: every event a run fed, on every lane, worked
out again by the plain reference (``perfbench.reference``) from the same
streams and seeds, and compared with what the pool returned and booked.

The numbers compared, each with its limit from the config's ``limits``:

* ``undelivered``: events fed whose scores never came back (limit 0);
* ``kept_differ``: events whose STCF keep flag differs (exact, 0);
* ``score_inf_differ``: events scored on one side and not the other (0);
* ``score_gap``: per lane, the largest |score - reference| over the scored
  events, as a share of that lane's largest |reference score|; the worst
  lane's (the LUT is float32 in the program, float64 here);
* ``count_differ``: the sum of |differences| of each lane's events, chunks
  and kept events as ``stats(lane)`` books them (host and device), of its
  delivered events against the events its schedule folds, plus the entries
  of its ``migration_log`` that do not chain (0);
* ``books_gap``: the largest relative gap of a lane's float64 energy and
  latency books;
* ``device_books_gap``: the same for the float32 accumulators on the
  device, against the reference's float32 accumulation.

The reference cuts each lane where the pool did: its schedule (``schedule``)
starts in the bucket ``connect`` picks, moves at each ``migration_log``
entry and ends on the tail a ``flush`` folded.  The program's log decides
the cuts, so a program that logs one boundary and cuts at another differs
in kept flags, scores and chunks.
"""
from __future__ import annotations

import numpy as np

from perfbench.reference import detector


def params(config: dict) -> detector.Params:
    p, s = config["pipeline"], config["sensor"]
    if p["dvfs"] and not p["dvfs_online"]:
        raise ValueError("a pool serves online DVFS or a fixed Vdd only")
    return detector.Params(
        height=s["height"], width=s["width"], chunk=p["chunk"],
        patch=p["patch"], th=p["th"], lut_every=p["lut_every_chunks"],
        stcf_tw_us=p["stcf_tw_us"], stcf_support=p["stcf_support"],
        sobel=p["sobel_size"], window=p["window_size"],
        harris_k=p["harris_k"], dvfs_tw_us=p["dvfs_tw_us"],
        dvfs_headroom=p["dvfs_headroom"], vdd_floor=p["dvfs_vdd_floor"],
        counter_bits=p["dvfs_counter_bits"], inject_ber=p["inject_ber"],
        dvfs=p["dvfs"], vdd=p.get("vdd", 1.2), stcf=p["stcf_enabled"])


def buckets(config: dict) -> tuple:
    """The pool's chunk buckets: the config's ``pool.buckets``, or the
    pipeline's chunk alone."""
    return tuple(sorted({int(b) for b in config["pool"].get("buckets")
                         or [config["pipeline"]["chunk"]]}))


def _cut(start: int, stop: int, bucket: int) -> list:
    """``[start, stop)`` in chunks of ``bucket``, the last one partial."""
    whole, tail = divmod(max(0, stop - start), bucket)
    return [(bucket, bucket)] * whole + ([(bucket, tail)] if tail else [])


def schedule(config: dict, st: dict) -> tuple[list, int]:
    """One lane's chunks in stream order, ``[(bucket, events), ...]``, from
    its ``stats(lane)``, and the number of its ``migration_log`` entries
    that do not chain.  The lane connects to the smallest bucket of at
    least ``pipeline.chunk``; each entry ``(events_folded, old, new)`` ends
    a stretch of whole chunks of ``old``, the bucket in force, and starts
    ``new``; the events folded after the last entry are whole chunks of the
    bucket in force and, where a ``flush`` folded it, a partial tail.  An
    entry whose stretch is not whole chunks of ``old``, or whose ``old`` is
    not the bucket in force, does not chain: the stretch is cut as it
    stands and the entry counted."""
    chunk = config["pipeline"]["chunk"]
    bucket = next((b for b in buckets(config) if b >= chunk), chunk)
    folded = st["n_events"] - st["buffered"]
    plan, at, broken = [], 0, 0
    for stop, old, new in st.get("migration_log", ()):
        stop, old, new = int(stop), int(old), int(new)
        if old != bucket or stop < at or (stop - at) % bucket:
            broken += 1
        plan += _cut(at, stop, bucket)
        at, bucket = max(at, stop), new
    return plan + _cut(at, folded, bucket), broken


def sizes(plan: list) -> list:
    """A schedule's chunk sizes, as ``Reference.run`` takes them."""
    return [n for _, n in plan]


def runs(plan: list) -> list:
    """A schedule as runs ``[[bucket, events, chunks], ...]``."""
    out = []
    for b, n in plan:
        if out and out[-1][:2] == [b, n]:
            out[-1][2] += 1
        else:
            out.append([b, n, 1])
    return out


def from_runs(rows) -> list:
    """The schedule that ``runs`` wrote."""
    return [(int(b), int(n)) for b, n, k in rows for _ in range(int(k))]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def compare(config: dict, fed: list, outs: list, lane_stats: list,
            ref: list, broken=None) -> dict:
    """The numbers compared, each ``{"value": v, "limit": l}``;
    ``broken[i]`` is lane ``i``'s log entries that do not chain."""
    vals = {k: 0.0 for k in ("undelivered", "kept_differ",
                             "score_inf_differ", "score_gap",
                             "count_differ", "books_gap",
                             "device_books_gap")}
    broken = broken or [0] * len(ref)
    for n, (scores, kept), st, r, bad in zip(fed, outs, lane_stats, ref,
                                             broken):
        got = len(scores)
        vals["undelivered"] += abs(n - got)
        m = min(got, len(r.kept))
        scores, kept = scores[:m], kept[:m]
        vals["kept_differ"] += int(np.sum(kept != r.kept[:m]))
        fin, rfin = np.isfinite(scores), np.isfinite(r.scores[:m])
        vals["score_inf_differ"] += int(np.sum(fin != rfin))
        both = fin & rfin
        if both.any():
            top = np.abs(r.scores[:m][both]).max()
            gap = np.abs(scores[both].astype(np.float64)
                         - r.scores[:m][both]).max()
            vals["score_gap"] = max(vals["score_gap"],
                                    float(gap / max(top, 1e-300)))
        vals["count_differ"] += (
            abs(st["n_events"] - n) + abs(st["n_chunks"] - r.n_chunks)
            + abs(st["kept_total"] - r.kept_total)
            + abs(st["device_kept_total"] - r.kept_total)
            + abs(got - len(r.kept)) + bad)
        lat = st["latency_ns_per_event"] * max(st["kept_total"], 1)
        vals["books_gap"] = max(vals["books_gap"],
                                _rel(st["energy_pj"], r.energy_pj),
                                _rel(lat, r.latency_ns))
        vals["device_books_gap"] = max(
            vals["device_books_gap"],
            _rel(st["device_energy_pj"], r.dev_energy_pj),
            _rel(st["device_latency_ns"], r.dev_latency_ns))
    lim = config["limits"]
    return {k: {"value": float(v), "limit": float(lim.get(k, 0.0))}
            for k, v in vals.items()}


def vdd_chunks(p: detector.Params, ref: list) -> dict:
    """Chunks at each operating point over all lanes, as the reference's
    DVFS picked them: ``{"0.60": n, ...}``."""
    tab = detector.table(p)
    idx = np.concatenate([r.vdd_idx for r in ref])
    counts = np.bincount(idx, minlength=len(tab["vdd"]))
    return {f"{v:.2f}": int(c) for v, c in zip(tab["vdd"], counts) if c}


def check(config: dict, lanes, outs, lane_stats, plans, *, device: str):
    """Run the reference over every lane's folded events, cut as its
    schedule says (``plans``: ``schedule``'s pairs, one a lane), and
    compare; returns the numbers compared and ``vdd_chunks``."""
    import torch
    p = params(config)
    ref = detector.Reference(p, [ln.key_seed for ln in lanes],
                             device=device, dtype=torch.float64)
    chunks = [sizes(plan) for plan, _ in plans]
    evs = [ln.replay.take(0, sum(c)) for ln, c in zip(lanes, chunks)]
    res = ref.run([e[0] for e in evs], [e[1] for e in evs], chunks)
    return (compare(config, [ln.fed for ln in lanes], outs, lane_stats, res,
                    [bad for _, bad in plans]),
            vdd_chunks(p, res))
