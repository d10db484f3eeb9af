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
  and kept events as ``stats(lane)`` books them (host and device) (0);
* ``books_gap``: the largest relative gap of a lane's float64 energy and
  latency books;
* ``device_books_gap``: the same for the float32 accumulators on the
  device, against the reference's float32 accumulation.
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


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-300)


def compare(config: dict, fed: list, outs: list, lane_stats: list,
            ref: list) -> dict:
    """The numbers compared, each ``{"value": v, "limit": l}``."""
    vals = {k: 0.0 for k in ("undelivered", "kept_differ",
                             "score_inf_differ", "score_gap",
                             "count_differ", "books_gap",
                             "device_books_gap")}
    for n, (scores, kept), st, r in zip(fed, outs, lane_stats, ref):
        m = len(scores)
        vals["undelivered"] += n - m
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
            + abs(st["device_kept_total"] - r.kept_total))
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


def check(config: dict, lanes, outs, lane_stats, *, device: str):
    """Run the reference over every lane's fed events and compare; returns
    the numbers compared and ``vdd_chunks``."""
    import torch
    p = params(config)
    ref = detector.Reference(p, [ln.key_seed for ln in lanes],
                             device=device, dtype=torch.float64)
    evs = [ln.replay.take(0, ln.fed) for ln in lanes]
    res = ref.run([e[0] for e in evs], [e[1] for e in evs])
    return (compare(config, [ln.fed for ln in lanes], outs, lane_stats, res),
            vdd_chunks(p, res))
