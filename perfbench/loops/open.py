"""``open``: an open loop on a wall-clock schedule.  Camera ``i``'s slab
``k`` (the ``slab_events`` events after its first ``base_i``) is due at
``t0 + ((k + 1) * slab - phase_i) / r``, with ``r`` the cell's
``offered_events_per_s`` per camera and phases spread evenly over one slab,
so the cameras' slabs fall due in turn.  Each turn feeds every slab that is
due, pumps, and polls every lane; the schedule keeps its times whatever the
pool does.  A slab's latency runs from its due time to the return of the
``poll`` that delivers its last score; a slab due in the window and never
delivered counts as failed, and as infinitely late.

Mix parameters: ``slab_events``, ``warmup_chunks``, ``settle_seconds``,
``trace_seconds``, ``finish_limit_s``; the cell's data file gives
``offered_events_per_s``.
"""
from __future__ import annotations

import time

import numpy as np


class Schedule:
    """The slabs' due times, what has been fed, and when each arrived."""

    def __init__(self, drv, rate: float, slab: int, t0: float):
        self.drv, self.slab, self.t0 = drv, slab, t0
        n = len(drv.lanes)
        self.r = rate / n
        self.phase = [slab * i / n for i in range(n)]
        self.base = [ln.fed for ln in drv.lanes]
        self.next = [0] * n
        self.pending = [[] for _ in range(n)]   # (end event, due, slab id)
        self.slabs = []                          # [due, fed at, delivered]
        drv.on_delivery = self._delivered

    def due(self, i: int, k: int) -> float:
        return self.t0 + ((k + 1) * self.slab - self.phase[i]) / self.r

    def next_due(self) -> float:
        return min(self.due(i, k) for i, k in enumerate(self.next))

    def take_due(self, now: float, until: float) -> list:
        """Events to feed each lane: every slab due by ``now`` and before
        ``until``."""
        counts = []
        for i, ln in enumerate(self.drv.lanes):
            n = 0
            while True:
                d = self.due(i, self.next[i])
                if d > now or d >= until:
                    break
                end = self.base[i] + (self.next[i] + 1) * self.slab
                self.pending[i].append((end, d, len(self.slabs)))
                self.slabs.append([d, now, None])
                self.next[i] += 1
                n += self.slab
            counts.append(n)
        return counts

    def _delivered(self, ln, now: float) -> None:
        q = self.pending[self.drv.lanes.index(ln)]
        while q and q[0][0] <= ln.delivered:
            self.slabs[q.pop(0)[2]][2] = now

    def run(self, until: float) -> int:
        """Serve the schedule until ``until``; returns the turns."""
        turns = 0
        while True:
            now = time.perf_counter()
            if now >= until:
                return turns
            counts = self.take_due(now, until)
            if any(counts):
                self.drv.turn(counts)
                turns += 1
            else:
                with self.drv.span("wait"):
                    time.sleep(max(0.0, min(self.next_due(), until) - now))

    def finish(self, until: float, limit_s: float) -> None:
        """Feed what fell due before ``until`` and serve until every fed
        slab is delivered, for at most ``limit_s``."""
        stop = time.perf_counter() + limit_s
        counts = self.take_due(until, until)
        while time.perf_counter() < stop:
            self.drv.turn(counts)
            counts = [0] * len(counts)
            if all(not q for q in self.pending):
                return


def settle(drv, mix: dict, cell: dict) -> Schedule:
    """Start the schedule and serve ``settle_seconds`` of it; it runs on
    into the window."""
    t = time.perf_counter()
    sched = Schedule(drv, float(cell["offered_events_per_s"]),
                     int(mix["slab_events"]), t)
    sched.run(t + float(mix["settle_seconds"]))
    return sched


def window(drv, mix: dict, sched: Schedule, seconds: float) -> dict:
    """The window, continuing the schedule the settle began."""
    t0 = time.perf_counter()
    turns = sched.run(t0 + seconds)
    return {"wall_s": time.perf_counter() - t0, "turns": turns,
            "t_open": t0, "t_close": t0 + seconds}


def traced(drv, mix: dict, sched: Schedule, win: dict) -> None:
    """The profiled stretch: ``trace_seconds`` more of the schedule, then
    every slab it fed is delivered."""
    end = win["t_close"] + float(mix["trace_seconds"])
    sched.run(end)
    sched.finish(end, mix["finish_limit_s"])


def finish(drv, mix: dict, sched: Schedule, win: dict) -> None:
    """Deliver every slab that fell due in the window."""
    sched.finish(win["t_close"], mix["finish_limit_s"])


def report(drv, mix: dict, sched: Schedule, win: dict, cell: dict) -> dict:
    """Every slab due in the window: ``attempted``, ``failed`` (never
    delivered), ``slab_latency_p95_ms``, what to log and to keep."""
    due = sorted((s for s in sched.slabs
                  if win["t_open"] <= s[0] < win["t_close"]),
                 key=lambda s: s[0])
    lat = np.array([(s[2] - s[0]) * 1e3 if s[2] is not None else np.inf
                    for s in due])
    late = np.array([(s[1] - s[0]) * 1e3 for s in due])
    quarters = [float(np.median(part)) for part in np.array_split(lat, 4)
                if len(part)]
    p95 = float(np.percentile(lat, 95))
    rate = float(cell["offered_events_per_s"])
    return {"attempted": len(due), "failed": int(np.sum(~np.isfinite(lat))),
            "values": {"slab_latency_p95_ms": p95},
            "log": f"[open] {len(due)} slabs due in the window at "
                   f"{rate:.6g} events/s; latency median "
                   f"{np.median(lat):.3f} ms, p95 {p95:.3f} ms, medians by "
                   f"quarter of the window {quarters} ms; generator ran "
                   f"late by median {np.median(late):.3f} ms, p95 "
                   f"{np.percentile(late, 95):.3f} ms, max "
                   f"{late.max():.3f} ms",
            "keep": {"offered": rate, "p50_ms": float(np.median(lat)),
                     "p95_ms": p95, "quarter_p50_ms": quarters,
                     "late_p95_ms": float(np.percentile(late, 95))}}
