"""``closed``: a saturated closed loop.  Each turn feeds every lane its next
``slab_events``, pumps, and polls every lane, so every lane always has full
chunks waiting and the pool runs flat out.

Mix parameters: ``slab_events``, ``warmup_chunks``, ``settle_seconds``,
``trace_turns``.
"""
from __future__ import annotations

import time

import numpy as np


def _turns(drv, slab: int, seconds: float) -> dict:
    t0 = now = time.perf_counter()
    ends = []
    while now - t0 < seconds:
        drv.turn([slab] * len(drv.lanes))
        now = time.perf_counter()
        ends.append(now)
    turn_ms = np.diff([t0] + ends) * 1e3
    return {"wall_s": now - t0, "turns": len(ends),
            "turn_ms_by_quarter": [float(np.median(q)) for q in
                                   np.array_split(turn_ms, 4) if len(q)]}


def settle(drv, mix: dict, cell: dict):
    """``settle_seconds`` of the loop itself, so the window opens on a pool
    in its steady state."""
    _turns(drv, int(mix["slab_events"]), float(mix["settle_seconds"]))


def window(drv, mix: dict, state, seconds: float) -> dict:
    """Turns until ``seconds`` have passed."""
    return _turns(drv, int(mix["slab_events"]), seconds)


def traced(drv, mix: dict, state, win: dict) -> None:
    """The profiled stretch: ``trace_turns`` more turns."""
    for _ in range(int(mix["trace_turns"])):
        drv.turn([int(mix["slab_events"])] * len(drv.lanes))


def finish(drv, mix: dict, state, win: dict) -> None:
    """Nothing is due after a closed window."""


def report(drv, mix: dict, state, win: dict, cell: dict) -> dict:
    """``attempted`` (slabs fed in the window), ``failed``, the end-to-end
    values this loop measures (none beyond the general ones), what to log
    and what to keep in the result line."""
    q = [round(v, 3) for v in win["turn_ms_by_quarter"]]
    return {"attempted": win["turns"] * len(drv.lanes), "failed": 0,
            "values": {},
            "log": f"[closed] {win['turns']} turns in {win['wall_s']:.3f} s;"
                   f" median ms per turn by quarter of the window {q}",
            "keep": {"turn_ms_by_quarter": win["turn_ms_by_quarter"]}}
