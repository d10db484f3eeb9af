"""``paced``: camera time, flat out.  Each turn feeds every lane the events
of its next ``turn_us`` of camera time (one DVFS half-window), pumps, and
polls every lane, so every lane's rate estimator and its moves between
chunk buckets follow its camera's rate.  Turns follow each other as fast
as the pool takes them, as ``closed.py``'s do, until the window's seconds
have passed.  A lane can hold part of a chunk when a window closes, so
``finish`` and ``traced`` end with ``Rig.flush`` on every lane.

Mix parameters: ``turn_us`` (the stream's ``half_us``, which is the
pipeline's ``dvfs_tw_us / 2``: a loop is not handed the config),
``warmup_chunks`` (empty: a warm-up turn fed by count would run ahead of
camera time), ``settle_seconds``, ``trace_turns``.
"""
from __future__ import annotations

import time

import numpy as np

SETTLE_MAX_TURNS = 400     # 2 s of camera time: five of the burst cycles


def _upto(ln, t: int) -> int:
    """Events of the lane's endless replay before camera time ``t``."""
    r = ln.replay
    passes, rem = divmod(t, r.duration)
    return passes * r.n + int(np.searchsorted(r.ts, rem, "left"))


def _turn(drv, mix: dict, state: dict) -> None:
    state["t"] += int(mix["turn_us"])
    drv.turn([max(0, _upto(ln, state["t"]) - ln.fed) for ln in drv.lanes])
    state["turns"] += 1


def _settled(drv) -> bool:
    """Every lane has sat in every bucket, and every bucket has folded
    events."""
    pool = drv.pool
    per_bucket = pool.pool_stats()["buckets"]
    if not all(b["h2d_valid_events"] > 0 for b in per_bucket.values()):
        return False
    for ln in drv.lanes:
        st = pool.stats(ln.id)
        seen = {st["bucket"]} | {b for _, old, new in st["migration_log"]
                                 for b in (old, new)}
        if seen != set(per_bucket):
            return False
    return True


def settle(drv, mix: dict, cell: dict) -> dict:
    """Turns until ``settle_seconds`` have passed since the first turn
    (which builds the kernels on a fresh checkout) and every lane has sat
    in every bucket, so the window opens on a pool whose executors have
    all run and whose lanes have all moved.  Which turn that happens at
    depends on the streams alone, so the settle refuses after
    ``SETTLE_MAX_TURNS`` turns, however fast the host."""
    state = {"t": 0, "turns": 0}
    _turn(drv, mix, state)
    t0 = time.perf_counter()
    while True:
        _turn(drv, mix, state)
        spent = time.perf_counter() - t0
        if spent >= float(mix["settle_seconds"]) and _settled(drv):
            return state
        if state["turns"] >= SETTLE_MAX_TURNS:
            raise RuntimeError(
                f"[paced] not settled after {state['turns']} turns: some "
                f"lane never sat in some bucket, or some bucket never "
                f"folded events")


def window(drv, mix: dict, state: dict, seconds: float) -> dict:
    """Turns until ``seconds`` have passed; the moves the pool applied in
    them."""
    moved0 = drv.pool.pool_stats()["migrations_total"]
    turns0 = state["turns"]
    t0 = now = time.perf_counter()
    ends = []
    while now - t0 < seconds:
        _turn(drv, mix, state)
        now = time.perf_counter()
        ends.append(now)
    turn_ms = np.diff([t0] + ends) * 1e3
    return {"wall_s": now - t0, "turns": state["turns"] - turns0,
            "migrations": drv.pool.pool_stats()["migrations_total"] - moved0,
            "turn_ms_by_quarter": [float(np.median(q)) for q in
                                   np.array_split(turn_ms, 4) if len(q)]}


def finish(drv, mix: dict, state: dict, win: dict) -> None:
    """Fold every lane's buffered events, its partial tail too."""
    for ln in drv.lanes:
        drv.flush(ln)


def traced(drv, mix: dict, state: dict, win: dict) -> None:
    """The profiled stretch: ``trace_turns`` more turns, then the flush."""
    for _ in range(int(mix["trace_turns"])):
        _turn(drv, mix, state)
    finish(drv, mix, state, win)


def report(drv, mix: dict, state: dict, win: dict, cell: dict) -> dict:
    """``attempted`` (lane turns fed in the window), ``failed``, no
    end-to-end values beyond the general ones, what to log and what to
    keep in the result line: the window's turns, the camera time they
    covered and the moves applied in them."""
    q = [round(v, 3) for v in win["turn_ms_by_quarter"]]
    camera_ms = win["turns"] * int(mix["turn_us"]) / 1e3
    return {"attempted": win["turns"] * len(drv.lanes), "failed": 0,
            "values": {},
            "log": f"[paced] {win['turns']} turns ({camera_ms:g} ms of "
                   f"camera time) in {win['wall_s']:.3f} s, "
                   f"{win['migrations']} moves; median ms per turn by "
                   f"quarter of the window {q}",
            "keep": {"turns": win["turns"], "camera_ms": camera_ms,
                     "migrations": win["migrations"],
                     "turn_ms_by_quarter": win["turn_ms_by_quarter"]}}
