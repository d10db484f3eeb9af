"""``ramps``: the ``shapes`` scene (``shapes.py``, loaded as a sibling file)
with its event rate ramping on a cycle, so that a camera goes from
background noise to a busy scene and back, as the Event Camera Dataset's
6-DOF recordings speed up and a surveillance camera's scene fills and
empties.

The rate per DVFS half-window (``half_us``) follows a cycle of
``rise_us + hold_us + fall_us`` (which is ``duration_us``, so the replay
repeats it seamlessly): a log-linear rise from ``floor_meps`` to
``peak_meps`` over ``rise_us``, ``hold_us`` at the peak, and a log-linear
fall back over ``fall_us``.  Half-window ``k`` carries exactly
``round(rate(t) * half_us)`` events, ``rate`` read at its middle ``t``
shifted by the lane's phase, ``lane * phase_step_us``: the rate
estimator then reads the same counts for a seed, and so the pool's moves
repeat.  The events are the scene's, made per half-window: the polygons
are drawn as ``shapes`` draws them, then each half-window's count of
timestamps, uniform in it, each event on one polygon's edge (each with
probability ``(1 - noise_share) / n_shapes``, placed as ``shapes``
places them) or uniform noise (``noise_share``).  Only the events that
are fed are made.

The lane's phase: ``lib.streams.lane_streams`` passes ``generate`` no lane
index, and it loads this module afresh (``manifest.generator``) for every
set of lanes and asks for them in lane order.  So ``generate`` gives the
``i``-th stream it makes since the module was loaded the phase of lane
``i``; ``half_window_counts(lane=i)`` gives any lane's counts.

Parameters (a config's ``stream``): ``duration_us``, ``n_shapes``,
``noise_share``, ``floor_meps``, ``peak_meps``, ``rise_us``, ``hold_us``,
``fall_us``, ``half_us`` (the pipeline's ``dvfs_tw_us / 2``),
``phase_step_us``.
"""
from __future__ import annotations

import importlib.util
import itertools
from pathlib import Path

import numpy as np

_spec = importlib.util.spec_from_file_location(
    "pb_ramps_shapes", Path(__file__).with_name("shapes.py"))
shapes = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(shapes)

_made = itertools.count()    # streams made since this module was loaded


def _rate_meps(t_us, *, floor_meps, peak_meps, rise_us, hold_us, fall_us):
    """The cycle's rate (events/us) at cycle time ``t_us`` (any real,
    taken modulo the cycle)."""
    t = np.mod(np.asarray(t_us, np.float64), rise_us + hold_us + fall_us)
    span = np.log(peak_meps / floor_meps)
    up = floor_meps * np.exp(span * t / rise_us)
    down = peak_meps * np.exp(-span * (t - rise_us - hold_us) / fall_us)
    return np.where(t < rise_us, up,
                    np.where(t < rise_us + hold_us, peak_meps, down))


def half_window_counts(*, lane, duration_us, floor_meps, peak_meps, rise_us,
                       hold_us, fall_us, half_us, phase_step_us) -> np.ndarray:
    """Events of each half-window of one cycle for camera ``lane``."""
    if rise_us + hold_us + fall_us != duration_us or duration_us % half_us:
        raise ValueError("duration_us must be the cycle, whole half-windows")
    mid = np.arange(duration_us // half_us) * half_us + half_us / 2
    r = _rate_meps(mid + lane * phase_step_us, floor_meps=floor_meps,
                   peak_meps=peak_meps, rise_us=rise_us, hold_us=hold_us,
                   fall_us=fall_us)
    return np.round(r * half_us).astype(np.int64)


def _polygons(n_shapes, height, width, rng) -> list:
    """Each polygon's ``(base, c0, vel, omg)``, drawn as ``shapes`` does."""
    out = []
    for _ in range(n_shapes):
        nv = int(rng.integers(3, 7))
        base = shapes._polygon(nv, rng.uniform(18, 32), rng)
        c0 = np.array([rng.uniform(40, width - 40),
                       rng.uniform(30, height - 30)])
        vel = rng.uniform(-60e-6, 60e-6, 2)
        omg = rng.uniform(-3e-6, 3e-6)
        out.append((base, c0, vel, omg))
    return out


def _edge_xy(polygon, t, height, width, rng) -> np.ndarray:
    """Points on the polygon's edges at times ``t``, placed as
    ``shapes._edge_events`` places them (0.4 px jitter, clipped)."""
    base, c0, vel, omg = polygon
    n = len(t)
    a = omg * t
    cos, sin = np.cos(a)[:, None], np.sin(a)[:, None]
    vx = (base[None, :, 0] * cos - base[None, :, 1] * sin + c0[0]
          + vel[0] * t[:, None])
    vy = (base[None, :, 0] * sin + base[None, :, 1] * cos + c0[1]
          + vel[1] * t[:, None])
    nv = base.shape[0]
    edge = rng.integers(0, nv, n)
    lam = rng.uniform(0, 1, n)
    rows = np.arange(n)
    x0, y0 = vx[rows, edge], vy[rows, edge]
    x1, y1 = vx[rows, (edge + 1) % nv], vy[rows, (edge + 1) % nv]
    pt = np.stack([x0 + lam * (x1 - x0), y0 + lam * (y1 - y0)], 1)
    pt = pt + rng.normal(0, 0.4, pt.shape)
    x = np.clip(np.round(pt[:, 0]), 0, width - 1).astype(np.int32)
    y = np.clip(np.round(pt[:, 1]), 0, height - 1).astype(np.int32)
    return np.stack([x, y], 1)


def generate(*, height, width, seed, duration_us, n_shapes, noise_share,
             floor_meps, peak_meps, rise_us, hold_us, fall_us, half_us,
             phase_step_us):
    """The next lane's cycle: ``(xy (N, 2) int32, ts (N,) int64)``,
    time-sorted, every timestamp in ``[0, duration_us)``."""
    counts = half_window_counts(
        lane=next(_made), duration_us=duration_us, floor_meps=floor_meps,
        peak_meps=peak_meps, rise_us=rise_us, hold_us=hold_us,
        fall_us=fall_us, half_us=half_us, phase_step_us=phase_step_us)
    rng = np.random.default_rng(seed)
    polygons = _polygons(n_shapes, height, width, rng)
    n = int(counts.sum())
    ts = np.sort(np.repeat(np.arange(len(counts), dtype=np.int64) * half_us,
                           counts) + rng.integers(0, half_us, n))
    share = (1 - noise_share) / n_shapes
    src = rng.choice(n_shapes + 1, n, p=[share] * n_shapes + [noise_share])
    xy = np.empty((n, 2), np.int32)
    for j, polygon in enumerate(polygons):
        on = np.flatnonzero(src == j)
        xy[on] = _edge_xy(polygon, ts[on], height, width, rng)
    on = np.flatnonzero(src == n_shapes)
    xy[on, 0] = rng.integers(0, width, len(on))
    xy[on, 1] = rng.integers(0, height, len(on))
    return xy, ts
