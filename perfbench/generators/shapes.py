"""``shapes``: a frozen copy of ``repro_torch.events.synthetic
.shapes_stream`` (the analogue of the Event-Camera Dataset's ``shapes_*``
recordings: a few polygons translating and rotating, events along their
edges with 0.4 px jitter, plus uniform background noise).  It draws from
numpy's generator in the same order, so a seed gives the same stream; the
polygon pose is computed for all timestamps at once instead of one event
at a time.

Parameters (a config's ``stream``): ``duration_us``, ``n_shapes``,
``signal_rate_per_us`` (all polygons together), ``noise_rate_per_us``.
"""
from __future__ import annotations

import numpy as np


def _polygon(n_vertices: int, radius: float, rng) -> np.ndarray:
    ang = np.sort(rng.uniform(0, 2 * np.pi, n_vertices))
    ang = ang + np.linspace(0, 2 * np.pi, n_vertices, endpoint=False)
    ang = np.sort(np.mod(ang, 2 * np.pi))
    r = radius * rng.uniform(0.75, 1.0, n_vertices)
    return np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)


def _edge_events(base, c0, vel, omg, duration_us, rate_per_us, height,
                 width, rng):
    n = rng.poisson(rate_per_us * duration_us)
    if n == 0:
        return np.zeros((0, 2), np.int32), np.zeros((0,), np.int64)
    t = np.sort(rng.uniform(0, duration_us, n)).astype(np.int64)
    a = omg * t
    cos, sin = np.cos(a)[:, None], np.sin(a)[:, None]
    # vertices at each event's time: base rotated by a, then translated
    vx = base[None, :, 0] * cos - base[None, :, 1] * sin + c0[0] + vel[0] * t[:, None]
    vy = base[None, :, 0] * sin + base[None, :, 1] * cos + c0[1] + vel[1] * t[:, None]
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
    rng.choice(np.array([-1, 1], np.int8), n)       # polarity, unused here
    return np.stack([x, y], 1), t


def generate(*, height: int, width: int, duration_us: int, n_shapes: int,
           signal_rate_per_us: float, noise_rate_per_us: float,
           seed: int) -> tuple[np.ndarray, np.ndarray]:
    """One stream: ``(xy (N, 2) int32, ts (N,) int64)``, time-sorted, all
    timestamps in ``[0, duration_us)``."""
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n_shapes):
        nv = int(rng.integers(3, 7))
        base = _polygon(nv, rng.uniform(18, 32), rng)
        c0 = np.array([rng.uniform(40, width - 40),
                       rng.uniform(30, height - 30)])
        vel = rng.uniform(-60e-6, 60e-6, 2)
        omg = rng.uniform(-3e-6, 3e-6)
        parts.append(_edge_events(base, c0, vel, omg, duration_us,
                                  signal_rate_per_us / n_shapes, height,
                                  width, rng))
    n = rng.poisson(noise_rate_per_us * duration_us)
    t = np.sort(rng.uniform(0, duration_us, n)).astype(np.int64)
    x = rng.integers(0, width, n).astype(np.int32)
    y = rng.integers(0, height, n).astype(np.int32)
    parts.append((np.stack([x, y], 1), t))
    xy = np.concatenate([p[0] for p in parts], 0)
    ts = np.concatenate([p[1] for p in parts], 0)
    order = np.argsort(ts, kind="stable")
    return xy[order], ts[order]
