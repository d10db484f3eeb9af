"""Synthetic event streams with ground-truth corners (numpy; a copy of
``repro.events.synthetic`` so the port draws byte-equal streams).

The paper evaluates on shapes_dof / dynamic_dof (Mueggler et al. 2017) which
are not redistributable here; we generate *analogue* streams with the same
structure so the PR-AUC experiments (Fig. 11) are runnable end-to-end:

  * ``shapes_stream``  — black polygons on a light background, translating +
    rotating (the shapes_* family: strong edges, unambiguous vertices).
  * ``dynamic_stream`` — several independently-moving polygons + global
    camera motion (the dynamic_* family: clutter, occlusion-free).

Event model: contrast edges sweep pixels; each sweep emits events along the
polygon boundary with density proportional to normal speed, plus Poisson BA
noise.  Ground truth: an event is corner-positive iff within ``gt_radius`` px
of a (moving) polygon vertex at its timestamp — the standard protocol for
event-corner evaluation.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "EventStream",
    "shapes_stream",
    "dynamic_stream",
    "rate_profile_stream",
    "ramp_stream",
    "burst_stream",
]


@dataclasses.dataclass
class EventStream:
    xy: np.ndarray          # (E, 2) int32, x=col, y=row
    ts: np.ndarray          # (E,) int64 microseconds, sorted
    pol: np.ndarray         # (E,) int8 in {-1, +1}
    is_corner: np.ndarray   # (E,) bool ground truth
    height: int
    width: int

    def __len__(self) -> int:
        return self.xy.shape[0]


def _polygon(n_vertices: int, radius: float, rng) -> np.ndarray:
    ang = np.sort(rng.uniform(0, 2 * np.pi, n_vertices))
    # Repel angles so vertices are distinct corners.
    ang = ang + np.linspace(0, 2 * np.pi, n_vertices, endpoint=False)
    ang = np.sort(np.mod(ang, 2 * np.pi))
    r = radius * rng.uniform(0.75, 1.0, n_vertices)
    return np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)


def _emit_polygon_events(
    verts_t,            # callable t_us -> (V, 2) float vertices
    t0_us, t1_us, rate_per_us, height, width, rng, gt_radius=3.0,
):
    """Sample boundary events of a moving polygon over [t0, t1)."""
    n = rng.poisson(rate_per_us * (t1_us - t0_us))
    if n == 0:
        z = np.zeros((0,))
        return (np.zeros((0, 2), np.int32), np.zeros((0,), np.int64),
                np.zeros((0,), np.int8), np.zeros((0,), bool))
    t = np.sort(rng.uniform(t0_us, t1_us, n)).astype(np.int64)
    # For each event pick a random boundary point of the polygon at time t.
    vs = np.stack([verts_t(tt) for tt in t])                # (n, V, 2)
    nv = vs.shape[1]
    edge = rng.integers(0, nv, n)
    lam = rng.uniform(0, 1, n)
    p0 = vs[np.arange(n), edge]
    p1 = vs[np.arange(n), (edge + 1) % nv]
    pt = p0 + lam[:, None] * (p1 - p0)
    pt = pt + rng.normal(0, 0.4, pt.shape)                  # edge jitter
    x = np.clip(np.round(pt[:, 0]), 0, width - 1).astype(np.int32)
    y = np.clip(np.round(pt[:, 1]), 0, height - 1).astype(np.int32)
    pol = rng.choice(np.array([-1, 1], np.int8), n)
    # GT: near any vertex at that time.
    d = np.linalg.norm(vs - pt[:, None, :], axis=2).min(axis=1)
    is_c = d <= gt_radius
    return np.stack([x, y], 1), t, pol, is_c


def _noise_events(n, t0, t1, height, width, rng):
    if n <= 0:
        return (np.zeros((0, 2), np.int32), np.zeros((0,), np.int64),
                np.zeros((0,), np.int8), np.zeros((0,), bool))
    t = np.sort(rng.uniform(t0, t1, n)).astype(np.int64)
    x = rng.integers(0, width, n).astype(np.int32)
    y = rng.integers(0, height, n).astype(np.int32)
    pol = rng.choice(np.array([-1, 1], np.int8), n)
    return np.stack([x, y], 1), t, pol, np.zeros(n, bool)


def _merge(parts, height, width) -> EventStream:
    xy = np.concatenate([p[0] for p in parts], 0)
    ts = np.concatenate([p[1] for p in parts], 0)
    pol = np.concatenate([p[2] for p in parts], 0)
    isc = np.concatenate([p[3] for p in parts], 0)
    order = np.argsort(ts, kind="stable")
    return EventStream(xy[order], ts[order], pol[order], isc[order], height, width)


def shapes_stream(
    *,
    height: int = 180,
    width: int = 240,
    duration_us: int = 200_000,
    n_shapes: int = 3,
    signal_rate_per_us: float = 0.25,
    noise_rate_per_us: float = 0.02,
    seed: int = 0,
) -> EventStream:
    """shapes_dof analogue: few high-contrast polygons, smooth 6-DoF-ish motion."""
    rng = np.random.default_rng(seed)
    parts = []
    for s in range(n_shapes):
        nv = int(rng.integers(3, 7))
        base = _polygon(nv, rng.uniform(18, 32), rng)
        c0 = np.array([rng.uniform(40, width - 40), rng.uniform(30, height - 30)])
        vel = rng.uniform(-60e-6, 60e-6, 2)          # px per us
        omg = rng.uniform(-3e-6, 3e-6)               # rad per us

        def verts_t(t, base=base, c0=c0, vel=vel, omg=omg):
            a = omg * t
            rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
            return base @ rot.T + c0 + vel * t

        parts.append(
            _emit_polygon_events(
                verts_t, 0, duration_us, signal_rate_per_us / n_shapes,
                height, width, rng,
            )
        )
    parts.append(
        _noise_events(
            rng.poisson(noise_rate_per_us * duration_us), 0, duration_us,
            height, width, rng,
        )
    )
    return _merge(parts, height, width)


def dynamic_stream(
    *,
    height: int = 180,
    width: int = 240,
    duration_us: int = 200_000,
    n_shapes: int = 6,
    signal_rate_per_us: float = 0.35,
    noise_rate_per_us: float = 0.05,
    seed: int = 1,
) -> EventStream:
    """dynamic_dof analogue: more objects, faster + global camera pan."""
    rng = np.random.default_rng(seed)
    pan = rng.uniform(-40e-6, 40e-6, 2)
    parts = []
    for s in range(n_shapes):
        nv = int(rng.integers(3, 8))
        base = _polygon(nv, rng.uniform(10, 24), rng)
        c0 = np.array([rng.uniform(30, width - 30), rng.uniform(25, height - 25)])
        vel = rng.uniform(-120e-6, 120e-6, 2) + pan
        omg = rng.uniform(-6e-6, 6e-6)

        def verts_t(t, base=base, c0=c0, vel=vel, omg=omg):
            a = omg * t
            rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
            return base @ rot.T + c0 + vel * t

        parts.append(
            _emit_polygon_events(
                verts_t, 0, duration_us, signal_rate_per_us / n_shapes,
                height, width, rng,
            )
        )
    parts.append(
        _noise_events(
            rng.poisson(noise_rate_per_us * duration_us), 0, duration_us,
            height, width, rng,
        )
    )
    return _merge(parts, height, width)


def rate_profile_stream(
    profile_meps: np.ndarray,
    window_us: int = 10_000,
    *,
    height: int = 180,
    width: int = 240,
    seed: int = 2,
) -> EventStream:
    """Stream whose event *rate* follows a given Meps profile (for DVFS
    benchmarks — Fig. 8 / Table I don't care about geometry, only rate)."""
    rng = np.random.default_rng(seed)
    parts = []
    t0 = 0
    for meps in profile_meps:
        n = rng.poisson(float(meps) * window_us)
        parts.append(_noise_events(n, t0, t0 + window_us, height, width, rng))
        t0 += window_us
    return _merge(parts, height, width)


def ramp_stream(
    events_per_window,
    window_us: int = 5_000,
    *,
    height: int = 180,
    width: int = 240,
    seed: int = 7,
) -> EventStream:
    """Deterministic rate ramp: window ``j`` carries EXACTLY
    ``events_per_window[j]`` events, uniform in space and time within the
    window (no Poisson draw — the adaptive-scheduler witnesses need the
    DVFS rate estimator to read exact, reproducible per-window counts).
    ``window_us`` should be the DVFS half-window for those use cases."""
    rng = np.random.default_rng(seed)
    parts = []
    t0 = 0
    for n in events_per_window:
        parts.append(
            _noise_events(int(n), t0, t0 + window_us, height, width, rng)
        )
        t0 += window_us
    return _merge(parts, height, width)


def burst_stream(
    base_events_per_window: int,
    n_windows: int,
    window_us: int = 5_000,
    *,
    burst_start: int | None = None,
    burst_len: int | None = None,
    burst_factor: float = 2.0,
    height: int = 180,
    width: int = 240,
    seed: int = 7,
) -> EventStream:
    """Flash-crowd shape for overload witnesses: a flat baseline of
    ``base_events_per_window`` events per window with a contiguous burst of
    ``burst_len`` windows (default: the middle half) carrying
    ``burst_factor`` times the baseline.  Deterministic per-window counts
    like :func:`ramp_stream` — the overload ladder's hysteresis tests need
    exact, reproducible descent and recovery edges, not Poisson draws."""
    if burst_start is None:
        burst_start = n_windows // 4
    if burst_len is None:
        burst_len = n_windows // 2
    counts = [
        int(round(base_events_per_window * burst_factor))
        if burst_start <= j < burst_start + burst_len
        else int(base_events_per_window)
        for j in range(n_windows)
    ]
    return ramp_stream(
        counts, window_us, height=height, width=width, seed=seed
    )
