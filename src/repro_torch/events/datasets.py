"""Dataset registry: named synthetic analogues of the paper's datasets
(numpy; a copy of ``repro.events.datasets`` so the port loads the same
streams and rate profiles, array for array).

Table I of the paper uses five recordings.  They are registered as
rate-matched analogues: the event count is scaled down so the streams stay
small, while the *rates*, which drive DVFS, are kept.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.events import synthetic

__all__ = ["DATASETS", "DatasetSpec", "load", "load_profile"]


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    max_rate_meps: float        # paper Table I
    n_events_m: float           # paper Table I (millions)
    kind: str                   # 'shapes' | 'dynamic' | 'profile'
    paper_power_dvfs_mw: float
    paper_power_nodvfs_mw: float


DATASETS: dict[str, DatasetSpec] = {
    "driving": DatasetSpec("driving", 25.9, 111.4, "profile", 0.44, 1.24),
    "laser": DatasetSpec("laser", 39.5, 57.6, "profile", 3.90, 5.37),
    "spinner": DatasetSpec("spinner", 11.4, 54.1, "profile", 0.38, 1.50),
    "dynamic_dof": DatasetSpec("dynamic_dof", 4.5, 57.1, "dynamic", 0.02, 0.13),
    "shapes_dof": DatasetSpec("shapes_dof", 1.9, 18.0, "shapes", 0.01, 0.04),
}


def _rate_profile(spec: DatasetSpec, n_windows: int, seed: int) -> np.ndarray:
    """Bursty rate profile (Meps) peaking at the dataset's max rate: a
    smoothed log-normal-like burst pattern, whose mean-to-peak ratio
    reproduces Table I's orderings of DVFS power."""
    rng = np.random.default_rng(seed)
    base = np.abs(rng.normal(0.08, 0.06, n_windows))
    bursts = rng.random(n_windows) < 0.08
    base[bursts] += rng.uniform(0.5, 1.0, bursts.sum())
    base = np.convolve(base, np.ones(5) / 5, mode="same")
    profile = base / base.max() * spec.max_rate_meps
    return profile


def load(name: str, *, seed: int = 0) -> synthetic.EventStream:
    """A dataset analogue: the geometry stream for shapes/dynamic, a
    down-scaled rate-profile stream for the high-rate recordings."""
    spec = DATASETS[name]
    if spec.kind == "shapes":
        return synthetic.shapes_stream(seed=seed)
    if spec.kind == "dynamic":
        return synthetic.dynamic_stream(seed=seed)
    profile = _rate_profile(spec, 64, seed)
    # Emitted at 1e-3 of the true rate so the counts stay small; the DVFS
    # benches work from the profile itself (load_profile) at true scale.
    return synthetic.rate_profile_stream(profile * 1e-3, seed=seed)


def load_profile(name: str, *, n_windows: int = 120,
                 seed: int = 0) -> np.ndarray:
    """Just the Meps rate profile (what the DVFS energy accounting needs)."""
    spec = DATASETS[name]
    if spec.kind in ("shapes", "dynamic"):
        # Low-rate geometry sets: a flat-ish low profile near the mean rate.
        rng = np.random.default_rng(seed)
        prof = np.abs(rng.normal(0.3, 0.15, n_windows)) * spec.max_rate_meps
        return np.clip(prof, 0, spec.max_rate_meps)
    return _rate_profile(spec, n_windows, seed)
