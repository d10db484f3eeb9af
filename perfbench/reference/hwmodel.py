"""The NMC-TOS macro's energy, latency and write-error model, as the paper
calibrates it (65 nm SPICE; Figs. 9-10, Table I), for the reference.

Patch latency with the read/write pipeline at 1.2 V is 392/24.7 ns and
203 ns at 0.6 V; delay follows the alpha-power law v / (v - 0.35)**alpha
through those two points.  Energy per patch is 139 pJ at 1.2 V and 26 pJ
at 0.6 V on a power law.  One row operation splits into precharge 13.9%,
multiply-out 30.6%, compare 27.8% and write 27.8%; a pipelined 7x7 patch
costs 7 x (precharge + multiply-out) + compare + write.  The 5-bit cells
flip with probability 2.5% below 0.61 V, 0.2% at 0.61 V, 0 from 0.62 V.
The DVFS controller picks among 0.6, 0.7, ..., 1.2 V the lowest point whose
capacity (1 / patch latency) covers the estimated rate times a headroom.
"""
from __future__ import annotations

import math

import numpy as np

VOLTS = (0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2)
PATCH = 7
VTH = 0.35
READ = 0.139 + 0.306
WRITE = 0.278 + 0.278


def _row_ns(patch_ns: float) -> float:
    return patch_ns / (PATCH * READ + WRITE)


def _alpha() -> float:
    ratio = _row_ns(203.0) / _row_ns(392.0 / 24.7)
    return math.log(ratio / 0.5) / math.log((1.2 - VTH) / (0.6 - VTH))


def patch_latency_ns(v: float) -> float:
    a = _alpha()
    row = _row_ns(392.0 / 24.7) * (v / (v - VTH) ** a) / (
        1.2 / (1.2 - VTH) ** a)
    return PATCH * READ * row + WRITE * row


def patch_energy_pj(v: float) -> float:
    gamma = math.log(139.0 / 26.0) / math.log(2.0)
    return 139.0 * (v / 1.2) ** gamma


def ber_at(v: float) -> float:
    if v >= 0.62:
        return 0.0
    return 0.002 if v >= 0.61 else 0.025


def op_points(vdd_floor: float = 0.6) -> dict:
    """The selectable points, ascending: volts, capacity (Meps), write
    error rate, energy (pJ) and latency (ns) per patch."""
    volts = [v for v in VOLTS if v >= vdd_floor - 1e-9]
    return {
        "vdd": np.array(volts),
        "cap_meps": np.array([1e3 / patch_latency_ns(v) for v in volts]),
        "ber": np.array([ber_at(v) for v in volts]),
        "energy_pj": np.array([patch_energy_pj(v) for v in volts]),
        "latency_ns": np.array([patch_latency_ns(v) for v in volts]),
    }
