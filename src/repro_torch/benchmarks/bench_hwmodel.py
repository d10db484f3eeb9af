"""Paper Fig. 9 (latency/energy against Vdd) and Fig. 10(a,c) (breakdowns).

The port of the reference's ``benchmarks/bench_hwmodel.py``: rows
``name,us_per_call,derived`` where ``derived`` carries the paper-comparable
quantity of the calibrated hardware model (host arithmetic, 0 in
``us_per_call``), with the reference's row names and its calibration
asserts, so a calibration regression fails the bench run.
"""
from __future__ import annotations

from repro_torch.core import hwmodel as hw
from repro_torch.core.state import resolve_device


def rows(smoke: bool = False, device: str = "cuda"):
    """The model's rows; ``smoke`` changes nothing (no sizes), ``device``
    is checked like every bench's (CUDA asked for without it raises)."""
    resolve_device(device)
    out = []
    # Fig. 9(a): latency/energy across the DVFS voltage range
    for v in hw.DVFS_VOLTAGES:
        out.append((f"fig9a_latency_ns@{v:.1f}V", 0.0, hw.patch_latency_ns(v)))
        out.append((f"fig9a_energy_pj@{v:.1f}V", 0.0, hw.patch_energy_pj(v)))

    conv_l = hw.patch_latency_ns(1.2, nmc=False)
    conv_e = hw.patch_energy_pj(1.2, nmc=False)
    # Fig. 9(b): latency impact of NMC and NMC+pipeline
    out.append(("fig9b_speedup_nmc_only", 0.0,
                conv_l / hw.patch_latency_ns(1.2, pipeline=False)))
    out.append(("fig9b_speedup_nmc_pipeline", 0.0,
                conv_l / hw.patch_latency_ns(1.2)))
    out.append(("fig9b_speedup_at_0.6V", 0.0, conv_l / hw.patch_latency_ns(0.6)))
    # Fig. 9(c): energy impact of NMC and NMC+DVFS
    out.append(("fig9c_energy_ratio_nmc", 0.0, conv_e / hw.patch_energy_pj(1.2)))
    out.append(("fig9c_energy_ratio_nmc_dvfs06", 0.0,
                conv_e / hw.patch_energy_pj(0.6)))
    # Fig. 10(a): power breakdown @1.2V
    for k, v in hw.power_breakdown_fractions().items():
        out.append((f"fig10a_power_frac_{k}", 0.0, v))
    # Fig. 10(c): phase delay fractions @0.6V
    for k, v in hw.phase_fractions().items():
        out.append((f"fig10c_phase_frac_{k}", 0.0, v))

    # calibration asserts (paper's headline numbers)
    assert abs(conv_l / hw.patch_latency_ns(1.2) - 24.7) < 0.1
    assert abs(conv_l / hw.patch_latency_ns(1.2, pipeline=False) - 13.0) < 0.1
    assert abs(conv_e / hw.patch_energy_pj(0.6) - 6.6) < 0.1
    return out
