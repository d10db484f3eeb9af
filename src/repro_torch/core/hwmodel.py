"""(A copy of ``repro.core.hwmodel``: host float64 maths, no jax.)

Analytic latency/energy model of the NMC-TOS macro — calibrated to the
paper's 65 nm SPICE results (Figs. 9, 10; Table I).

The paper's numbers we calibrate against (Vdd in volts):

  * conventional digital baseline: 392 ns / 7x7 patch (500 MHz, O(P^2)),
    energy 171.6 pJ / patch  (so NMC@1.2 V is 1.2x better and NMC@0.6 V is
    6.6x better, matching the stated ratios).
  * NMC + pipeline patch latency: 16 ns @ 1.2 V -> 203 ns @ 0.6 V.
  * NMC energy/patch: 139 pJ @ 1.2 V -> 26 pJ @ 0.6 V.
  * phase split of one row op @0.6 V: PCH 13.9%, MO 30.6%, CMP 27.8%, WR 27.8%.
  * throughput: conventional 2.6 Meps; NMC 63.1 Meps @1.2 V .. 4.9 Meps @0.6 V.
  * speedups: NMC-only 13.0x, NMC+pipeline 24.7x (@1.2 V); 1.93x @0.6 V.
  * power breakdown @1.2 V: peripherals 45.9%, array 31.9%, driver 11.6%,
    SA 10.6%.
  * BER: 0 above 0.62 V, 0.2% @0.61 V, 2.5% @0.6 V.

Scaling laws: delay follows the alpha-power law t ~ Vdd/(Vdd-Vth)^alpha with
(Vth, alpha) fitted to the two endpoint latencies; energy follows a power-law
fit E ~ Vdd^gamma through the two endpoint energies.  Everything else is
derived, so the model reproduces every ratio the paper reports (benchmarks
assert this) and interpolates the intermediate DVFS voltages.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

__all__ = [
    "HwParams",
    "PARAMS",
    "row_delay_ns",
    "patch_latency_ns",
    "patch_energy_pj",
    "max_throughput_meps",
    "phase_fractions",
    "ber_at",
    "power_mw",
    "dvfs_lut",
]


@dataclasses.dataclass(frozen=True)
class HwParams:
    patch: int = 7
    vdd_nom: float = 1.2
    vdd_min: float = 0.6
    # --- conventional digital baseline (fixed design point) ---------------
    conv_latency_ns: float = 392.0       # 7x7 @ 500 MHz
    conv_energy_pj: float = 171.6        # => 1.2x vs NMC@1.2V, 6.6x vs 0.6V
    # --- NMC endpoints (pipeline on) ---------------------------------------
    lat_12_ns: float = 392.0 / 24.7      # 15.87 ns  (~16 ns in the paper)
    lat_06_ns: float = 203.0
    e_12_pj: float = 139.0
    e_06_pj: float = 26.0
    # --- phase fractions of one row op (PCH, MO, CMP, WR) ------------------
    f_pch: float = 0.139
    f_mo: float = 0.306
    f_cmp: float = 0.278
    f_wr: float = 0.278
    # --- alpha-power delay fit ---------------------------------------------
    vth: float = 0.35
    # --- static power (leakage), small; scales ~Vdd ------------------------
    leak_mw_at_12: float = 0.004

    @property
    def alpha(self) -> float:
        """Fit alpha so row delay ratio matches the two latency endpoints."""
        ratio = self._row_from_patch(self.lat_06_ns) / self._row_from_patch(
            self.lat_12_ns
        )
        # t(v) = v / (v - vth)^alpha ;  solve t(0.6)/t(1.2) = ratio
        lhs = ratio / (self.vdd_min / self.vdd_nom)
        base = (self.vdd_nom - self.vth) / (self.vdd_min - self.vth)
        return math.log(lhs) / math.log(base)

    @property
    def gamma(self) -> float:
        """Energy power-law exponent through the two endpoints."""
        return math.log(self.e_12_pj / self.e_06_pj) / math.log(
            self.vdd_nom / self.vdd_min
        )

    def _row_from_patch(self, patch_ns: float) -> float:
        """Invert pipeline latency P*(t1+t2) + t3 + t4 -> one-row delay."""
        read = self.f_pch + self.f_mo
        write = self.f_cmp + self.f_wr
        return patch_ns / (self.patch * read + write)


PARAMS = HwParams()


def _alpha_delay(v: float, p: HwParams = PARAMS) -> float:
    return v / (v - p.vth) ** p.alpha


def row_delay_ns(vdd: float, p: HwParams = PARAMS) -> float:
    """Delay of one row operation (PCH+MO+CMP+WR) at ``vdd``."""
    t12 = p._row_from_patch(p.lat_12_ns)
    return t12 * _alpha_delay(vdd, p) / _alpha_delay(p.vdd_nom, p)


def phase_fractions(p: HwParams = PARAMS) -> dict[str, float]:
    return {"PCH": p.f_pch, "MO": p.f_mo, "CMP": p.f_cmp, "WR": p.f_wr}


def patch_latency_ns(
    vdd: float, *, pipeline: bool = True, nmc: bool = True, p: HwParams = PARAMS
) -> float:
    """Latency to update one PxP patch.

    conventional (nmc=False): fixed-design digital baseline, O(P^2).
    nmc, no pipeline: P sequential row ops.
    nmc + pipeline:  P*(t_pch + t_mo) + t_cmp + t_wr  (read/write overlap).
    """
    if not nmc:
        return p.conv_latency_ns
    t_row = row_delay_ns(vdd, p)
    if not pipeline:
        return p.patch * t_row
    read = (p.f_pch + p.f_mo) * t_row
    write = (p.f_cmp + p.f_wr) * t_row
    return p.patch * read + write


def patch_energy_pj(vdd: float, *, nmc: bool = True, p: HwParams = PARAMS) -> float:
    """Energy per patch update (power-law interpolation of the endpoints)."""
    if not nmc:
        return p.conv_energy_pj
    return p.e_12_pj * (vdd / p.vdd_nom) ** p.gamma


def max_throughput_meps(
    vdd: float, *, pipeline: bool = True, nmc: bool = True, p: HwParams = PARAMS
) -> float:
    """Max sustainable event rate in Meps (1 / patch latency)."""
    return 1e3 / patch_latency_ns(vdd, pipeline=pipeline, nmc=nmc, p=p)


def ber_at(vdd: float) -> float:
    """Monte-Carlo-characterised bit error rate of the 5-bit cells."""
    if vdd >= 0.62:
        return 0.0
    if vdd >= 0.61:
        return 0.002
    return 0.025


def power_mw(event_rate_meps: float, vdd: float, *, nmc: bool = True,
             p: HwParams = PARAMS) -> float:
    """Average power at a given event rate: dynamic (E/event * rate) + leak."""
    e_pj = patch_energy_pj(vdd, nmc=nmc, p=p)
    leak = p.leak_mw_at_12 * (vdd / p.vdd_nom)
    return e_pj * event_rate_meps * 1e-3 + leak


# ---------------------------------------------------------------------------
# DVFS operating-point table
# ---------------------------------------------------------------------------

DVFS_VOLTAGES: Sequence[float] = (0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2)


def dvfs_lut(p: HwParams = PARAMS) -> list[dict]:
    """Operating points: rate capacity + energy/event per voltage step.

    The DVFS controller picks the lowest-voltage entry whose ``max_meps``
    covers the estimated event rate (with headroom applied by the caller).
    """
    table = []
    for v in DVFS_VOLTAGES:
        table.append(
            {
                "vdd": v,
                "max_meps": max_throughput_meps(v, p=p),
                "energy_pj": patch_energy_pj(v, p=p),
                "f_clk_mhz": 1e3 / row_delay_ns(v, p=p) * 4.0,  # 4 phases/row-cycle
                "ber": ber_at(v),
            }
        )
    return table


def power_breakdown_fractions() -> dict[str, float]:
    """Fig. 10(a) power split at 1.2 V."""
    return {"peripherals": 0.459, "array": 0.319, "driver": 0.116, "sa": 0.106}
