"""Quickstart: detect corners in an event stream with NMC-TOS, end to end.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of the reference's ``examples/quickstart.py``: generates a
shapes_dof-style synthetic stream, runs the full paper pipeline (STCF
denoise -> TOS update -> Harris LUT -> per-event corner score) on the card
(``--device cuda``, the default) or through the plain versions (``cpu``),
and reports PR-AUC plus the modelled hardware cost of the run on the 65 nm
NMC macro at two operating points.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import hwmodel, pipeline, pr_eval
from repro_torch.events import synthetic


def main(device: str = "cuda") -> dict:
    """Run the quickstart on ``device``, print its lines and return the
    printed values: ``n_events``, ``kept_share``, ``n_scored``, ``pr_auc``,
    ``macro`` (per Vdd: ``energy_uj``, ``busy_ms``, ``capacity_meps``),
    ``conventional_ms`` and ``conventional_meps``."""
    stream = synthetic.shapes_stream(duration_us=60_000, seed=0)
    print(f"stream: {len(stream)} events over 60 ms on "
          f"{stream.width}x{stream.height} ({stream.is_corner.mean():.0%} "
          f"corner GT)")

    cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2,
                                  device=device)
    res = pipeline.run_pipeline(stream.xy, stream.ts, cfg)

    ok = np.isfinite(res.scores)
    auc = pr_eval.pr_auc(res.scores[ok], stream.is_corner[ok])
    print(f"kept after STCF: {res.kept.mean():.0%}  scored: {ok.sum()} "
          f"events")
    print(f"PR-AUC: {auc:.3f}")

    n = int(res.kept.sum())
    macro = {}
    for vdd in (1.2, 0.6):
        e_uj = n * hwmodel.patch_energy_pj(vdd) * 1e-6
        t_ms = n * hwmodel.patch_latency_ns(vdd) * 1e-6
        cap = hwmodel.max_throughput_meps(vdd)
        macro[vdd] = dict(energy_uj=e_uj, busy_ms=t_ms, capacity_meps=cap)
        print(f"macro @ {vdd:.1f} V: {e_uj:.1f} uJ, {t_ms:.2f} ms busy "
              f"({cap:.1f} Meps capacity)")
    conv = n * hwmodel.patch_latency_ns(1.2, nmc=False) * 1e-6
    conv_meps = hwmodel.max_throughput_meps(1.2, nmc=False)
    print(f"conventional digital would need {conv:.2f} ms "
          f"({conv_meps:.1f} Meps)")
    return dict(n_events=len(stream), kept_share=float(res.kept.mean()),
                n_scored=int(ok.sum()), pr_auc=float(auc), macro=macro,
                conventional_ms=conv, conventional_meps=conv_meps)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    main(ap.parse_args().device)
