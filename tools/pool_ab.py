#!/usr/bin/env python3
"""Time the serving pool and the HD batch run of one checkout, for
comparing two commits on the same card.

    python3 tools/pool_ab.py [--root DIR] [--reps N]

Needs one NVIDIA GPU with ``nvcc``.  Imports ``chip_smoke`` and
``repro_torch`` from ``DIR`` (default: this checkout), so a second
checkout unpacked elsewhere (``git archive``) runs its own code; run the
two in turns in one call (parent, change, change, parent) and compare only
within that call.  Serves the ``chip_smoke.py`` pool cells, DAVIS240 x16
(online DVFS with BER, async dense) and HD x4 (fixed 1.2 V, async
compact), on their first 64 chunks per lane, and folds the first 128
chunks of the HD stream through ``run_pipeline`` (online DVFS with BER),
``N`` times each after a warm-up.  Prints, per cell, every run's ms per
round (per chunk for the batch run) on the host clock and the median, and
the device busy time and the kernels and copies per round from one
profiled run.  The card's name
and power limit come first.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import torch
    if not torch.cuda.is_available():
        print("pool_ab: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core import pipeline
    from repro_torch.events import synthetic

    print(cs.nvidia_smi())
    print(f"[ab] root {root}")
    n_ev = 64 * 512
    dav = [synthetic.shapes_stream(duration_us=200_000, seed=s)
           for s in range(16)]
    hd = [synthetic.shapes_stream(height=720, width=1280,
                                  duration_us=100_000, n_shapes=12,
                                  signal_rate_per_us=2.0,
                                  noise_rate_per_us=0.5, seed=s)
          for s in range(4)]
    dav_cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2,
                                      patch=7, th=225, dvfs=True,
                                      dvfs_online=True, inject_ber=True)
    hd_cfg = pipeline.PipelineConfig(height=720, width=1280, chunk=512,
                                     lut_every_chunks=2, vdd=1.2)
    pool_kw = dict(ring_rounds=8, pipeline_depth=2, slab=n_ev,
                   max_events=n_ev, drain_mode="async")
    cells = {
        "DAVIS240 x16 async dense": lambda: cs.serve_pool(
            dav_cfg, dav, list(range(16)), readout="dense", **pool_kw),
        "HD x4 async compact": lambda: cs.serve_pool(
            hd_cfg, hd, list(range(4)), readout="compact", **pool_kw),
    }
    for name, run in cells.items():
        run()                                   # warm-up
        per = []
        for _ in range(args.reps):
            _, wall, _, st = run()
            per.append(wall / st["rounds_executed"] * 1e3)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, _, _, st = run()
        # the checkout under test may predate ``timing.device_rows``
        dev_rows = [r for r in prof.key_averages()
                    if str(r.device_type).endswith("CUDA")
                    and not getattr(r, "is_user_annotation", False)]
        busy = sum(r.self_device_time_total for r in dev_rows) / 1e3
        launched = sum(r.count for r in dev_rows)
        med = sorted(per)[len(per) // 2]
        print(f"[ab] {name}: ms per round "
              + " ".join(f"{t:.4f}" for t in per)
              + f"; median {med:.4f}; device busy "
              f"{busy / st['rounds_executed']:.4f} ms per round; "
              f"{launched / st['rounds_executed']:.1f} kernels and copies "
              f"per round")

    s = hd[0]
    win = slice(0, 128 * 512)
    bcfg = pipeline.PipelineConfig(height=720, width=1280, chunk=512,
                                   lut_every_chunks=2, dvfs=True,
                                   dvfs_online=True, inject_ber=True)
    pipeline.run_pipeline(s.xy[win], s.ts[win], bcfg)
    per = []
    for _ in range(args.reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.run_pipeline(s.xy[win], s.ts[win], bcfg)
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) / 128 * 1e3)
    print("[ab] HD batch fused: ms per chunk "
          + " ".join(f"{t:.4f}" for t in per)
          + f"; median {sorted(per)[len(per) // 2]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
