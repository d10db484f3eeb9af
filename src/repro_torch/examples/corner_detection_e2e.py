"""Full paper-system demo: DVFS + BER at 0.6 V against error-free operation.

    PYTHONPATH=src python -m repro_torch.examples.corner_detection_e2e \
        [--device cpu]

The port of the reference's ``examples/corner_detection_e2e.py``, with its
lines and sizes (80 ms streams, chunk 512, ``lut_every_chunks`` 2, the
shapes_dof and dynamic_dof analogues).  It reproduces the paper's headline
system experiment (Fig. 11 and Table I's logic) on the batch pipeline: the
detector runs at the DVFS-chosen voltage; at 0.6 V the macro's 2.5% BER
corrupts TOS write-backs, and the corner PR-AUC barely moves while the
modelled energy drops ~5x.

It closes with the scan against the host-loop oracle (same bits out, with
O(n_chunks) more blocking transfers on the oracle's side; the scan runs on
the config's default backend ``"fused"``, K1, and the oracle, which has no
fused spelling, on ``"nmc"``, K4) and a tour of the serving layers: a
``StreamingDetector`` session fed in uneven slabs with online DVFS, a
``PrefetchingLoader`` device-slab feed, a two-camera ``DetectorPool`` with
compact readout, a pool of two chunk-size buckets, an adaptive
live-migration lane, and an overload-ladder lane pair (a 2x flash crowd
degrades the standard session tier by tier while the premium session
keeps full quality), each held bit-exact to the batch scan or to a
``rebucket`` replay.  Everything runs on ``--device`` (the card unless the
caller asks for ``cpu``, which runs the plain versions).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core import pipeline, pr_eval
from repro_torch.events import stream as stream_mod
from repro_torch.events import synthetic
from repro_torch.serve import (DetectorPool, LadderConfig, StreamingDetector,
                               session_base_us)

# The oracle's backend: it needs a standalone TOS update, which "fused"
# does not have; all backends give the same bits.
ORACLE_BACKEND = "nmc"


def run(stream, *, vdd, inject, use_dvfs=False, device="cuda"):
    cfg = pipeline.PipelineConfig(
        chunk=512, lut_every_chunks=2, vdd=vdd, inject_ber=inject,
        dvfs=use_dvfs, device=device,
    )
    return pipeline.run_pipeline(stream.xy, stream.ts, cfg)


def compare_scan_vs_reference(stream, device="cuda") -> dict:
    """Time the scan against the host-loop oracle (both warmed first) and
    print the reference's lines, plus the backend of each side.  Returns
    ``bit_exact``, ``host_syncs_scan`` / ``_reference``, ``us_per_event_
    scan`` / ``_reference`` and the two backends."""
    cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2,
                                  device=device)
    ref_cfg = dataclasses.replace(cfg, backend=ORACLE_BACKEND)
    pipeline.run_pipeline(stream.xy, stream.ts, cfg)
    pipeline.run_pipeline_reference(stream.xy, stream.ts, ref_cfg)
    t0 = time.perf_counter()
    r_scan = pipeline.run_pipeline(stream.xy, stream.ts, cfg)
    t_scan = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_ref = pipeline.run_pipeline_reference(stream.xy, stream.ts, ref_cfg)
    t_ref = time.perf_counter() - t0

    n = len(stream)
    same = np.array_equal(r_scan.scores, r_ref.scores) and np.array_equal(
        r_scan.tos, r_ref.tos
    )
    print("  scan vs host-loop reference (bit-exact: %s)" % same)
    print(f"    backends   : scan {cfg.backend}  vs  reference "
          f"{ref_cfg.backend}")
    print(f"    host syncs : scan {r_scan.host_syncs}  vs  "
          f"reference {r_ref.host_syncs}")
    print(f"    us/event   : scan {t_scan / n * 1e6:.2f}  vs  "
          f"reference {t_ref / n * 1e6:.2f}  "
          f"({t_ref / max(t_scan, 1e-12):.1f}x)")
    return dict(bit_exact=bool(same), backend_scan=cfg.backend,
                backend_reference=ref_cfg.backend,
                host_syncs_scan=r_scan.host_syncs,
                host_syncs_reference=r_ref.host_syncs,
                us_per_event_scan=t_scan / n * 1e6,
                us_per_event_reference=t_ref / n * 1e6)


def demo_streaming(stream, device="cuda") -> dict:
    """The serving layers, each held to the batch scan (or a ``rebucket``
    replay).  Prints the reference's lines and returns their six flags:
    ``session``, ``device_slab_feed``, ``ring_pool``, ``bucketed_pool``,
    ``adaptive_migration`` (bit-exact) and ``ladder_premium_held``."""
    cfg = pipeline.PipelineConfig(
        chunk=512, lut_every_chunks=2, dvfs=True, dvfs_online=True,
        device=device,
    )
    batch = pipeline.run_pipeline(stream.xy, stream.ts, cfg)
    flags = {}

    # 1) One live session, arbitrary uneven slabs + flush.
    det = StreamingDetector(cfg)
    rng = np.random.default_rng(0)
    parts, i = [], 0
    t0 = time.perf_counter()
    while i < len(stream):
        n = int(rng.integers(64, 1500))
        parts.append(det.feed(stream.xy[i:i + n], stream.ts[i:i + n])[0])
        i += n
    parts.append(det.flush()[0])
    dt = time.perf_counter() - t0
    flags["session"] = np.array_equal(np.concatenate(parts), batch.scores)
    print("  streaming session (online DVFS): bit-exact vs batch scan:",
          flags["session"], f" ({len(stream) / dt / 1e3:.0f} kev/s)")

    # 2) Prefetching loader feeding device-resident chunks directly.
    base = session_base_us(int(stream.ts[0]), cfg)
    det2 = StreamingDetector(cfg, base_ts=base)
    parts2 = []
    with stream_mod.PrefetchingLoader(
        stream, cfg.chunk, device_slabs=True, rebase_us=base, device=device
    ) as loader:
        for xy, ts, valid in loader:
            parts2.append(det2.feed_device_chunk(xy, ts, valid)[0])
    flags["device_slab_feed"] = np.array_equal(np.concatenate(parts2),
                                               batch.scores)
    print("  device-slab prefetch feed:       bit-exact vs batch scan:",
          flags["device_slab_feed"])

    # 3) Pool: this camera + a second one behind the ring-buffered
    #    executor, one fetch per drain on the async reader, compact
    #    readout (kept-corner records; overflowing slots fall back dense).
    other = synthetic.dynamic_stream(duration_us=30_000, seed=9)
    pool = DetectorPool(cfg, capacity=2, ring_rounds=4, readout="compact")
    a, b = pool.connect(seed=cfg.seed), pool.connect(seed=cfg.seed)
    pool.feed(a, stream.xy, stream.ts)
    pool.feed(b, other.xy, other.ts)
    pool.pump()
    sa, _ = pool.flush(a)
    pool.flush(b)
    ps = pool.pool_stats()
    flags["ring_pool"] = np.array_equal(sa, batch.scores)
    print("  2-camera ring pool lane:         bit-exact vs batch scan:",
          flags["ring_pool"],
          f" ({ps['rounds_executed']} rounds / {ps['host_fetches']} fetches"
          f" on the {ps['drain_mode']} reader,"
          f" executables: {pool.compile_cache_size()})")
    print(f"  compact readout D2H diet:        {ps['d2h_bytes']} B fetched,"
          f" {ps['d2h_bytes_saved']} B saved vs dense slabs"
          f" ({ps['d2h_compact_overflow_slots']} slot(s) fell back dense)")
    pool.close()

    # 4) Chunk-size buckets: a second sensor serves at its own chunk size.
    pool2 = DetectorPool(cfg, capacity=2, ring_rounds=4,
                         buckets=(256, cfg.chunk))
    big = pool2.connect(seed=cfg.seed)                 # cfg.chunk bucket
    small = pool2.connect(seed=cfg.seed, chunk=256)    # 256 bucket
    pool2.feed(big, stream.xy, stream.ts)
    pool2.feed(small, other.xy, other.ts)
    pool2.pump()
    s_big, _ = pool2.flush(big)
    s_small, _ = pool2.flush(small)
    ref_small = pipeline.run_pipeline(
        other.xy, other.ts, dataclasses.replace(cfg, chunk=256))
    flags["bucketed_pool"] = (np.array_equal(s_big, batch.scores)
                              and np.array_equal(s_small, ref_small.scores))
    print("  bucketed pool (chunk 512+256):   bit-exact per bucket:",
          flags["bucketed_pool"],
          f" (executors per bucket: {pool2.compile_cache_sizes()})")
    pool2.close()

    # 5) Adaptive control plane: a lane connected in the small bucket whose
    #    measured rate outgrows it is live-migrated to the fitting bucket,
    #    bit-exact against a StreamingDetector rebucketed at the same event
    #    boundary.
    half = cfg.dvfs_cfg.half_us
    ramp = synthetic.ramp_stream([100] * 4 + [500] * 8, half, seed=3,
                                 height=cfg.height, width=cfg.width)
    rxy, rts = ramp.xy, ramp.ts                   # ~100 -> ~500 ev/half-win
    pool3 = DetectorPool(cfg, capacity=1, ring_rounds=4,
                         buckets=(128, 512), policy="adaptive",
                         migrate_patience=2)
    lane = pool3.connect(seed=cfg.seed, chunk=128)
    outs = []
    for j in range(int(rts[-1]) // half + 1):
        m = (rts // half) == j
        pool3.feed(lane, rxy[m], rts[m])
        pool3.pump()
        outs.append(pool3.poll(lane)[0])
    outs.append(pool3.flush(lane)[0])
    st = pool3.stats(lane)
    det3 = StreamingDetector(cfg, chunk=128, seed=cfg.seed)
    replay, cur = [], 0
    for m_ev, _frm, to in st["migration_log"]:
        replay.append(det3.feed(rxy[cur:m_ev], rts[cur:m_ev])[0])
        det3.rebucket(to)
        cur = m_ev
    replay.append(det3.feed(rxy[cur:], rts[cur:])[0])
    replay.append(det3.flush()[0])
    flags["adaptive_migration"] = np.array_equal(np.concatenate(outs),
                                                 np.concatenate(replay))
    print("  adaptive migration (128->512):   bit-exact vs rebucket replay:",
          flags["adaptive_migration"],
          f" (migrations {st['migration_log']},"
          f" rate est {st['events_per_s_est'] / 1e3:.0f} kev/s,"
          f" executables: {pool3.compile_cache_sizes()})")
    pool3.close()

    # 6) Overload ladder: a flash crowd doubles both lanes' arrival rate;
    #    the ladder degrades the standard lane tier by tier while the
    #    premium lane keeps full quality, with no recompile (the knobs are
    #    DetectorState.ctrl data).
    n_win = 12
    burst = [synthetic.burst_stream(2 * 128, n_win, half, burst_factor=2.0,
                                    seed=11 + s, height=cfg.height,
                                    width=cfg.width) for s in range(2)]
    pool4 = DetectorPool(cfg, capacity=2, ring_rounds=2, buckets=(128,),
                         policy="ladder",
                         ladder=LadderConfig(patience=1, recover_patience=2))
    std = pool4.connect(seed=cfg.seed, chunk=128, qos="standard")
    prm = pool4.connect(seed=cfg.seed, chunk=128, qos="premium")
    peak = 0
    for j in range(n_win):
        for lane, st4 in ((std, burst[0]), (prm, burst[1])):
            m = (st4.ts // half) == j
            pool4.feed(lane, st4.xy[m], st4.ts[m])
        pool4.pump()
        pool4.poll(std), pool4.poll(prm)
        peak = max(peak, pool4.pool_stats()["ladder_level"])
    ps4 = pool4.pool_stats()
    s_std, s_prm = pool4.stats(std), pool4.stats(prm)
    flags["ladder_premium_held"] = (
        s_prm["ctrl_lut_every"] == cfg.lut_every_chunks
        and s_prm["ladder_tier"] == 0)
    print("  overload ladder (2x burst):      premium held full cadence:",
          flags["ladder_premium_held"],
          f" (peak level {peak}/{ps4['ladder_max_level']},"
          f" standard tier {s_std['ladder_tier']},"
          f" {ps4['ladder_transitions']} transitions,"
          f" {ps4['shed_events_total']} shed,"
          f" executables: {pool4.compile_cache_sizes()})")
    pool4.close()
    return {k: bool(v) for k, v in flags.items()}


def main(device: str = "cuda", duration_us: int = 80_000) -> dict:
    """Run the demo on ``device`` over streams of ``duration_us`` (the
    reference's 80 ms unless cut) and return, per dataset, the printed
    values: ``n_events``, ``auc_errorfree`` / ``auc_low`` and their
    energies (uJ), ``dauc``, ``energy_ratio``, ``dvfs_mean_vdd``,
    ``dvfs_energy_uj``, ``scan_vs_reference`` (``compare_scan_vs_
    reference``'s dict) and ``flags`` (``demo_streaming``'s six)."""
    out = {}
    for name, gen, seed in (("shapes_dof", synthetic.shapes_stream, 0),
                            ("dynamic_dof", synthetic.dynamic_stream, 1)):
        stream = gen(duration_us=duration_us, seed=seed)
        base = run(stream, vdd=1.2, inject=False, device=device)
        low = run(stream, vdd=0.6, inject=True, device=device)
        auto = run(stream, vdd=1.2, inject=True, use_dvfs=True,
                   device=device)

        ok = np.isfinite(base.scores) & np.isfinite(low.scores)
        auc0 = pr_eval.pr_auc(base.scores[ok], stream.is_corner[ok])
        auc1 = pr_eval.pr_auc(low.scores[ok], stream.is_corner[ok])
        ratio = base.energy_pj / max(low.energy_pj, 1e-9)
        print(f"[{name}] events={len(stream)}")
        print(f"  AUC @1.2V error-free : {auc0:.3f}   energy "
              f"{base.energy_pj/1e6:.2f} uJ")
        print(f"  AUC @0.6V BER=2.5%   : {auc1:.3f}   energy "
              f"{low.energy_pj/1e6:.2f} uJ"
              f"   (dAUC {auc0-auc1:+.3f}, energy x{ratio:.1f} less)")
        print(f"  DVFS run: mean Vdd {auto.vdd_trace.mean():.2f} V, "
              f"energy {auto.energy_pj/1e6:.2f} uJ")
        out[name] = dict(
            n_events=len(stream), auc_errorfree=float(auc0),
            energy_uj_errorfree=base.energy_pj / 1e6, auc_low=float(auc1),
            energy_uj_low=low.energy_pj / 1e6, dauc=float(auc0 - auc1),
            energy_ratio=ratio,
            dvfs_mean_vdd=float(auto.vdd_trace.mean()),
            dvfs_energy_uj=auto.energy_pj / 1e6,
            scan_vs_reference=compare_scan_vs_reference(stream, device),
            flags=demo_streaming(stream, device))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    main(ap.parse_args().device)
