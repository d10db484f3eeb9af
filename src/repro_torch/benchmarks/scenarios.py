"""Fleet replay scenarios: end-to-end SLO rows through the metrics sinks.

    PYTHONPATH=src python -m repro_torch.benchmarks.scenarios [--smoke] \
        [--device cpu] [--jsonl-out PATH.jsonl] [--only NAME ...]

The port of the reference's ``benchmarks/scenarios.py``, with its
scenarios, sizes, row names and record shape.  Each scenario replays a
multi-camera fleet pattern against a ``DetectorPool`` on ``device`` (the
card unless the caller asks for ``cpu``) and reports its service-level
objectives as ``scenario_<name>_slo_*`` rows: per-round p99 latency,
drop/shed rate, migrations, padding ratio, measured through the
``repro_torch.obs`` registry (a ``Histogram`` over serving rounds plus the
pool's own counters) and emitted as one ``slo`` record through the sinks
(``LogSink`` to stderr; ``--jsonl-out`` adds a JSONL trail).

  diurnal     — traffic ramps up then back down; the adaptive policy must
                migrate lanes up-bucket on the rise with no drops.
  flash_crowd — 2x burst against ``policy="ladder"``: tier transitions
                must fire, shed stays bounded.
  hetero_mix  — busy small-chunk lanes + 2 sparse big-chunk lanes;
                ``policy="pack"`` must move lanes and cut padded H2D bytes
                against the never-packed placement.
  flapping    — one session reconnects every other window; membership
                churn must not add executor shapes or drop rounds.
  low_vdd     — every lane at Vdd=0.61 V with BER injection (the paper's
                0.60-0.62 V regime): the fleet keeps serving.

Every row but the ``p99`` ones is a count or a ratio of counts, fixed by
the sizes and the seed.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch import obs
from repro_torch.core import pipeline
from repro_torch.events import synthetic
from repro_torch.serve import DetectorPool
from repro_torch.serve.scheduler import LadderConfig

SEED = 7          # pinned, matches bench_streaming for comparability
SCENARIOS = ("diurnal", "flash_crowd", "hetero_mix", "flapping", "low_vdd")


def _registry(name: str, sinks):
    reg = obs.MetricsRegistry(namespace=f"scenario.{name}")
    if sinks:
        reg.attach(sinks)
    return reg


def _serve_windows(pool, lanes, streams, n_windows, half, hist,
                   on_window=None):
    """The common serving loop: one window per round, latency observed
    into ``hist`` through the one wall clock (``obs.timer``)."""
    for j in range(n_windows):
        t1 = obs.timer()
        for i, lane in list(lanes.items()):
            st = streams[i]
            m = (st.ts // half) == j
            pool.feed(lane, st.xy[m], st.ts[m])
        pool.pump()
        for lane in lanes.values():
            pool.poll(lane)
        hist.observe(obs.timer() - t1)
        if on_window is not None:
            on_window(j)


def _slo_record(reg, name, hist, slo: dict) -> dict:
    """Bind the scenario's SLO values to gauges and emit one record."""
    for k, v in slo.items():
        reg.gauge(f"slo_{k}", f"{name}: {k}").set(v)
    reg.emit("slo", extra={"scenario": name})
    return slo


def scenario_diurnal(sinks, *, smoke: bool, device: str = "cuda"):
    """Day-cycle ramp: low -> high -> low; adaptive migration both ways."""
    k = 2 if smoke else 4
    rates = ([100] * 3 + [512] * 6 + [100] * 3) if smoke \
        else ([100] * 5 + [512] * 10 + [100] * 6)
    cfg = pipeline.PipelineConfig(chunk=256, lut_every_chunks=2,
                                  device=device)
    half = cfg.dvfs_cfg.half_us
    reg = _registry("diurnal", sinks)
    hist = reg.histogram("round_latency_s", "wall seconds per serving round")
    streams = [synthetic.ramp_stream(rates, half, seed=SEED + s)
               for s in range(k)]
    pool = DetectorPool(cfg, capacity=k, ring_rounds=8, buckets=(128, 512),
                        policy="adaptive", migrate_patience=2)
    lanes = {i: pool.connect(seed=SEED + i, chunk=128) for i in range(k)}
    _serve_windows(pool, lanes, streams, len(rates), half, hist)
    ps = pool.pool_stats()
    assert pool.executors_compiled_once(), pool.compile_cache_sizes()
    pool.close()
    return _slo_record(reg, "diurnal", hist, {
        "p99_round_ms": hist.percentile(99) * 1e3,
        "migrations": float(ps["migrations_total"]),
        "drop_rate": ps["dropped_rounds_total"] / max(ps["rounds_executed"], 1),
        "padding_ratio": 1.0 - ps["h2d_valid_events"] / max(ps["h2d_event_slots"], 1),
    })


def scenario_flash_crowd(sinks, *, smoke: bool, device: str = "cuda"):
    """2x flash crowd against the degradation ladder."""
    k = 2 if smoke else 4
    n_windows = 12 if smoke else 24
    cfg = pipeline.PipelineConfig(chunk=256, lut_every_chunks=2,
                                  device=device)
    half = cfg.dvfs_cfg.half_us
    ring = 4
    base = ring * cfg.chunk
    reg = _registry("flash_crowd", sinks)
    hist = reg.histogram("round_latency_s", "wall seconds per serving round")
    streams = [
        synthetic.burst_stream(base, n_windows, half, burst_start=4,
                               burst_len=n_windows - 8, burst_factor=2.0,
                               seed=SEED + s)
        for s in range(k)
    ]
    pool = DetectorPool(cfg, capacity=k, ring_rounds=ring,
                        buckets=(cfg.chunk,), policy="ladder",
                        ladder=LadderConfig(patience=1, recover_patience=2))
    pool.warmup(streams[0].xy, streams[0].ts)
    lanes = {i: pool.connect(seed=SEED + i,
                             qos="premium" if i == 0 and k > 1 else "standard")
             for i in range(k)}
    _serve_windows(pool, lanes, streams, n_windows, half, hist)
    ps = pool.pool_stats()
    n_total = sum(len(s) for s in streams)
    assert pool.executors_compiled_once(), pool.compile_cache_sizes()
    pool.close()
    return _slo_record(reg, "flash_crowd", hist, {
        "p99_round_ms": hist.percentile(99) * 1e3,
        "transitions": float(ps["ladder_transitions"]),
        "shed_rate": ps["shed_events_total"] / max(n_total, 1),
        "drop_rate": ps["dropped_rounds_total"] / max(ps["rounds_executed"], 1),
    })


def scenario_hetero_mix(sinks, *, smoke: bool, device: str = "cuda"):
    """Heterogeneous fleet: busy 128-chunk lanes + 2 sparse 512-chunk
    lanes; packing must cut padded upload bytes vs static placement."""
    k = 2 if smoke else 4
    n_windows = 8 if smoke else 14
    cfg = pipeline.PipelineConfig(chunk=256, lut_every_chunks=2,
                                  device=device)
    half = cfg.dvfs_cfg.half_us
    reg = _registry("hetero_mix", sinks)
    hist = reg.histogram("round_latency_s", "wall seconds per serving round")
    busy = [synthetic.ramp_stream([512] * n_windows, half, seed=SEED + s)
            for s in range(k)]
    sparse = [synthetic.ramp_stream([100] * n_windows, half,
                                    seed=SEED + 64 + s) for s in range(2)]
    streams = busy + sparse

    def serve(policy, h):
        pool = DetectorPool(cfg, capacity=k + 2, ring_rounds=4,
                            buckets=(128, 512), policy=policy,
                            migrate_patience=2, pipeline_depth=2)
        lanes = {i: pool.connect(seed=SEED + i, chunk=128)
                 for i in range(k)}
        lanes.update({k + i: pool.connect(seed=SEED + 64 + i, chunk=512)
                      for i in range(2)})
        _serve_windows(pool, lanes, streams, n_windows, half, h)
        ps = pool.pool_stats()
        assert pool.executors_compiled_once(), pool.compile_cache_sizes()
        pool.close()
        return ps

    ref_hist = obs.MetricsRegistry(namespace="scenario.hetero_mix.ref") \
        .histogram("round_latency_s", "static reference")
    ps_static = serve("static", ref_hist)
    ps_packed = serve("pack", hist)
    return _slo_record(reg, "hetero_mix", hist, {
        "p99_round_ms": hist.percentile(99) * 1e3,
        "pack_moves": float(ps_packed.get("pack_moves", 0)),
        "padding_saved_ratio":
            1.0 - ps_packed["h2d_padding_bytes"]
            / max(ps_static["h2d_padding_bytes"], 1),
        "drop_rate": ps_packed["dropped_rounds_total"]
            / max(ps_packed["rounds_executed"], 1),
    })


def scenario_flapping(sinks, *, smoke: bool, device: str = "cuda"):
    """Connect/disconnect churn: one lane flaps every other window;
    membership is data, so executors must stay compiled-once and no
    rounds may drop."""
    k = 2 if smoke else 4
    n_windows = 10 if smoke else 20
    cfg = pipeline.PipelineConfig(chunk=256, lut_every_chunks=2,
                                  device=device)
    half = cfg.dvfs_cfg.half_us
    reg = _registry("flapping", sinks)
    hist = reg.histogram("round_latency_s", "wall seconds per serving round")
    rates = [256] * n_windows
    streams = [synthetic.ramp_stream(rates, half, seed=SEED + s)
               for s in range(k)]
    pool = DetectorPool(cfg, capacity=k, ring_rounds=8,
                        buckets=(cfg.chunk,))
    pool.warmup(streams[0].xy, streams[0].ts)
    lanes = {i: pool.connect(seed=SEED + i) for i in range(k)}
    flaps = 0

    def flap(j):
        nonlocal flaps
        if j % 2 == 1:          # lane 0 flaps every other window
            pool.flush(lanes[0])
            pool.disconnect(lanes[0])
            lanes[0] = pool.connect(seed=SEED + 100 + j)
            flaps += 1

    _serve_windows(pool, lanes, streams, n_windows, half, hist,
                   on_window=flap)
    ps = pool.pool_stats()
    compiled_once = pool.executors_compiled_once()
    assert compiled_once, pool.compile_cache_sizes()
    pool.close()
    return _slo_record(reg, "flapping", hist, {
        "p99_round_ms": hist.percentile(99) * 1e3,
        "flaps": float(flaps),
        "compile_once": 1.0 if compiled_once else 0.0,
        "drop_rate": ps["dropped_rounds_total"] / max(ps["rounds_executed"], 1),
    })


def scenario_low_vdd(sinks, *, smoke: bool, device: str = "cuda"):
    """Near-threshold fleet: every lane's detector runs at Vdd=0.61V with
    BER injection on (the paper's 0.60-0.62V regime).  The SLO is
    liveness at the operating point: rounds keep completing, kept rate
    stays positive, nothing drops."""
    k = 2 if smoke else 4
    n_windows = 8 if smoke else 16
    cfg = pipeline.PipelineConfig(chunk=256, lut_every_chunks=2,
                                  vdd=0.61, inject_ber=True, device=device)
    half = cfg.dvfs_cfg.half_us
    reg = _registry("low_vdd", sinks)
    hist = reg.histogram("round_latency_s", "wall seconds per serving round")
    rates = [384] * n_windows
    streams = [synthetic.ramp_stream(rates, half, seed=SEED + s)
               for s in range(k)]
    pool = DetectorPool(cfg, capacity=k, ring_rounds=8,
                        buckets=(cfg.chunk,))
    lanes = {i: pool.connect(seed=SEED + i) for i in range(k)}
    _serve_windows(pool, lanes, streams, n_windows, half, hist)
    for lane in lanes.values():
        pool.flush(lane)
    kept = sum(pool.stats(lanes[i])["kept_total"] for i in range(k))
    n_ev = sum(pool.stats(lanes[i])["n_events"] for i in range(k))
    ps = pool.pool_stats()
    assert pool.executors_compiled_once(), pool.compile_cache_sizes()
    pool.close()
    return _slo_record(reg, "low_vdd", hist, {
        "p99_round_ms": hist.percentile(99) * 1e3,
        "kept_rate": kept / max(n_ev, 1),
        "drop_rate": ps["dropped_rounds_total"] / max(ps["rounds_executed"], 1),
        "rounds": float(ps["rounds_executed"]),
    })


_FNS = {
    "diurnal": scenario_diurnal,
    "flash_crowd": scenario_flash_crowd,
    "hetero_mix": scenario_hetero_mix,
    "flapping": scenario_flapping,
    "low_vdd": scenario_low_vdd,
}


def _mk_sinks(jsonl_out=None):
    sinks = [obs.LogSink(write=lambda s: print("# " + s, file=sys.stderr))]
    if jsonl_out:
        sinks.append(obs.JsonlSink(jsonl_out))
    return obs.CompositeSink(sinks)


def rows(smoke: bool = False, *, jsonl_out=None, only=None,
         device: str = "cuda"):
    """One ``scenario_<name>_slo_<key>`` row per SLO value.  All five
    scenarios run in smoke mode too; smoke only shrinks fleet sizes and
    window counts.  The pools run on ``device``."""
    sinks = _mk_sinks(jsonl_out)
    out = []
    names = tuple(only) if only else SCENARIOS
    for name in names:
        slo = _FNS[name](sinks, smoke=smoke, device=device)
        for key, v in sorted(slo.items()):
            out.append((f"scenario_{name}_slo_{key}", 0.0, float(v)))
    sinks.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--jsonl-out", default=None, metavar="PATH.jsonl")
    ap.add_argument("--only", nargs="*", choices=SCENARIOS, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu for the plain versions)")
    args = ap.parse_args(argv)
    print("name,us_per_call,derived")
    for name, us, derived in rows(smoke=args.smoke,
                                  jsonl_out=args.jsonl_out,
                                  only=args.only, device=args.device):
        print(f"{name},{us:.3f},{derived:.6g}")


if __name__ == "__main__":
    main()
