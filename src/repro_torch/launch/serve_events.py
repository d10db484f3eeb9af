"""Event-camera serving CLI: a DetectorPool under synthetic live traffic.

    PYTHONPATH=src python -m repro_torch.launch.serve_events --sessions 4 \
        --duration-us 40000 --slab 400 --dvfs --ring-rounds 8 \
        --drain-mode async --policy adaptive --buckets 64,256,1024 \
        --connect-chunk 64

The port of ``repro.launch.serve_events``, with the same flags, loop, log
lines and report.  It spins up a ``DetectorPool`` on the card (``--device
cuda``, the default; its lanes sharded over every local card where there
is more than one; ``--device cpu`` runs the plain versions), connects
``--sessions`` synthetic cameras with staggered joins, feeds their streams
in fixed-size slabs round-robin, and reports aggregate throughput,
per-round latency percentiles, and the ring runtime counters (host fetches
per round, buffered/dropped rounds, pump drain wait).

``--drain-mode`` picks the readout runtime: ``async`` (default) seals a
full ring and lets a reader thread fetch it while the pump keeps stepping
rounds into a spare (``--ring-depth`` rings per bucket); ``sync`` blocks
the pump on every fetch.  ``--readout`` picks what a drain fetches:
``dense`` result slabs or ``compact`` kept-corner records (K3; overflowing
slots fall back to their dense rows).  Results are identical in every
combination.

``--policy`` picks the control plane: ``static`` (a lane stays in the
bucket chosen at connect, ``--connect-chunk`` rounded up to a
``--buckets`` tier), ``adaptive`` (live bucket migration from the measured
events per half-window, after ``--migrate-patience`` drains), ``ladder``
(QoS-ordered degradation under backlog pressure: stretch the LUT refresh,
lower the DVFS ceiling, shed, then pack; ``--qos standard,premium`` and
``--burst-factor 2`` show it) or ``pack`` (fleet packing that cuts padded
H2D uploads).  A migrated lane's state stays on the card; no move
recompiles an executor.

``--pipeline-depth`` sizes the pump's stage-ahead window (1 = the serial
pump).  ``--backend`` is one of the port's ``pipeline.BACKENDS``:
``fused`` (K1, the default), ``nmc`` (K4), ``batched`` (K5) or ``torch``
(plain).  Backpressure, migrations and ladder moves are logged as they
happen (``[backpressure]``, ``[migration]``, ``[ladder]``); the final
report prints the pool's counters, one metrics emission through a
``LogSink`` (plus ``--metrics-out`` JSONL), each lane's last stats and the
executors' block shapes.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import obs as obs_mod
from repro_torch.core import pipeline
from repro_torch.events import synthetic
from repro_torch.serve import DetectorPool

# The console rendering of a metrics emission: the pipeline/coalescing/
# pack summary keys, rendered by a LogSink from the same record the JSONL
# trail gets.
_SUMMARY_FIELDS = (
    "pump_stages", "pump_stage_s", "pump_stage_hidden_s",
    "pump_stage_overlap", "ctrl_batched_writes", "ctrl_actions_coalesced",
    "observation_rebuilds", "observation_reuses", "h2d_event_slots",
    "h2d_valid_events", "migrations_total",
)


def _attach_sinks(pool, metrics_out):
    """Wire the CLI's sinks onto the pool registry: a console summary
    LogSink (always) plus a JSONL trail when ``--metrics-out`` is given,
    fanned out through one CompositeSink so a broken file sink cannot take
    the console report down with it."""
    sinks = [obs_mod.LogSink(write=lambda s: print("  " + s),
                             fields=_SUMMARY_FIELDS)]
    jsonl = None
    if metrics_out:
        jsonl = obs_mod.JsonlSink(metrics_out)
        sinks.append(jsonl)
    composite = obs_mod.CompositeSink(sinks)
    pool.metrics.attach(composite)
    return jsonl


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--sessions", type=int, default=4)
    ap.add_argument("--duration-us", type=int, default=40_000)
    ap.add_argument("--chunk", type=int, default=256)
    ap.add_argument("--slab", type=int, default=400,
                    help="events per arriving slab")
    ap.add_argument("--ring-rounds", type=int, default=8,
                    help="K: rounds per executor block / ring capacity")
    ap.add_argument("--ring-depth", type=int, default=2,
                    help="device rings per bucket in async mode (2 = a "
                         "double buffer; deeper absorbs longer fetch "
                         "stalls)")
    ap.add_argument("--overflow", default="drain",
                    choices=("drain", "drop_oldest"),
                    help="ring overflow policy (drain=lossless backpressure)")
    ap.add_argument("--drain-mode", default="async",
                    choices=("async", "sync"),
                    help="async: reader thread fetches sealed rings off the "
                         "pump thread; sync: drains block the caller")
    ap.add_argument("--readout", default="dense",
                    choices=("dense", "compact"),
                    help="ring readout representation: dense fetches whole "
                         "(rounds, lanes, chunk) result slabs; compact "
                         "fetches kept-corner records (~chunk/cap fewer "
                         "D2H bytes per drain, dense-row fallback on "
                         "overflow; results identical either way)")
    ap.add_argument("--compact-cap", type=int, default=None,
                    help="kept-corner records per ring slot under "
                         "--readout compact (default: chunk // 8)")
    ap.add_argument("--policy", default="static",
                    choices=("static", "adaptive", "ladder", "pack"),
                    help="control plane: static=placement for life; "
                         "adaptive=rate-aware live bucket migration; "
                         "ladder=QoS-ordered overload degradation "
                         "(observe->decide->actuate per pump pass); "
                         "pack=fleet-wide lane packing that migrates "
                         "sparse buckets' lanes together to minimize "
                         "padded H2D upload bytes")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="pump stage-ahead window: blocks staged (host "
                         "gather + H2D upload) while earlier blocks run "
                         "on the device; 1 = the serial pump (identical "
                         "results either way)")
    ap.add_argument("--qos", default="standard",
                    help="comma-separated QoS classes assigned to sessions "
                         "round-robin (ladder policy: classes listed first "
                         "in the ladder config degrade first; e.g. "
                         "'standard,premium')")
    ap.add_argument("--burst-factor", type=float, default=None,
                    help="drive traffic with a flash-crowd burst_stream at "
                         "this overload factor instead of shapes_stream "
                         "(the ladder demo shape)")
    ap.add_argument("--buckets", default=None,
                    help="comma-separated chunk-size buckets "
                         "(e.g. 64,256,1024); default: just --chunk")
    ap.add_argument("--connect-chunk", type=int, default=None,
                    help="per-session chunk request at connect (rounded up "
                         "to a bucket); default: --chunk")
    ap.add_argument("--migrate-patience", type=int, default=3,
                    help="consecutive drains past the hysteresis threshold "
                         "before an adaptive migration commits")
    ap.add_argument("--metrics-out", default=None, metavar="PATH.jsonl",
                    help="append every metrics emission (periodic + final) "
                         "as one JSON record per line to this file")
    ap.add_argument("--metrics-interval", type=int, default=25,
                    help="serving rounds between periodic metrics "
                         "emissions (0 disables the periodic emits; the "
                         "final emission always happens)")
    ap.add_argument("--dvfs", action="store_true",
                    help="online (in-step) DVFS instead of fixed 1.2 V")
    ap.add_argument("--backend", default="fused",
                    choices=pipeline.BACKENDS)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pool (cuda, or cpu for the "
                         "plain versions)")
    args = ap.parse_args(argv)

    cfg = pipeline.PipelineConfig(
        chunk=args.chunk, lut_every_chunks=2, backend=args.backend,
        dvfs=args.dvfs, dvfs_online=args.dvfs, device=args.device,
    )
    buckets = (
        tuple(int(b) for b in args.buckets.split(","))
        if args.buckets else None
    )
    if args.burst_factor is not None:
        half = cfg.dvfs_cfg.half_us
        n_win = max(4, args.duration_us // half)
        streams = [
            synthetic.burst_stream(
                2 * args.chunk, n_win, half,
                burst_factor=args.burst_factor, seed=s,
            )
            for s in range(args.sessions)
        ]
    else:
        streams = [
            synthetic.shapes_stream(duration_us=args.duration_us, seed=s)
            for s in range(args.sessions)
        ]
    qos_cycle = [q.strip() for q in args.qos.split(",") if q.strip()]
    pool = DetectorPool(cfg, capacity=args.sessions,
                        ring_rounds=args.ring_rounds,
                        ring_depth=args.ring_depth,
                        buckets=buckets,
                        on_overflow=args.overflow,
                        drain_mode=args.drain_mode,
                        readout=args.readout,
                        compact_cap=args.compact_cap,
                        policy=args.policy,
                        pipeline_depth=args.pipeline_depth,
                        migrate_patience=args.migrate_patience)
    ps = pool.pool_stats()
    print(f"pool: capacity {args.sessions}, ring_rounds {args.ring_rounds} "
          f"x depth {ps['ring_depth']} "
          f"({args.overflow}, drain_mode={args.drain_mode}, "
          f"readout={ps['readout']}, "
          f"policy={ps['policy']}, buckets={pool.buckets}), "
          f"sharded={ps['sharded']} over {ps['devices']} device(s)")

    # Run both executor shapes (K-block + 1-round) outside the timed loop.
    pool.warmup(streams[0].xy, streams[0].ts)
    ps0 = pool.pool_stats()              # baselines: exclude warmup work
    drains0 = ps0["pump_forced_drains"]
    drain_wait0 = ps0["pump_drain_wait_s"]
    # sinks attach after warmup so the trail starts at the serving loop
    jsonl = _attach_sinks(pool, args.metrics_out)

    serve_rounds = 0
    lanes, cursors = {}, {}
    lat_ms, done = [], 0
    dropped_seen = 0
    drains_seen = drains0
    migrations_seen = 0
    ladder_level_seen = 0
    transitions_seen = 0
    final_lane_stats = []
    n_total = sum(len(s) for s in streams)
    t0 = time.perf_counter()
    while done < args.sessions:
        # staggered joins: one new camera per round until all are live
        if len(cursors) < args.sessions:
            i = len(cursors)
            lanes[i] = pool.connect(seed=i, chunk=args.connect_chunk,
                                    qos=qos_cycle[i % len(qos_cycle)])
            cursors[i] = 0
        # sample counters outside the timed window: pool_stats walks every
        # lane and executor, and that cost must not inflate the reported
        # round latency percentiles
        drains_before = pool.pool_stats()["pump_forced_drains"]
        t1 = time.perf_counter()
        for i, lane in list(lanes.items()):
            st, c = streams[i], cursors[i]
            if c >= len(st):
                pool.flush(lane)
                final_lane_stats.append(pool.disconnect(lane))
                del lanes[i]
                done += 1
                continue
            pool.feed(lane, st.xy[c:c + args.slab], st.ts[c:c + args.slab])
            cursors[i] = c + args.slab
        pool.pump()
        for lane in lanes.values():
            pool.poll(lane)
        lat_ms.append((time.perf_counter() - t1) * 1e3)
        serve_rounds += 1
        if args.metrics_interval > 0 and \
                serve_rounds % args.metrics_interval == 0:
            pool.emit_metrics("periodic")
        ps = pool.pool_stats()
        # mid-pump makes-room events are counted by the pool itself
        # (host_fetches deltas are racy in async mode: the reader counts a
        # fetch when the transfer completes, not when the pump seals); the
        # delta here also covers drains forced inside flush()
        if ps["pump_forced_drains"] > drains_before:
            if drains_seen == drains0:
                print("  [backpressure] ring full mid-pump: draining early "
                      "(lossless; fetch cadence rises under this load)")
            drains_seen = ps["pump_forced_drains"]
        # migration: log each applied move
        if ps["migrations_total"] > migrations_seen:
            print(f"  [migration] {ps['migrations_total'] - migrations_seen}"
                  f" lane(s) re-bucketed (total "
                  f"{ps['migrations_total']}; zero recompiles)")
            migrations_seen = ps["migrations_total"]
        # ladder: log level moves and actuated tier transitions
        lvl = ps.get("ladder_level", 0)
        if lvl != ladder_level_seen:
            word = "climbed" if lvl > ladder_level_seen else "descended"
            print(f"  [ladder] level {word} {ladder_level_seen} -> {lvl} "
                  f"(max {ps['ladder_max_level']}; degrade quality, "
                  f"never latency)")
            ladder_level_seen = lvl
        if ps.get("ladder_transitions", 0) > transitions_seen:
            print(f"  [ladder] {ps['ladder_transitions'] - transitions_seen}"
                  f" lane tier transition(s) actuated (total "
                  f"{ps['ladder_transitions']}; knob writes, no recompile)")
            transitions_seen = ps["ladder_transitions"]
        # backpressure: log drops instead of silently losing rounds
        if ps["dropped_rounds_total"] > dropped_seen:
            print(f"  [backpressure] ring dropped "
                  f"{ps['dropped_rounds_total'] - dropped_seen} round(s) "
                  f"(total {ps['dropped_rounds_total']}) — pollers lagging")
            dropped_seen = ps["dropped_rounds_total"]
    dt = time.perf_counter() - t0

    lat = np.asarray(lat_ms)
    ps = pool.pool_stats()
    forced_drains = ps["pump_forced_drains"] - drains0
    print(f"served {args.sessions} sessions / {n_total} events in {dt:.2f}s "
          f"({n_total / dt / 1e3:.1f} kev/s aggregate)")
    print(f"round latency ms: p50 {np.percentile(lat, 50):.2f}  "
          f"p99 {np.percentile(lat, 99):.2f}  max {lat.max():.2f}")
    print(f"ring: {ps['rounds_executed']} rounds / {ps['host_fetches']} "
          f"host fetches "
          f"({ps['rounds_executed'] / max(ps['host_fetches'], 1):.1f} "
          f"rounds per blocking transfer), "
          f"{forced_drains} forced mid-pump drains, "
          f"{ps['dropped_rounds_total']} dropped")
    print(f"pump drain wait: "
          f"{(ps['pump_drain_wait_s'] - drain_wait0) * 1e3:.2f} ms total "
          f"({args.drain_mode}; async seals swap buffers instead of "
          f"fetching), reader lag {ps['reader_lag_rounds']} round(s)")
    d2h = ps["d2h_bytes"]
    print(f"d2h readout ({ps['readout']}): {d2h / 1e6:.3f} MB fetched over "
          f"{ps['host_fetches']} fetch(es), "
          f"{ps['d2h_bytes_saved'] / 1e6:.3f} MB saved vs dense, "
          f"{ps['d2h_compact_overflow_slots']} overflow slot(s) "
          f"fell back to dense rows")
    pad = ps["h2d_padding_bytes"]
    print(f"h2d padding: {pad / 1e6:.3f} MB over "
          f"{ps['h2d_event_slots']} uploaded slots "
          f"({ps['h2d_valid_events']} valid events) — "
          f"{ps['migrations_total']} migration(s), policy={ps['policy']}")
    # pipeline/coalescing/pack summary: one registry emission rendered by
    # the attached sinks (console LogSink + optional JSONL trail); the
    # scheduler's counters ride in record["scheduler"]
    print(f"pump pipeline (depth {ps['pipeline_depth']}) final emission:")
    pool.emit_metrics("final")
    if args.policy == "ladder":
        print(f"ladder: level {ps['ladder_level']}/{ps['ladder_max_level']} "
              f"at exit, {ps['ladder_transitions']} tier transition(s), "
              f"{ps['shed_events_total']} event(s) shed")
    for st in final_lane_stats:
        print(f"  lane {st['lane']}: bucket {st['bucket']}, "
              f"qos {st['qos']} (tier {st['ladder_tier']}), "
              f"rate est {st['events_per_s_est'] / 1e3:.1f} kev/s "
              f"(device est {st['device_events_per_s_est'] / 1e3:.1f}), "
              f"{st['migrations']} migration(s) {st['migration_log']}")
    print(f"compiled executors: {pool.compile_cache_sizes()} "
          f"(membership churn and migration must not recompile)")
    if jsonl is not None:
        jsonl.close()
        print(f"metrics trail: {args.metrics_out}")
    pool.close()
    return dt, lat


if __name__ == "__main__":
    main()
