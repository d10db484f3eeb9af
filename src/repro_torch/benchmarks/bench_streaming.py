"""Serving-layer benchmark: slab latency and aggregate throughput of the
ring-buffered pool against the per-round path and the offline batch scan,
and of the async drain against the synchronous one.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--smoke] \
        [--device cpu]

The port of the reference's ``benchmarks/bench_streaming.py``, with its
row names and sizes (``POOL_SIZES`` 1/4/16, ``DURATION_US``, ``SLAB``,
``SEED``; smoke: pools of 1 and 2 at 6,000 us); the pools run on
``device`` (the card unless the caller asks for ``cpu``).  Rows per pool
size K:

  * ``poolK_slab_p50_ms`` / ``_p99_ms``, ``poolK_events_per_s`` and
    ``poolK_fetches_per_round`` — one serving round (feed a slab to every
    live session, pump, poll) on the per-round path (``ring_rounds=1``);
    the same on the ring path (``poolK_ring_*``, ``ring_rounds=8``, sync
    drain) and with the async drain (``poolK_ring_async_*``).
  * ``poolK_burst_rounds_per_fetch`` / ``poolK_ring_burst_rounds_per_fetch``
    — rounds per blocking transfer on a backlog burst (feed everything,
    pump once).
  * ``poolK_burst_drain_wait_{sync,async,compact}_ms`` — wall time the
    pump thread spent making ring room during a burst through a 2-round
    ring.
  * ``poolK_d2h_bytes_per_fetch_{dense,compact}`` / ``poolK_d2h_bytes_ratio``
    — result bytes per fetch on a sparse-corner fleet under each readout.
  * ``poolK_sharded_events_per_s`` — the ring path with ``shard=True``,
    its lanes sharded over every local device of ``device``'s type;
    recorded ``_skipped`` (derived 0) where there is only one.
  * ``poolK_migration_{count,padding_saved_ratio,padding_saved_mb,
    rounds_per_fetch}`` — the adaptive policy against the static one
    under a rate ramp from the small bucket.
  * ``poolK_pump_stage_overlap_ratio`` — share of a backlog pass's stage
    phases that ran with a block staged ahead and one dispatched.
  * ``poolK_pack_padding_saved_ratio`` / ``poolK_pack_moves`` —
    ``policy="pack"`` against the never-packed placement on a
    heterogeneous fleet.
  * ``poolK_overload_p99_{none,ladder}_ms`` /
    ``poolK_overload_ladder_transitions`` — a serving round's p99 under a
    2x flash crowd without and with ``policy="ladder"``.

plus ``batchK_events_per_s`` (``run_pipeline_batched``) and
``stream_fused_{H}x{W}_{fused,unfused}_events_per_s``: a
``StreamingDetector`` on ``fused`` (K1) against ``torch`` (plain) at
DAVIS240 and 720p, timed on a CUDA device only and recorded ``_skipped``
elsewhere.  The fetch, burst, D2H, migration, overlap, pack and
transition rows are counts or ratios of counts, fixed by the sizes and
the seed; the rest are wall time.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import pipeline
from repro_torch.events import synthetic
from repro_torch.launch.sharding import local_lane_mesh
from repro_torch.serve import DetectorPool
from repro_torch.serve.scheduler import LadderConfig
from repro_torch.serve.streaming import StreamingDetector

POOL_SIZES = (1, 4, 16)
DURATION_US = 25_000
SLAB = 384
SEED = 7                      # pinned: streams and any slab jitter
RING_ROUNDS = 8
DRAIN_WAIT_RING = 2           # small ring -> bursts must drain mid-pump
FUSED_SIZES = ((180, 240), (720, 1280))   # DAVIS240 + 720p


def _mk_streams(k: int, duration_us: int):
    return [
        synthetic.shapes_stream(duration_us=duration_us, seed=SEED + s)
        for s in range(k)
    ]


def _run_pool(cfg, streams, *, ring_rounds: int, drain_mode: str = "sync",
              shard="auto"):
    k = len(streams)
    pool = DetectorPool(cfg, capacity=k, ring_rounds=ring_rounds,
                        drain_mode=drain_mode, shard=shard)
    # run both executor shapes outside the timed region
    pool.warmup(streams[0].xy, streams[0].ts)

    lanes = {i: pool.connect(seed=SEED + i) for i in range(k)}
    cursors = {i: 0 for i in range(k)}
    lat = []
    t0 = time.perf_counter()
    while lanes:
        t1 = time.perf_counter()
        for i, lane in list(lanes.items()):
            st, c = streams[i], cursors[i]
            if c >= len(st):
                pool.flush(lane)
                pool.disconnect(lane)
                del lanes[i]
                continue
            pool.feed(lane, st.xy[c:c + SLAB], st.ts[c:c + SLAB])
            cursors[i] = c + SLAB
        pool.pump()
        for lane in lanes.values():
            pool.poll(lane)
        lat.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    fetches, rounds = pool.host_fetches, pool.rounds_executed
    pool.close()
    return dt, np.asarray(lat), fetches, rounds


def _run_burst(cfg, streams, *, ring_rounds: int, drain_mode: str = "sync",
               readout: str = "dense"):
    """Backlog burst: feed every stream fully, then pump once — the regime
    where the ring's K-rounds-per-fetch contract is fully visible (the
    latency loop above polls every round-trip, so its fetch ratio is bounded
    by the arrival cadence, not the ring depth).  Also returns the pump
    thread's drain wait — the time-to-next-round cost the async reader
    removes — and the D2H result bytes the drains fetched
    (``readout="compact"`` fetches kept-corner records instead of dense
    slabs)."""
    k = len(streams)
    pool = DetectorPool(cfg, capacity=k, ring_rounds=ring_rounds,
                        drain_mode=drain_mode, readout=readout)
    pool.warmup(streams[0].xy, streams[0].ts)  # counters are steady-state
    fetches0, rounds0 = pool.host_fetches, pool.rounds_executed
    ps0 = pool.pool_stats()                    # exclude warm drains
    dw0 = ps0["pump_drain_wait_s"]
    d2h0 = ps0["d2h_bytes"]
    lanes = {i: pool.connect(seed=SEED + i) for i in range(k)}
    for i, lane in lanes.items():
        pool.feed(lane, streams[i].xy, streams[i].ts)
    t0 = time.perf_counter()
    pool.pump()
    for lane in lanes.values():
        pool.poll(lane)
    dt = time.perf_counter() - t0
    rounds = pool.rounds_executed - rounds0
    fetches = pool.host_fetches - fetches0
    ps = pool.pool_stats()
    drain_wait = ps["pump_drain_wait_s"] - dw0
    d2h_bytes = ps["d2h_bytes"] - d2h0
    pool.close()
    return dt, rounds, fetches, drain_wait, d2h_bytes


def _run_ramp(cfg, k, *, policy, rates):
    """Serve k rate-ramp lanes (connected in the small bucket) and return
    the structural counters the migration rows report: H2D padding bytes,
    applied migrations, rounds, fetches.  The lanes are polled, not
    flushed: the witness measures steady-state serving padding, and a
    flush tail is one padded ``(lanes, bucket)`` round *per lane* — a k^2
    shutdown artifact that would swamp the per-round signal at pool16."""
    half = cfg.dvfs_cfg.half_us
    streams = [synthetic.ramp_stream(rates, half, seed=SEED + s)
               for s in range(k)]
    pool = DetectorPool(cfg, capacity=k, ring_rounds=RING_ROUNDS,
                        buckets=(128, 512), policy=policy,
                        migrate_patience=2)
    lanes = {i: pool.connect(seed=SEED + i, chunk=128) for i in range(k)}
    for j in range(len(rates)):
        for i, lane in lanes.items():
            st = streams[i]
            m = (st.ts // half) == j
            pool.feed(lane, st.xy[m], st.ts[m])
        pool.pump()
        for lane in lanes.values():
            pool.poll(lane)
    ps = pool.pool_stats()
    out = (ps["h2d_padding_bytes"], ps["migrations_total"],
           ps["rounds_executed"], ps["host_fetches"])
    assert pool.executors_compiled_once(), pool.compile_cache_sizes()
    pool.close()
    return out


def _run_overlap(cfg, k):
    """Pipelined-pump overlap witness: burst-feed every lane
    enough events for ~8 executor blocks (ring_rounds=4), pump the backlog
    in one pass at the default ``pipeline_depth=2``, and return the pool's
    structural stage-overlap ratio.  With B blocks in a pass the first two
    stages can't overlap (nothing dispatched yet / nothing staged ahead),
    so 8 blocks yield (B-2)/B = 0.75, machine-independent."""
    ring = 4
    blocks = 8
    bucket = cfg.chunk
    n_ev = ring * blocks * bucket
    streams = [synthetic.ramp_stream([n_ev], 20_000, seed=SEED + s)
               for s in range(k)]
    pool = DetectorPool(cfg, capacity=k, ring_rounds=ring,
                        buckets=(bucket,), pipeline_depth=2,
                        on_overflow="drop_oldest")
    pool.warmup(streams[0].xy, streams[0].ts)
    st0 = pool.pool_stats()
    lanes = {i: pool.connect(seed=SEED + i) for i in range(k)}
    for i, lane in lanes.items():
        pool.feed(lane, streams[i].xy, streams[i].ts)
    pool.pump()
    for lane in lanes.values():
        pool.poll(lane)
    ps = pool.pool_stats()
    stages = ps["pump_stages"] - st0["pump_stages"]
    overlapped = ps["pump_stages_overlapped"] - st0["pump_stages_overlapped"]
    assert pool.executors_compiled_once(), pool.compile_cache_sizes()
    pool.close()
    return overlapped / max(stages, 1)


def _run_pack(cfg, k, *, n_windows):
    """Fleet-packing witness: k busy lanes in the 128 bucket
    plus 2 sparse high-resolution lanes in the 512 bucket — the sparse
    bucket's blocks upload ``(K, phys, 512)`` slots for ~100 valid events
    each.  ``policy="pack"`` evacuates it into the busy bucket (whose
    blocks the fleet already pays for); the never-packed static placement
    is the padding baseline.  Returns (saved_ratio, pack_moves)."""
    half = cfg.dvfs_cfg.half_us
    busy = [synthetic.ramp_stream([512] * n_windows, half, seed=SEED + s)
            for s in range(k)]
    sparse = [synthetic.ramp_stream([100] * n_windows, half, seed=SEED + 64 + s)
              for s in range(2)]

    def serve(policy):
        pool = DetectorPool(cfg, capacity=k + 2, ring_rounds=4,
                            buckets=(128, 512), policy=policy,
                            migrate_patience=2, pipeline_depth=2)
        lanes = {i: pool.connect(seed=SEED + i, chunk=128)
                 for i in range(k)}
        lanes.update({k + i: pool.connect(seed=SEED + 64 + i, chunk=512)
                      for i in range(2)})
        for j in range(n_windows):
            for i, lane in lanes.items():
                st = busy[i] if i < k else sparse[i - k]
                m = (st.ts // half) == j
                pool.feed(lane, st.xy[m], st.ts[m])
            pool.pump()
            for lane in lanes.values():
                pool.poll(lane)
        ps = pool.pool_stats()
        out = (ps["h2d_padding_bytes"], ps.get("pack_moves", 0))
        assert pool.executors_compiled_once(), pool.compile_cache_sizes()
        pool.close()
        return out

    pad_static, _ = serve("static")
    pad_packed, moves = serve("pack")
    return 1.0 - pad_packed / max(pad_static, 1), float(moves)


def _run_overload(cfg, k, *, use_ladder, n_windows):
    """2x flash-crowd overload (``burst_stream``): each half-window every
    lane receives one ring of rounds at baseline and twice that during the
    burst, then the round is pumped and polled.  Without the ladder the
    pump must fold every arrived round; with it, lanes degrade tier by
    tier until standard lanes shed to one ring of rounds while the premium
    lane (lane 0, pools > 1) keeps full quality — its LUT refresh cadence
    is asserted every round.  Returns per-round latencies plus the
    ladder's transition and shed counters (the structural witnesses)."""
    half = cfg.dvfs_cfg.half_us
    ring = 4
    bucket = cfg.chunk                  # stay in the warmed default bucket
    base = ring * bucket                # 1x load: one ring per half-window
    streams = [
        synthetic.burst_stream(
            base, n_windows, half, burst_start=4,
            burst_len=n_windows - 8, burst_factor=2.0, seed=SEED + s,
        )
        for s in range(k)
    ]
    pool = DetectorPool(
        cfg, capacity=k, ring_rounds=ring, buckets=(bucket,),
        policy="ladder" if use_ladder else "static",
        ladder=LadderConfig(patience=1, recover_patience=2)
        if use_ladder else None,
    )
    pool.warmup(streams[0].xy, streams[0].ts)
    lanes = {
        i: pool.connect(
            seed=SEED + i,
            qos="premium" if (i == 0 and k > 1) else "standard",
        )
        for i in range(k)
    }
    lat = []
    for j in range(n_windows):
        t1 = time.perf_counter()
        for i, lane in lanes.items():
            st = streams[i]
            m = (st.ts // half) == j
            pool.feed(lane, st.xy[m], st.ts[m])
        pool.pump()
        for lane in lanes.values():
            pool.poll(lane)
        lat.append(time.perf_counter() - t1)
        if use_ladder and k > 1:
            # premium holds full LUT refresh cadence through the overload
            s0 = pool.stats(lanes[0])
            assert s0["ctrl_lut_every"] == cfg.lut_every_chunks, s0
            assert s0["ladder_tier"] == 0, s0
    ps = pool.pool_stats()
    trans = ps.get("ladder_transitions", 0)
    shed = ps["shed_events_total"]
    assert pool.executors_compiled_once(), pool.compile_cache_sizes()
    if use_ladder:
        assert trans > 0 and shed > 0, (trans, shed)
    pool.close()
    return np.asarray(lat), trans, shed


def _time_stream(cfg, st):
    """Wall time to serve one stream slab-by-slab through a
    StreamingDetector (warmed on a throwaway instance), up to the last
    result on the host."""
    warm = StreamingDetector(cfg, seed=SEED)
    warm.feed(st.xy, st.ts)
    warm.flush()
    det = StreamingDetector(cfg, seed=SEED)
    t0 = time.perf_counter()
    for c in range(0, len(st), SLAB):
        det.feed(st.xy[c:c + SLAB], st.ts[c:c + SLAB])
    det.flush()
    return time.perf_counter() - t0


def _fused_stream_rows(smoke: bool, device: str):
    """Measured streaming throughput of ``fused`` (K1) against ``torch``
    (the plain step) at DAVIS240 and 720p.  Off a CUDA device ``fused``
    runs K1's plain version, so wall time would compare two plain paths:
    the rows are recorded ``_skipped`` there."""
    out = []
    on_card = torch.device(device).type == "cuda"
    sizes = FUSED_SIZES[:1] if smoke else FUSED_SIZES
    duration = 6_000 if smoke else DURATION_US
    for (h, w) in sizes:
        tag = f"stream_fused_{h}x{w}"
        if not on_card:
            out.append((f"{tag}_unfused_events_per_s_skipped", 0.0, 0.0))
            out.append((f"{tag}_fused_events_per_s_skipped", 0.0, 0.0))
            continue
        st = synthetic.shapes_stream(height=h, width=w,
                                     duration_us=duration, seed=SEED)
        for label, backend in (("unfused", "torch"), ("fused", "fused")):
            cfg = pipeline.PipelineConfig(height=h, width=w, chunk=256,
                                          lut_every_chunks=2,
                                          backend=backend, device=device)
            dt = _time_stream(cfg, st)
            out.append((f"{tag}_{label}_events_per_s",
                        dt * 1e6 / max(len(st), 1), len(st) / dt))
    return out


def _run_batch(cfg, streams):
    k = len(streams)
    e = min(len(s) for s in streams)
    xy = np.stack([s.xy[:e] for s in streams])
    ts = np.stack([s.ts[:e] for s in streams])
    pipeline.run_pipeline_batched(xy, ts, cfg)  # warm-up
    t0 = time.perf_counter()
    pipeline.run_pipeline_batched(xy, ts, cfg)
    return time.perf_counter() - t0, k * e


def _pool_rows(tag: str, streams, dt, lat, fetches, rounds):
    n_total = sum(len(s) for s in streams)
    return [
        (f"{tag}_slab_p50_ms", 0.0, float(np.percentile(lat, 50) * 1e3)),
        (f"{tag}_slab_p99_ms", 0.0, float(np.percentile(lat, 99) * 1e3)),
        (f"{tag}_events_per_s", dt * 1e6 / max(n_total, 1), n_total / dt),
        (f"{tag}_fetches_per_round", 0.0, fetches / max(rounds, 1)),
    ]


def rows(smoke: bool = False, *, device: str = "cuda"):
    """The rows above, in the reference's order, with every pool on
    ``device``."""
    out = []
    pool_sizes = (1, 2) if smoke else POOL_SIZES
    duration = 6_000 if smoke else DURATION_US
    cfg = pipeline.PipelineConfig(chunk=256, lut_every_chunks=2,
                                  device=device)
    single_device = local_lane_mesh(device=device).shape["lanes"] == 1
    for k in pool_sizes:
        streams = _mk_streams(k, duration)

        # per-round baseline: one fetch per round (the pre-ring model)
        dt, lat, fetches, rounds = _run_pool(cfg, streams, ring_rounds=1)
        out.extend(_pool_rows(f"pool{k}", streams, dt, lat, fetches, rounds))

        # ring path, synchronous drain: K rounds back-to-back per fetch
        dt, lat, fetches, rounds = _run_pool(
            cfg, streams, ring_rounds=RING_ROUNDS
        )
        out.extend(
            _pool_rows(f"pool{k}_ring", streams, dt, lat, fetches, rounds)
        )
        out.append((f"pool{k}_sessions_per_s", 0.0, k / dt))

        # ring path, async drain: reader thread fetches sealed rings
        dt, lat, fetches, rounds = _run_pool(
            cfg, streams, ring_rounds=RING_ROUNDS, drain_mode="async"
        )
        out.extend(
            _pool_rows(f"pool{k}_ring_async", streams, dt, lat, fetches,
                       rounds)
        )

        # backlog burst: rounds-per-fetch hits the ring depth (K -> 1)
        for tag, rr in ((f"pool{k}", 1), (f"pool{k}_ring", RING_ROUNDS)):
            _, rounds, fetches, _, _ = _run_burst(cfg, streams,
                                                  ring_rounds=rr)
            out.append((f"{tag}_burst_rounds_per_fetch", 0.0,
                        rounds / max(fetches, 1)))

        # drain-wait contrast: burst through a 2-slot ring so every other
        # block must make room first; sync fetches inline, async swaps
        for mode in ("sync", "async"):
            _, _, _, dw, _ = _run_burst(
                cfg, streams, ring_rounds=DRAIN_WAIT_RING, drain_mode=mode
            )
            out.append((f"pool{k}_burst_drain_wait_{mode}_ms", 0.0,
                        dw * 1e3))
        # same burst with the compact readout: the inline sync fetch now
        # moves kept-corner records instead of dense slabs, so this row
        # reads against ..._drain_wait_sync_ms
        _, _, _, dw, _ = _run_burst(
            cfg, streams, ring_rounds=DRAIN_WAIT_RING, drain_mode="sync",
            readout="compact",
        )
        out.append((f"pool{k}_burst_drain_wait_compact_ms", 0.0, dw * 1e3))

        # D2H readout diet: result bytes per blocking fetch on a
        # sparse-corner fleet (noise-dominated streams keep few events,
        # the regime the compaction targets), dense vs compact.  The
        # bytes-per-fetch rows and their ratio are structural — shape
        # math at fixed sizes, not wall time (~cap/chunk, <= 0.25).
        sparse_streams = [
            synthetic.shapes_stream(duration_us=duration,
                                    signal_rate_per_us=0.02,
                                    noise_rate_per_us=0.25,
                                    seed=SEED + 32 + s)
            for s in range(k)
        ]
        per_fetch = {}
        for ro in ("dense", "compact"):
            _, _, fetches, _, d2h = _run_burst(
                cfg, sparse_streams, ring_rounds=DRAIN_WAIT_RING,
                drain_mode="sync", readout=ro,
            )
            per_fetch[ro] = d2h / max(fetches, 1)
            out.append((f"pool{k}_d2h_bytes_per_fetch_{ro}", 0.0,
                        per_fetch[ro]))
        out.append((f"pool{k}_d2h_bytes_ratio", 0.0,
                    per_fetch["compact"] / max(per_fetch["dense"], 1.0)))

        # lane-sharded pool: needs more than one local device of the
        # run's type; recorded, not measured, where there is one
        if single_device:
            out.append((f"pool{k}_sharded_events_per_s_skipped", 0.0, 0.0))
        else:
            sdt, _, _, _ = _run_pool(cfg, streams, ring_rounds=RING_ROUNDS,
                                     shard=True)
            n_total = sum(len(s) for s in streams)
            out.append((f"pool{k}_sharded_events_per_s",
                        sdt * 1e6 / max(n_total, 1), n_total / sdt))

        # adaptive control plane under a rate-ramp: padding saved + moves
        ramp_rates = ([100] * 3 + [512] * 9) if smoke \
            else ([100] * 5 + [512] * 14)
        pad_s, _, _, _ = _run_ramp(cfg, k, policy="static",
                                   rates=ramp_rates)
        pad_a, migs, rounds, fetches = _run_ramp(cfg, k, policy="adaptive",
                                                 rates=ramp_rates)
        out.append((f"pool{k}_migration_count", 0.0, float(migs)))
        out.append((f"pool{k}_migration_padding_saved_ratio", 0.0,
                    1.0 - pad_a / max(pad_s, 1)))
        out.append((f"pool{k}_migration_padding_saved_mb", 0.0,
                    (pad_s - pad_a) / 1e6))
        out.append((f"pool{k}_migration_rounds_per_fetch", 0.0,
                    rounds / max(fetches, 1)))

        # pipelined pump: structural stage/dispatch overlap on a backlog
        # burst; pack: padded-upload bytes saved by migrating a
        # sparse big-bucket fleet into the busy small bucket
        out.append((f"pool{k}_pump_stage_overlap_ratio", 0.0,
                    _run_overlap(cfg, k)))
        pack_win = 8 if smoke else 14
        saved, moves = _run_pack(cfg, k, n_windows=pack_win)
        out.append((f"pool{k}_pack_padding_saved_ratio", 0.0, saved))
        out.append((f"pool{k}_pack_moves", 0.0, moves))

        # overload ladder SLO: p99 of a serving round under a 2x flash
        # crowd, with and without graceful degradation; the
        # full run needs a long sustained burst — with few windows the
        # p99 is the max of a handful of samples and host jitter
        # swamps the ladder's effect at mid pool sizes
        n_win = 12 if smoke else 24
        lat_n, _, _ = _run_overload(cfg, k, use_ladder=False,
                                    n_windows=n_win)
        lat_l, trans, _ = _run_overload(cfg, k, use_ladder=True,
                                        n_windows=n_win)
        out.append((f"pool{k}_overload_p99_none_ms", 0.0,
                    float(np.percentile(lat_n, 99) * 1e3)))
        out.append((f"pool{k}_overload_p99_ladder_ms", 0.0,
                    float(np.percentile(lat_l, 99) * 1e3)))
        out.append((f"pool{k}_overload_ladder_transitions", 0.0,
                    float(trans)))

        bdt, bn = _run_batch(cfg, streams)
        out.append((f"batch{k}_events_per_s", bdt * 1e6 / max(bn, 1),
                    bn / bdt))
    out.extend(_fused_stream_rows(smoke, device))
    return out
