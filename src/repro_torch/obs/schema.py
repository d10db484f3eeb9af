"""One source of truth for the serving stats surface.

Every key that ``PoolRuntime.stats()``, ``PoolRuntime.pool_stats()`` and
``StreamingDetector.stats()`` export is declared here with a one-line
description.  Three consumers render from this table and nothing else:

1. the pool's ``MetricsRegistry`` — registry metric descriptions are
   looked up here at declaration time;
2. the generated stats-key reference table appended to
   ``repro.serve.__doc__`` (``stats_reference_table()``);
3. the golden-key tests — they assert the *exported* key sets equal the
   *declared* ones, so a stat can't ship undocumented and a doc row
   can't outlive its stat.

Keys marked in ``WALL_TIME_KEYS`` are wall-clock witnesses: real and
exported, but excluded from byte-equality replay comparisons because two
runs of the same replay legitimately measure different walls.
"""
from __future__ import annotations

__all__ = [
    "LANE_STATS",
    "POOL_STATS",
    "POOL_BUCKET_STATS",
    "POLICY_STATS",
    "SESSION_STATS",
    "WALL_TIME_KEYS",
    "steady_record",
    "stats_reference_table",
]

# -- per-lane stats: DetectorPool.stats(lane) --------------------------------

LANE_STATS = {
    "lane": "lane index within the pool",
    "bucket": "chunk-size bucket the lane currently executes in",
    "n_events": "events accepted from this lane (pre-shed)",
    "n_chunks": "chunk rounds executed for this lane",
    "kept_total": "host-confirmed corner-kept events",
    "energy_pj": "host-confirmed modeled energy (pJ)",
    "latency_ns_per_event": "modeled ns/event over scored chunks",
    "buffered": "events parked in the host re-chunk buffer",
    "events_per_s_est": "paper 3-counter rate estimate (events/s)",
    "device_events_per_s_est": "device-confirmed rate estimate (events/s)",
    "migrations": "bucket migrations this lane completed",
    "migration_log": "list of (from_bucket, to_bucket) per migration",
    "migration_staged": "True while a migration is staged, not applied",
    "ring_capacity": "rounds per on-device result ring",
    "ring_rounds_buffered": "rounds in the lane's live (unsealed) ring",
    "ring_sealed_rounds": "rounds sealed to the reader, not yet drained",
    "ring_dropped_rounds": "rounds lost to overflow (confirmed+predicted)",
    "backlog_rounds": "full rounds waiting in the host buffer",
    "reader_lag_rounds": "sealed rounds the reader has not drained yet",
    "last_drain_wait_s": "wall seconds of this bucket's last forced drain",
    "qos": "lane quality-of-service class (ladder ordering)",
    "ladder_tier": "current degradation tier (0 = full quality)",
    "ctrl_lut_every": "effective LUT refresh interval knob",
    "ctrl_vdd_cap": "effective DVFS operating-point ceiling knob",
    "ctrl_shed": "True when the shed knob is engaged",
    "shed_events": "events dropped by shedding for this lane",
    "device_kept_total": "kept events incl. undrained device rounds",
    "device_energy_pj": "energy (pJ) incl. undrained device rounds",
    "device_latency_ns": "modeled ns/event incl. undrained rounds",
}

# -- pool-wide stats: DetectorPool.pool_stats() ------------------------------

POOL_STATS = {
    "capacity": "max concurrent lanes",
    "active": "currently connected lanes",
    "sharded": "True when lanes are sharded across local devices",
    "devices": "device count backing the lane mesh",
    "ring_rounds": "rounds per ring (ring capacity)",
    "ring_depth": "rings per bucket (ring-of-rings depth)",
    "pipeline_depth": "pump stage-ahead depth (1 = serial pump)",
    "on_overflow": "ring overflow policy (drop_oldest | drain)",
    "drain_mode": "reader drain mode (sync | async)",
    "readout": "ring readout representation (dense | compact)",
    "policy": "scheduler policy name",
    "host_fetches": "blocking device->host result transfers",
    "rounds_executed": "chunk rounds dispatched to executors",
    "pump_drain_wait_s": "wall seconds the pump spent waiting on drains",
    "pump_forced_drains": "mid-pump makes-room drain events",
    "pump_stages": "event-slab blocks staged for upload",
    "pump_stages_overlapped": "blocks staged while device compute ran",
    "pump_stage_overlap_ratio": "pump_stages_overlapped / pump_stages",
    "pump_stage_s": "wall seconds spent gathering/pinning/uploading",
    "pump_stage_hidden_s": "stage seconds hidden under device compute",
    "ctrl_batched_writes": "coalesced control-leaf batch updates",
    "ctrl_actions_coalesced": "knob actions folded into those batches",
    "observation_rebuilds": "LaneObservations built fresh",
    "observation_reuses": "LaneObservations served from generation cache",
    "reader_lag_rounds": "sealed-not-drained rounds across buckets",
    "migrations_total": "lane bucket migrations applied",
    "migrations_staged": "migrations staged for the next pump pass",
    "h2d_event_slots": "uploaded chunk slots including padding",
    "h2d_valid_events": "valid events inside those slots",
    "h2d_padding_bytes": "upload bytes spent on padding slots",
    "h2d_pinned_staging": "True when uploads stage via pinned host memory",
    "h2d_staged_uploads": "uploads that went through the pinned stager",
    "d2h_bytes": "result bytes fetched device->host across drains",
    "d2h_bytes_saved": "dense-equivalent bytes the compact readout skipped",
    "d2h_compact_overflow_slots": "slot-lanes that fell back to dense rows",
    "dropped_rounds_total": "rounds lost to overflow (confirmed+predicted)",
    "dropped_rounds_confirmed": "overflow drops confirmed by fetches",
    "shed_events_total": "shed events across currently-connected lanes",
    "buckets": "per-bucket sub-table (see bucket keys)",
}

# -- per-bucket sub-table: pool_stats()["buckets"][b] ------------------------

POOL_BUCKET_STATS = {
    "lanes": "lanes currently homed in this bucket",
    "events_per_s_est": "summed lane rate estimates (events/s)",
    "ring_rounds_buffered": "rounds in this bucket's live ring",
    "ring_sealed_rounds": "rounds sealed to the reader, undrained",
    "ring_dropped_rounds": "overflow drops (confirmed+predicted)",
    "h2d_event_slots": "uploaded chunk slots including padding",
    "h2d_valid_events": "valid events inside those slots",
    "executables": "compiled executor count {block, single} (<=1 each)",
}

# -- policy-dependent extras merged into pool_stats() ------------------------

POLICY_STATS = {
    "pack_moves": "pack/un-pack migrations emitted (pack, ladder)",
    "pack_saved_slots": "padded slots saved by packing (pack)",
    "ladder_level": "current fleet degradation level (ladder)",
    "ladder_max_level": "deepest level reached (ladder)",
    "ladder_transitions": "level transitions, both directions (ladder)",
}

# -- single-session stats: StreamingDetector.stats() -------------------------

SESSION_STATS = {
    "n_events": "events accepted this session",
    "n_chunks": "chunk rounds executed",
    "chunk": "current chunk size",
    "rebuckets": "live chunk-size changes",
    "kept_total": "host-confirmed corner-kept events",
    "energy_pj": "host-confirmed modeled energy (pJ)",
    "latency_ns_per_event": "modeled ns/event over scored chunks",
    "buffered": "events parked in the re-chunk buffer",
    "events_per_s_est": "paper 3-counter rate estimate (events/s)",
    "device_kept_total": "kept events incl. undrained device work",
    "device_energy_pj": "energy (pJ) incl. undrained device work",
    "device_latency_ns": "modeled ns/event incl. undrained work",
}

# Wall-clock witnesses: exported, but never byte-compared across replays.
WALL_TIME_KEYS = frozenset({
    "last_drain_wait_s",
    "pump_drain_wait_s",
    "pump_stage_s",
    "pump_stage_hidden_s",
})


def steady_record(record: dict) -> dict:
    """An emitted metrics record without its wall clocks: ``t_wall`` and
    every metric named in ``WALL_TIME_KEYS``, labelled or not.  Two replays
    of the same run emit equal steady records."""
    metrics = {k: v for k, v in record.get("metrics", {}).items()
               if k.split("{")[0] not in WALL_TIME_KEYS}
    return {**{k: v for k, v in record.items() if k != "t_wall"},
            "metrics": metrics}


def describe(table: str, key: str) -> str:
    """Description for ``key`` in one of the tables above (KeyError if
    the key is undeclared — declaration here is mandatory)."""
    return {
        "lane": LANE_STATS,
        "pool": POOL_STATS,
        "bucket": POOL_BUCKET_STATS,
        "policy": POLICY_STATS,
        "session": SESSION_STATS,
    }[table][key]


def stats_reference_table() -> str:
    """Render the stats-key reference appended to ``repro.serve.__doc__``.

    Generated, not hand-written: edits belong in the tables above.
    """
    sections = (
        ("stats(lane) — per-lane", LANE_STATS),
        ("pool_stats() — pool-wide", POOL_STATS),
        ("pool_stats()['buckets'][b] — per-bucket", POOL_BUCKET_STATS),
        ("pool_stats() policy extras", POLICY_STATS),
        ("StreamingDetector.stats() — per-session", SESSION_STATS),
    )
    lines = [
        "Stats-key reference (generated from repro_torch.obs.schema — do not",
        "hand-edit; keys suffixed * are wall-clock witnesses excluded",
        "from byte-equality replay comparisons):",
        "",
    ]
    for title, table in sections:
        lines.append(title)
        width = max(len(k) for k in table) + 1
        for key, desc in table.items():
            star = "*" if key in WALL_TIME_KEYS else ""
            lines.append(f"  {key + star:<{width}} {desc}")
        lines.append("")
    return "\n".join(lines)
