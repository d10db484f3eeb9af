"""The check follows each lane's chunk schedule: the chunk sizes the pool
folded it in, in stream order, as ``stats(lane)``'s ``migration_log`` and a
flushed tail say.

* A constant schedule reads as before this change did: LaneResult digests
  of the reference and the rounds ``profiled_rounds`` rebuilds on a static
  run equal fixtures written from the reference and the harness before it
  (``data/reference_digests.json``, ``data/static_rounds.json``).
* The reference follows ``StreamingDetector.rebucket`` (the chunk counter
  and the key chain run on across a move) and ``DetectorPool``'s staged
  moves and ``flush`` (a partial tail: one operating point, one key split,
  its padding neither kept, scored nor booked).
* A whole run of an adaptive pool (buckets 128/512/2048, camera rates
  stepping between 0.4 and 0.01 events/us) on the CPU is correct, and not
  correct with a boundary logged a chunk off, with a chunk counter that
  restarts at a move, with the check handed no schedule, or with the
  bfloat16 control in the program's place."""
from __future__ import annotations

import hashlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench.lib import (bench, check, control, manifest,  # noqa: E402
                           streams)
from perfbench.lib.manifest import load_json  # noqa: E402
from perfbench.reference import detector  # noqa: E402
from perfbench.tests import _tiny  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
DIGESTS = load_json(DATA / "reference_digests.json")
ROUNDS = load_json(DATA / "static_rounds.json")
SEED = 2**31 + 41


def _sha(a) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(a.dtype.str.encode() + str(a.shape).encode()
                          + a.tobytes()).hexdigest()


def _digest(r: detector.LaneResult) -> dict:
    return {"scores": _sha(r.scores), "kept": _sha(r.kept),
            "n_chunks": r.n_chunks, "kept_total": r.kept_total,
            "books": [float(v).hex() for v in (
                r.energy_pj, r.latency_ns, r.dev_energy_pj,
                r.dev_latency_ns)],
            "vdd_idx": _sha(np.asarray(r.vdd_idx, np.int64)),
            "surface": _sha(r.surface)}


def _round_digest(r) -> dict:
    return {"xy": _sha(r.xy), "keep": _sha(r.keep), "valid": _sha(r.valid),
            **{k: getattr(r, k) for k in (
                "h", "w", "patch", "inject", "due", "sobel", "window",
                "phys", "e", "cap")}}


@pytest.mark.parametrize("explicit", [False, True],
                         ids=["chunks_none", "constant_schedule"])
@pytest.mark.parametrize("case", sorted(DIGESTS))
def test_constant_schedule_unchanged(case, explicit):
    fx = DIGESTS[case]
    base = _tiny.davis_config()
    cfg = {**base, "pipeline": {**base["pipeline"], **fx["pipeline"]}}
    lanes, seeds = streams.lane_streams(
        {**cfg["stream"], "duration_us": 40_000, **fx["stream"]},
        cfg["sensor"], 2, seed=2**31 + 12345)
    e = cfg["pipeline"]["chunk"]
    evs = [ln.take(0, c * e) for ln, c in zip(lanes, fx["chunks_per_lane"])]
    chunks = ([[e] * c for c in fx["chunks_per_lane"]] if explicit
              else None)
    res = detector.Reference(check.params(cfg), seeds).run(
        [v[0] for v in evs], [v[1] for v in evs], chunks)
    assert [_digest(r) for r in res] == fx["lanes"]


def _pool(config, lanes=2):
    from repro_torch.serve import DetectorPool
    return DetectorPool(bench.pipeline_config(config, "cpu"), lanes,
                        shard=False, **config["pool"])


@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_static_rounds_unchanged(readout):
    config = _tiny.davis_config(2)
    config["pool"] = {**config["pool"], "readout": readout}
    replays, keys = streams.lane_streams(
        {**config["stream"], "duration_us": 60_000}, config["sensor"], 2,
        ROUNDS["seed"])
    pool = _pool(config)
    try:
        lanes = [bench.Lane(pool.connect(seed=k), r, k)
                 for r, k in zip(replays, keys)]
        drv = bench.Rig(pool, lanes, config["pipeline"]["chunk"])
        for counts in ROUNDS["turns"]:
            drv.turn(counts)
        plans = [check.schedule(config, pool.stats(ln.id)) for ln in lanes]
    finally:
        pool.close()
    rounds = bench.profiled_rounds(
        config, bench.pipeline_config(config, "cpu"),
        drv.turns[ROUNDS["from_turn"]:], lanes, drv.outputs(), plans)
    assert [_round_digest(r) for r in rounds] == ROUNDS[readout]


def _moving_config():
    config = _tiny.davis_config(2)
    config["pool"] = {**config["pool"], "buckets": [128, 512, 2048]}
    replays, seeds = streams.lane_streams(
        {**config["stream"], "duration_us": 40_000}, config["sensor"], 2,
        2**31 + 77)
    return config, replays, seeds


def test_reference_follows_rebucket():
    """A ``StreamingDetector`` that ``rebucket``s after 3 chunks (an odd
    count: the LUT falls due on the counter) and twice more, then flushes
    a tail, equals the reference cut the same way, and not the reference
    whose chunk counter restarts at the first move."""
    from repro_torch.serve import StreamingDetector
    config, replays, seeds = _moving_config()
    plan = [512] * 3 + [128] * 5 + [2048] * 2 + [512] + [300]
    moves = {3: 128, 8: 2048, 10: 512}
    det = StreamingDetector(bench.pipeline_config(config, "cpu"),
                            seed=seeds[0])
    outs, at = [], 0
    for k, size in enumerate(plan):
        if k in moves:
            det.rebucket(moves[k])
        outs.append(det.feed(*replays[0].take(at, at + size)))
        at += size
    outs.append(det.flush())
    got = (np.concatenate([o[0] for o in outs]),
           np.concatenate([o[1] for o in outs]))
    assert det.stats()["rebuckets"] == 3
    xy, ts = replays[0].take(0, at)
    p = check.params(config)
    ref = detector.Reference(p, seeds[:1]).run([xy], [ts], [plan])
    vals = check.compare(config, [at], [got], [det.stats()], ref)
    assert all(c["value"] <= c["limit"] for c in vals.values()), vals
    assert vals["kept_differ"]["value"] == 0
    # the counter restarted at the move: the first three chunks alone, then
    # a fresh lane on the rest, shifts the LUT's cadence and the key chain
    head = detector.Reference(p, seeds[:1]).run(
        [xy[:1536]], [ts[:1536]], [plan[:3]])[0]
    assert np.array_equal(head.kept, ref[0].kept[:1536])
    restarted = detector.Reference(p, seeds[:1]).run(
        [xy[1536:]], [ts[1536:]], [plan[3:]])[0]
    assert not np.array_equal(restarted.scores, ref[0].scores[1536:])


@pytest.mark.parametrize("drain", ["sync", "async"])
def test_reference_follows_pool_moves_and_flush(drain):
    """Moves staged by hand (up, down, both lanes at once) and a flushed
    partial tail on each lane: the schedules built from ``stats`` chain,
    and the reference cut by them equals the pool."""
    config, replays, seeds = _moving_config()
    config["pool"] = {**config["pool"], "drain_mode": drain}
    pool = _pool(config)
    fed, got = [0, 0], [[], []]
    try:
        ids = [pool.connect(seed=s) for s in seeds]

        def turn(n):
            for i in range(2):
                pool.feed(ids[i], *replays[i].take(fed[i], fed[i] + n))
                fed[i] += n
            pool.pump()
            for i in range(2):
                got[i].append(pool.poll(ids[i]))

        turn(512 * 3 + 200)
        pool.stage_migration(ids[0], 128)
        turn(128 * 5 + 40)
        pool.stage_migration(ids[0], 2048)
        pool.stage_migration(ids[1], 2048)
        turn(2048 + 999)
        for i in range(2):
            got[i].append(pool.flush(ids[i]))
        stats = [pool.stats(i) for i in ids]
    finally:
        pool.close()
    plans = [check.schedule(config, st) for st in stats]
    assert [check.runs(pl) for pl, _ in plans] == [
        [[512, 512, 3], [128, 128, 6], [2048, 2048, 1], [2048, 1111, 1]],
        [[512, 512, 4], [2048, 2048, 1], [2048, 1367, 1]]]
    assert [bad for _, bad in plans] == [0, 0]
    chunks = [check.sizes(pl) for pl, _ in plans]
    evs = [r.take(0, sum(c)) for r, c in zip(replays, chunks)]
    ref = detector.Reference(check.params(config), seeds).run(
        [e[0] for e in evs], [e[1] for e in evs], chunks)
    outs = [(np.concatenate([g[0] for g in gg]),
             np.concatenate([g[1] for g in gg])) for gg in got]
    vals = check.compare(config, fed, outs, stats, ref, [0, 0])
    assert all(c["value"] <= c["limit"] for c in vals.values()), vals
    assert vals["count_differ"]["value"] == 0


def test_schedule_chains_and_counts_what_does_not():
    config = _moving_config()[0]
    st = {"n_events": 3000, "buffered": 100, "migration_log": []}
    assert check.schedule(config, st) == ([(512, 512)] * 5 + [(512, 340)],
                                          0)
    st["migration_log"] = [(1024, 512, 128), (1280, 128, 2048)]
    assert check.schedule(config, st) == (
        [(512, 512)] * 2 + [(128, 128)] * 2 + [(2048, 1620)], 0)
    # a boundary that is not whole chunks of old, an old not in force
    st["migration_log"] = [(1000, 512, 128), (1280, 512, 2048)]
    plan, bad = check.schedule(config, st)
    assert bad == 2 and sum(check.sizes(plan)) == 2900
    assert check.from_runs(check.runs(plan)) == plan
    # a config without buckets connects at its chunk
    assert check.buckets(_tiny.davis_config()) == (512,)


def test_rig_flush_delivers_the_tail():
    config, replays, seeds = _moving_config()
    pool = _pool(config)
    try:
        lanes = [bench.Lane(pool.connect(seed=k), r, k)
                 for r, k in zip(replays, seeds)]
        drv = bench.Rig(pool, lanes, 512)
        drv.turn([1300, 512])
        assert [ln.delivered for ln in lanes] == [1024, 512]
        drv.flush(lanes[0])
        assert [ln.delivered for ln in lanes] == [1300, 512]
        assert drv.turns[-1] == [(1024, 1300), (512, 512)]
        st = pool.stats(lanes[0].id)
    finally:
        pool.close()
    assert st["n_chunks"] == 3 and st["buffered"] == 0
    assert len(drv.outputs()[0][0]) == 1300


@pytest.fixture(scope="module")
def adaptive(tmp_path_factory):
    """The adaptive checkout and one sound CPU run of its cell."""
    root = _tiny.adaptive_root(tmp_path_factory.mktemp("pbad"))
    return root, bench.run("tinyad.tinypaced", SEED, 5.0, False,
                           device="cpu", root=root)


def _moves(res) -> list:
    """Per lane, the (old, new) buckets of its moves, from its schedule."""
    out = []
    for rows in res["schedules"]:
        seq = [b for b, _, _ in rows]
        out.append([(a, b) for a, b in zip(seq, seq[1:]) if a != b])
    return out


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_adaptive_run_correct(adaptive, device, tmp_path):
    root, res = adaptive
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs an NVIDIA GPU")
        res = bench.run("tinyad.tinypaced", SEED, 5.0, False,
                        device="cuda", root=root)
    assert res["correct"], res["checks"]
    assert res["checks"]["count_differ"]["value"] == 0
    for moves in _moves(res):
        assert any(b > a for a, b in moves), moves
        assert any(b < a for a, b in moves), moves
    # every lane was flushed: its last chunk is partial
    assert all(rows[-1][1] < rows[-1][0] for rows in res["schedules"])


def _log_one_chunk_off(orig):
    """Each applied move is logged one chunk of its old bucket later than
    the boundary the lane was cut at."""
    def apply(self):
        n = {lane: len(self._lanes[lane].migration_log)
             for lane in self._staged if self._lanes[lane] is not None}
        orig(self)
        for lane, k in n.items():
            log = self._lanes[lane].migration_log
            if len(log) > k:
                at, old, new = log[-1]
                log[-1] = (at + old, old, new)
    return apply


def _counter_restarts(orig):
    """A moved lane's chunk counter starts again from 0."""
    def apply(self):
        moved = list(self._staged)
        orig(self)
        for lane in moved:
            sh, i = self._locate(lane)
            idx = np.array(sh.state.chunk_idx, np.int32, copy=True)
            idx[i] = 0
            sh.state = sh.state._replace(chunk_idx=idx)
    return apply


def _no_schedule(config, st):
    """The check before schedules: every chunk at ``pipeline.chunk``."""
    return check._cut(0, st["n_events"] - st["buffered"],
                      config["pipeline"]["chunk"]), 0


@pytest.mark.parametrize("fault", ["log_one_chunk_off", "counter_restarts",
                                   "no_schedule"])
def test_adaptive_faults_caught(adaptive, fault, monkeypatch):
    from repro_torch.serve.runtime import PoolRuntime
    root, sound = adaptive
    lut_every = _tiny.adaptive_config()["pipeline"]["lut_every_chunks"]
    if fault == "no_schedule":
        monkeypatch.setattr(check, "schedule", _no_schedule)
    else:
        wrap = {"log_one_chunk_off": _log_one_chunk_off,
                "counter_restarts": _counter_restarts}[fault]
        monkeypatch.setattr(PoolRuntime, "_apply_staged_locked",
                            wrap(PoolRuntime._apply_staged_locked))
    if fault == "counter_restarts":
        # the sound run moves some lane at a count the LUT's cadence sees
        counts = [np.cumsum([k for _, _, k in rows])[:-1]
                  for rows in sound["schedules"]]
        assert any(int(c) % lut_every for cs in counts for c in cs)
    res = bench.run("tinyad.tinypaced", SEED, 5.0, False, device="cpu",
                    root=root)
    assert res["correct"] is False, res["checks"]


def test_adaptive_control_fails(adaptive):
    """The bfloat16 control folded in the sound run's schedules is not
    correct; the reference against itself reads exact but for the float32
    rounding of its scores."""
    root, sound = adaptive
    config = _tiny.adaptive_config()
    chunks = [check.sizes(check.from_runs(rows))
              for rows in sound["schedules"]]
    assert any(len(set(c)) > 2 for c in chunks)
    got = control.readings(config, SEED, chunks, device="cpu",
                           root=root)
    assert any(c["value"] > c["limit"] for c in got.values()), got
    same = control.readings(config, SEED, chunks, device="cpu",
                            root=root, dtype=torch.float64)
    assert same["score_gap"]["value"] < 1e-6
    assert all(c["value"] == 0 for k, c in same.items()
               if k != "score_gap"), same


def test_adaptive_rounds_are_the_pools(adaptive):
    """``profiled_rounds`` on an adaptive Rig: one round per bucket and
    round index of each pump, ``e`` the bucket, as many as the pool ran
    turn by turn, every folded event in exactly one of them."""
    root, _ = adaptive
    config = _tiny.adaptive_config()
    replays, keys = streams.lane_streams(config["stream"], config["sensor"],
                                         2, SEED, root)
    loop = manifest.loop("paced", root)
    pool = _pool(config)
    ran = []
    try:
        lanes = [bench.Lane(pool.connect(seed=k), r, k)
                 for r, k in zip(replays, keys)]
        drv = bench.Rig(pool, lanes, 512)
        state = loop.settle(drv, {}, {})
        mix = {"turn_us": 5_000}
        for _ in range(24):
            before = pool.pool_stats()["rounds_executed"]
            loop._turns(drv, mix, state, 1)
            ran.append(pool.pool_stats()["rounds_executed"] - before)
        plans = [check.schedule(config, pool.stats(ln.id)) for ln in lanes]
    finally:
        pool.close()
    cfg = bench.pipeline_config(config, "cpu")
    outs = drv.outputs()
    per_turn = [bench.profiled_rounds(config, cfg, [t], lanes, outs, plans)
                for t in drv.turns]
    assert [len(r) for r in per_turn] == ran
    rounds = [r for rs in per_turn for r in rs]
    assert {r.e for r in rounds} == {128, 512, 2048}
    assert all(r.xy.shape[1] == r.e for r in rounds)
    assert sum(int(r.valid.sum()) for r in rounds) == sum(
        ln.delivered for ln in lanes)
    assert sum(int(r.keep.sum()) for r in rounds) == sum(
        int(o[1].sum()) for o in outs)
    assert sum(r.due for r in rounds) == sum(
        len(pl) // cfg.lut_every_chunks for pl, _ in plans)
