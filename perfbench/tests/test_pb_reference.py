"""The plain reference against the port's plain path on the CPU: the same
streams served by a ``repro_torch`` pool on CPU tensors give the same kept
flags, the same scored events, scores within float32 rounding, and the
same books; the frozen threefry equals the port's draw."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from perfbench.lib import bench, check, streams  # noqa: E402
from perfbench.lib import manifest  # noqa: E402
from perfbench.lib.manifest import load_json  # noqa: E402
from perfbench.reference import detector, threefry  # noqa: E402
from perfbench.tests import _tiny  # noqa: E402

CONFIG = _tiny.davis_config()
HD = load_json(REPO / "perfbench" / "configs" / "hd720_x4_dvfs.json")


def _config(**pipeline):
    cfg = {**CONFIG, "pipeline": {**CONFIG["pipeline"], **pipeline}}
    return cfg


def _serve(config, lanes, seeds, slab):
    """Feed every lane in slabs through a CPU pool; outputs and stats."""
    from repro_torch.serve import DetectorPool
    pool = DetectorPool(bench.pipeline_config(config, "cpu"), len(lanes),
                        shard=False, **config["pool"])
    try:
        ids = [pool.connect(seed=s) for s in seeds]
        n = min(len(ln.ts) for ln in lanes) // slab * slab
        outs = [[] for _ in ids]
        for start in range(0, n, slab):
            for i, lane in zip(ids, lanes):
                pool.feed(i, *lane.take(start, start + slab))
            pool.pump()
            for i in ids:
                outs[i].append(pool.poll(i))
        stats = [pool.stats(i) for i in ids]
    finally:
        pool.close()
    return n, [(np.concatenate([o[0] for o in v]),
                np.concatenate([o[1] for o in v])) for v in outs], stats


@pytest.mark.parametrize("pipeline", [
    {},
    {"patch": 5, "lut_every_chunks": 3, "chunk": 256},
    {"dvfs": False, "dvfs_online": False, "inject_ber": False, "vdd": 1.2},
    {"dvfs": False, "dvfs_online": False, "vdd": 0.6, "stcf_enabled": False},
], ids=["davis240", "patch5_every3_chunk256", "fixed_1v2_no_ber",
        "fixed_0v6_ber_no_stcf"])
def test_reference_equals_port_pool(pipeline):
    config = _config(**pipeline)
    lanes, seeds = streams.lane_streams(
        {**config["stream"], "duration_us": 40_000}, config["sensor"], 2,
        seed=2**31 + 12345)
    n, outs, stats = _serve(config, lanes, seeds, slab=2048)
    ref = detector.Reference(check.params(config), seeds).run(
        [ln.take(0, n)[0] for ln in lanes],
        [ln.take(0, n)[1] for ln in lanes])
    got = check.compare(config, [n, n], outs, stats, ref)
    assert got["kept_differ"]["value"] == 0
    assert got["score_inf_differ"]["value"] == 0
    assert got["count_differ"]["value"] == 0
    assert got["undelivered"]["value"] == 0
    assert got["score_gap"]["value"] < 1e-5
    assert got["books_gap"]["value"] < 1e-12
    assert got["device_books_gap"]["value"] == 0
    # every chunk ran at the table's first point: 0.6 V on DVFS
    assert all(r.kept.any() and (r.vdd_idx == 0).all() for r in ref)


def test_threefry_equals_port_draw():
    from repro_torch.core import prng
    for seed in (0, 1, 2**31 - 1, 977):
        key = prng.prng_key(seed)
        subs = threefry.key_chain([seed], 3)[0]
        for c in range(3):
            key, sub = prng.split(key)
            assert [int(v) for v in sub] == [int(v) for v in subs[c]]
        want = prng.random_bits(sub, (7, 11, 5)).reshape(-1)
        k0, k1 = (torch.tensor(int(v)) for v in subs[2])
        got = threefry.words_torch(k0, k1, torch.arange(7 * 11 * 5))
        assert torch.equal(got, want)


def test_operating_points_follow_the_rate():
    """A stream whose rate climbs moves the pick up the table, as the
    paper's 3-counter estimator does, and stays at 0.6 V at the cells'
    rates."""
    p = dataclasses.replace(check.params(CONFIG), chunk=64)
    ts = np.sort(np.concatenate([np.arange(0, 20_000, 4),
                                 20_000 + np.arange(0, 100_000) // 5]))
    ts = ts[:len(ts) // 64 * 64]
    idx = detector.operating_points(p, ts.astype(np.int64))
    assert idx[0] == 0 and idx.max() > 0 and (np.diff(idx[:10]) == 0).all()


@pytest.mark.parametrize("size", [(180, 240, 0.25, 0.02, 3), (720, 1280,
                                                               None, None, 12)],
                         ids=["davis240", "hd720"])
def test_shapes_generator_equals_port_stream(size):
    """The frozen generator gives the port's ``shapes_stream`` event for
    event (the HD config's rates, on a short stretch)."""
    from repro_torch.events import synthetic
    h, w, sig, noise, n_shapes = size
    st = HD["stream"]
    kw = {"duration_us": 3_000, "n_shapes": n_shapes,
          "signal_rate_per_us": sig or st["signal_rate_per_us"],
          "noise_rate_per_us": noise or st["noise_rate_per_us"]}
    gen = manifest.generator("shapes").generate
    for seed in (0, 2**31 + 7):
        xy, ts = gen(height=h, width=w, seed=seed, **kw)
        want = synthetic.shapes_stream(height=h, width=w, seed=seed, **kw)
        assert np.array_equal(xy, want.xy) and np.array_equal(ts, want.ts)


def test_hd_rate_picks_above_the_floor():
    """At the HD config's rate the reference's DVFS runs the first 5 ms of
    camera time at 0.6 V (no history) and the rest above it, at 0.8 V."""
    p = check.params(HD)
    lanes, _ = streams.lane_streams(HD["stream"], HD["sensor"], 1, seed=5)
    ts = lanes[0].take(0, 250 * 512)[1]
    idx = detector.operating_points(p, ts)
    volts = detector.table(p)["vdd"][idx]
    assert volts[0] == 0.6 and (volts[-50:] == 0.8).all()
