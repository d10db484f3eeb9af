"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device.  This module imports
no jax, so it also runs on a GPU host without the JAX reference:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ber as t_ber  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.stcf import NEVER  # noqa: E402
from repro_torch.core import pipeline  # noqa: E402
from repro_torch.core import state as t_state  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402
from repro_torch.kernels import compact, fused_step, harris_conv, ops  # noqa: E402,E501
from repro_torch.kernels import tos_update  # noqa: E402
from repro_torch.obs.schema import WALL_TIME_KEYS  # noqa: E402
from repro_torch.serve import DetectorPool  # noqa: E402
from repro_torch.serve.runtime import PoolRuntime  # noqa: E402

pytestmark = pytest.mark.cuda
REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


def _lanes(rng, b, h, w, e):
    tos = np.zeros((b, h, w), np.uint8)
    hot = rng.random((b, h, w)) < 0.3
    tos[hot] = rng.integers(225, 256, hot.sum())
    sae = np.full((b, h, w), NEVER, np.int32)
    seen = rng.random((b, h, w)) < 0.4
    sae[seen] = rng.integers(0, 30_000, seen.sum())
    lut = rng.standard_normal((b, h, w)).astype(np.float32)
    c = rng.integers(0, (w, h), (b, 6, 2))
    pick = c[np.arange(b)[:, None], rng.integers(0, 6, (b, e))]
    xy = np.clip(pick + rng.integers(-5, 6, (b, e, 2)), 0, (w - 1, h - 1))
    ts = np.sort(rng.integers(20_000, 40_000, (b, e)), axis=1)
    valid = np.arange(e)[None].repeat(b, 0) < e - 9
    return [torch.from_numpy(a) for a in
            (tos, sae, lut, xy.astype(np.int32), ts.astype(np.int32), valid)]


@pytest.mark.parametrize("patch", [5, 7])
@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("stcf_enabled", [True, False])
def test_fused_kernel_matches_plain(cuda, patch, inject, stcf_enabled):
    rng = np.random.default_rng(patch + 2 * inject)
    b, h, w = 2, 180, 240
    ins = [t.to(cuda) for t in _lanes(rng, b, h, w, 512)]
    ber = torch.tensor([0.025, 0.0], device=cuda)
    bits = (t_ber.write_error_bits(
        torch.stack([prng.prng_key(s, device=cuda) for s in range(b)]),
        (h, w), ber) if inject else None)
    kw = dict(patch=patch, th=225, support=2, tw=5000,
              stcf_enabled=stcf_enabled)
    plain = fused_step.fused_step_ref(*ins, ber, bits, **kw)
    before = ops.LAUNCHES["fused_step"]
    got = ops.fused_step_op(*ins, ber, bits, **kw)
    assert ops.LAUNCHES["fused_step"] == before + 1
    for name, p, g in zip(("tos", "sae", "keep", "scores"), plain, got):
        assert torch.equal(p, g), name


# K1 in place (``fused_step_cuda_``) and under a lane mask: (B, H, W, E,
# patch, layout, stcf_enabled, masked), each with BER off, on, and 0 in
# every other lane.
_K1_CASES = [
    (1, 720, 1280, 512, 7, "clusters", True, False),
    (4, 180, 240, 512, 7, "clusters", True, True),
    (2, 37, 101, 300, 7, "spread", True, False),
    (1, 720, 330, 512, 9, "clusters", True, True),
    (1, 180, 240, 512, 31, "clusters", True, False),
    (1, 720, 1280, 8192, 7, "one_tile", True, False),
    (2, 180, 240, 512, 7, "clusters", False, True),
    (16, 180, 240, 512, 7, "clusters", True, True),
]


def _k1_case(rng, b, h, w, e, layout):
    tos = np.where(rng.random((b, h, w)) < 0.3,
                   rng.integers(225, 256, (b, h, w)), 0).astype(np.uint8)
    sae = np.full((b, h, w), NEVER, np.int32)
    seen = rng.random((b, h, w)) < 0.4
    sae[seen] = rng.integers(0, 30_000, seen.sum())
    lut = rng.standard_normal((b, h, w)).astype(np.float32)
    if layout == "spread":
        xy = np.stack([rng.integers(0, w, (b, e)),
                       rng.integers(0, h, (b, e))], -1)
    elif layout == "clusters":
        c = rng.integers(0, (w, h), (b, 8, 2))
        pick = c[np.arange(b)[:, None], rng.integers(0, 8, (b, e))]
        xy = np.clip(pick + rng.integers(-6, 7, (b, e, 2)), 0,
                     (w - 1, h - 1))
    else:   # every event in a 12 x 12 square inside one 64x64 tile
        xy = np.array([90, 26]) + rng.integers(0, 12, (b, e, 2))
    ts = np.sort(rng.integers(25_000, 40_000, (b, e)), axis=1)
    valid = rng.random((b, e)) < 0.9
    return [torch.from_numpy(a) for a in
            (tos, sae, lut, xy.astype(np.int32), ts.astype(np.int32), valid)]


@pytest.mark.parametrize("ber_mode", ["off", "on", "some 0"])
@pytest.mark.parametrize("case", _K1_CASES,
                         ids=lambda c: "B{}-{}x{}-E{}-p{}-{}-{}{}".format(
                             *c[:6], "stcf" if c[6] else "nostcf",
                             "-masked" if c[7] else ""))
def test_fused_kernel_in_place_and_masked(cuda, case, ber_mode):
    """K1 in place and functional, with and without a lane mask, against
    ``fused_step_ref`` bit for bit; masked lanes come out byte-identical
    and the functional call leaves its inputs alone."""
    b, h, w, e, patch, layout, stcf, masked = case
    rng = np.random.default_rng(b * 1000 + e + patch)
    ins = [t.to(cuda) for t in _k1_case(rng, b, h, w, e, layout)]
    rate = [0.025 if ber_mode == "on" or i % 2 == 0 else 0.0
            for i in range(b)]
    ber = torch.tensor(rate, device=cuda)
    bits = None if ber_mode == "off" else t_ber.write_error_bits(
        torch.stack([prng.prng_key(s, device=cuda) for s in range(b)]),
        (h, w), ber)
    mask = (torch.arange(b, device=cuda) % 4 != 1) if masked else None
    kw = dict(patch=patch, th=225, support=2, tw=5000, stcf_enabled=stcf,
              mask=mask)
    plain = fused_step.fused_step_ref(*ins, ber, bits, **kw)
    before = [t.clone() for t in ins[:2]]
    got = fused_step.fused_step_cuda(*ins, ber, bits, **kw)
    tos, sae = ins[0].clone(), ins[1].clone()
    got_ = fused_step.fused_step_cuda_(tos, sae, *ins[2:], ber, bits, **kw)
    torch.cuda.synchronize()
    assert got_[0] is tos and got_[1] is sae
    for t, t0 in zip(ins[:2], before):
        assert torch.equal(t, t0)
    for out in (got, got_):
        for name, p, g in zip(("tos", "sae", "keep", "scores"), plain, out):
            assert torch.equal(p, g), name
        if masked:
            for g, t0 in zip(out[:2], before):
                assert torch.equal(g[~mask], t0[~mask])


@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("hw", [(37, 101), (180, 240), (720, 1280)])
@pytest.mark.parametrize("window", [1, 3, 5, 7])
@pytest.mark.parametrize("sobel", [3, 5, 7])
def test_harris_kernel_bit_equal(cuda, sobel, window, hw, b):
    """K2 against ``harris_ref`` at every Sobel and window size it is
    built for, bit for bit (the float32 words compared as int32)."""
    rng = np.random.default_rng(sobel * 10 + window + hw[0] + b)
    tos = rng.integers(0, 256, (b, *hw))
    tos = torch.from_numpy(np.where(tos >= 225, tos, 0).astype(np.uint8))
    kw = dict(sobel_size=sobel, window_size=window)
    plain = harris_conv.harris_ref(tos.to(cuda), **kw)
    got = harris_conv.harris_cuda(tos.to(cuda), **kw)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))


def test_harris_sobel_1_refused(cuda):
    """A Sobel size of 1 has no odd operator (``sobel_kernels(1)`` is
    1 x 2): the plain version fails on its shapes and K2 refuses it."""
    tos = torch.zeros((1, 37, 101), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):
        harris_conv.harris_cuda(tos, sobel_size=1)
    with pytest.raises(RuntimeError):
        harris_conv.harris_ref(tos, sobel_size=1)


@pytest.mark.parametrize("hw", [(180, 240), (720, 1280), (37, 101)])
def test_harris_kernel_matches_plain(cuda, hw):
    rng = np.random.default_rng(hw[0])
    tos = rng.integers(0, 256, (2, *hw))
    tos = torch.from_numpy(np.where(tos >= 225, tos, 0).astype(np.uint8))
    plain = harris_conv.harris_ref(tos.to(cuda))
    got = harris_conv.harris_cuda(tos.to(cuda))
    err = (got - plain).abs().max().item()
    assert err <= REL * plain.abs().max().item()


@pytest.mark.parametrize("e,cap", [(128, 1), (512, 64), (512, 512),
                                   (4096, 512), (8192, 8192)])
@pytest.mark.parametrize("density", [0.0, 0.05, 1.0])
def test_compact_kernel_matches_plain(cuda, e, cap, density):
    rng = np.random.default_rng(e + cap)
    scores = torch.from_numpy(
        rng.standard_normal((3, 5, e)).astype(np.float32)).to(cuda)
    keep = torch.from_numpy(rng.random((3, 5, e)) < density).to(cuda)
    flat = (scores.reshape(15, e), keep.reshape(15, e))
    plain = compact.compact_ref(*flat, cap=cap)
    before = ops.LAUNCHES["compact"]
    got = ops.compact_slots_op(scores, keep, cap=cap)
    assert ops.LAUNCHES["compact"] == before + 1
    for name, p, g in zip(("idx", "val", "count"), plain, got):
        assert torch.equal(p, g.reshape(p.shape)), name


# (rounds, lanes, E) of the ring-push cases: one slot, a ragged row (scalar
# copies), the pool's shapes, the longest chunk, a wide pool.
_PUSH_SHAPES = [(1, 1, 37), (3, 4, 512), (8, 16, 512), (2, 3, 8192),
                (3, 64, 37)]


def _push_rows(rng, lanes, e, dev, step, offset):
    """One round's lane rows on ``dev``: push 0 keeps nothing, push 1
    everything; with ``offset`` each row tensor starts one element into
    its buffer, so no row is 16-byte aligned."""
    density = {0: 0.0, 1: 1.0}.get(step, rng.random((lanes, 1)))
    keep = rng.random((lanes, e)) < density
    rows = (rng.standard_normal((lanes, e)).astype(np.float32), keep,
            keep.sum(-1).astype(np.int32),
            rng.integers(0, 9, lanes).astype(np.int32),
            rng.integers(0, e + 1, lanes).astype(np.int32),
            rng.random(lanes) < 0.7)
    out = []
    for a in rows:
        t = torch.from_numpy(a)
        buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)
        view = buf[offset:].view(t.shape)
        out.append(view.copy_(t))
    return out


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("cap", ["dense", 1, "E/8", "E"])
@pytest.mark.parametrize("rounds,lanes,e", _PUSH_SHAPES)
def test_ring_push_kernel_matches_plain(cuda, rounds, lanes, e, cap, offset):
    """K3's ring push (one launch through ``ops.ring_push_op``) against the
    plain push on the card, after every push of a sequence that wraps the
    ring and passes a drain's reset: every leaf, records and cursors
    included, bit for bit."""
    cap = {"dense": None, "E/8": e // 8, "E": e}.get(cap, cap)

    def make():
        if cap is None:
            return t_state.ring_init(rounds, lanes, e, device=cuda)
        return t_state.compact_ring_init(rounds, lanes, e, cap, device=cuda)

    got, want = make(), make()
    rng = np.random.default_rng(rounds * 1000 + lanes * 10 + e)
    for step in range(2 * rounds + 3):
        if step == rounds + 1:
            PoolRuntime._reset_ring(got)
            PoolRuntime._reset_ring(want)
        rows = _push_rows(rng, lanes, e, cuda, step, offset)
        before = ops.LAUNCHES["compact"]
        assert ops.ring_push_op(got, *rows) is got
        assert ops.LAUNCHES["compact"] == before + 1
        compact.ring_push_ref(want, *rows)
        torch.cuda.synchronize()
        for name in type(got)._fields:
            assert torch.equal(getattr(got, name), getattr(want, name)), (
                name, step)
    assert int(got.dropped) > 0


# Every mode at three sizes, the binned ones also with a cap below the
# busiest 128-tile's hits.
_TOS_CASES = [
    dict(mode=mode, cap=cap, hw=hw)
    for hw in ((180, 240), (720, 1280), (37, 101))
    for mode, cap in (*((m, "lossless") for m in sorted(ops.TOS_MODES)),
                      ("nmc_binned", "truncating"),
                      ("batched_binned", "truncating"))]
# K4-K7 on the edge cases of the 64x64 tiles of csrc/tos_update.cu and
# csrc/tos_count.cu: (hw, B, E, patch, event layout, background below th),
# each through K5 and K7, and K4 and K6, with cap E, 1 and half the busiest
# 128-tile's hits.
_TOS_EDGE = (
    ((720, 1280), 1, 1, 7, "spread", False),
    ((720, 1280), 1, 300, 7, "clusters", False),
    ((720, 1280), 1, 8192, 7, "clusters", False),
    ((180, 240), 1, 512, 1, "clusters", False),
    ((180, 240), 1, 512, 3, "clusters", False),
    ((180, 240), 1, 512, 31, "clusters", False),
    ((720, 1280), 1, 8192, 7, "one_tile", False),
    ((37, 101), 2, 300, 7, "spread", False),
    ((720, 330), 1, 512, 9, "clusters", False),
    ((720, 1280), 4, 300, 5, "clusters", False),
    ((180, 240), 2, 512, 7, "clusters", True),
)
_TOS_CASES += [
    dict(mode=mode, cap=cap, hw=hw, b=b, e=e, patch=patch, layout=layout,
         below_th=below)
    for hw, b, e, patch, layout, below in _TOS_EDGE
    for kind in ("batched", "nmc")
    for mode, cap in ((kind, "lossless"), (f"{kind}_binned", "lossless"),
                      (f"{kind}_binned", "one"),
                      (f"{kind}_binned", "truncating"))]


def _edge_inputs(rng, b, h, w, e, layout, below_th, th=225):
    """``spread`` (uniform), ``clusters`` (eight centres, +-6 px) or
    ``one_tile`` (every event in a 12 x 12 square on 64-tile borders inside
    one 128-tile: cover counts in the thousands); a uniform 0..255
    background when ``below_th``."""
    tos = rng.integers(0, 256, (b, h, w))
    if not below_th:
        tos = np.where(rng.random((b, h, w)) < 0.3,
                       rng.integers(th, 256, (b, h, w)), 0)
    if layout == "spread":
        xy = np.stack([rng.integers(0, w, (b, e)),
                       rng.integers(0, h, (b, e))], -1)
    elif layout == "clusters":
        c = rng.integers(0, (w, h), (b, 8, 2))
        pick = c[np.arange(b)[:, None], rng.integers(0, 8, (b, e))]
        xy = np.clip(pick + rng.integers(-6, 7, (b, e, 2)), 0,
                     (w - 1, h - 1))
    else:
        xy = np.array([186, 58]) + rng.integers(0, 12, (b, e, 2))
    valid = rng.random((b, e)) < 0.9
    valid[:, 0] = True
    return [torch.from_numpy(a) for a in
            (tos.astype(np.uint8), xy.astype(np.int32), valid)]


def _case_id(case):
    h, w = case["hw"]
    tail = ("-B{b}-E{e}-p{patch}-{layout}".format(**case)
            + ("-below_th" if case["below_th"] else "")) if "e" in case else ""
    return f"{case['mode']}-{case['cap']}-{h}x{w}{tail}"


@pytest.mark.parametrize("case", _TOS_CASES, ids=_case_id)
def test_tos_update_kernels_match_plain(cuda, case):
    """K4-K7 on the card equal their plain versions; the binned modes also
    with a ``cap`` below the busiest 128-tile's hit count (and K6/K7 with
    cap 1), all four also on the edge cases of their tiling."""
    mode, cap, hw = case["mode"], case["cap"], case["hw"]
    rng = np.random.default_rng(hw[0] + len(mode) + case.get("e", 0))
    if "e" in case:
        patch = case["patch"]
        tos, xy, valid = (t.to(cuda) for t in _edge_inputs(
            rng, case["b"], *hw, case["e"], case["layout"],
            case["below_th"]))
    else:
        patch = 7
        tos, _, _, xy, _, valid = (t.to(cuda)
                                   for t in _lanes(rng, 3, *hw, 512))
    kw = dict(patch=patch, th=225)
    name = ops.TOS_MODES[mode]
    extra = ()
    if mode.startswith("batched"):
        extra = (ops.centre_surface(hw, xy, valid, **kw),)
    if cap == "lossless":
        plain = getattr(tos_update, f"{name}_ref")(tos, xy, valid, *extra,
                                                   **kw)
        before = ops.LAUNCHES[mode]
        got = ops.tos_update_op(tos, xy, valid, mode=mode, **kw)
        assert ops.LAUNCHES[mode] == before + 1
    else:
        bins, _ = tos_update.bin_events_to_tiles(
            xy, valid, grid_hw=tos_update._grid(*hw), patch=patch,
            cap=xy.shape[1])
        c = 1 if cap == "one" else max(1, int(bins[..., 2].sum(-1).max())
                                       // 2)
        plain = getattr(tos_update, f"{name}_ref")(tos, xy, valid, *extra,
                                                   cap=c, **kw)
        got = getattr(tos_update, f"{name}_cuda")(tos, xy, valid, *extra,
                                                  cap=c, **kw)
    assert torch.equal(plain, got)


def _serve_two_lanes(device, backend="fused", readout="compact", **pool_kw):
    cfg = pipeline.PipelineConfig(
        height=180, width=240, chunk=512, lut_every_chunks=2, dvfs=True,
        dvfs_online=True, inject_ber=True, device=device, backend=backend)
    streams = [synthetic.shapes_stream(duration_us=60_000, seed=s)
               for s in (0, 1)]
    pool = DetectorPool(cfg, 2, ring_rounds=4, readout=readout, **pool_kw)
    lanes = [pool.connect(seed=s) for s in (0, 1)]
    outs = {0: [], 1: []}
    for start in range(0, 6000, 1500):
        for i, lane in enumerate(lanes):
            pool.feed(lane, streams[i].xy[start:start + 1500],
                      streams[i].ts[start:start + 1500])
        pool.pump()
        for i, lane in enumerate(lanes):
            outs[i].append(pool.poll(lane))
    for i, lane in enumerate(lanes):
        outs[i].append(pool.flush(lane))
    stats = pool.pool_stats()
    pool.close()
    return ({i: [np.concatenate(x) for x in zip(*o)] for i, o in
             outs.items()}, stats)


def _assert_pool_cuda_equals_cpu(backend, used):
    ops.reset_launch_counts()
    got, gstats = _serve_two_lanes("cuda", backend)
    assert min(ops.LAUNCHES[k] for k in used) > 0, ops.LAUNCHES
    want, wstats = _serve_two_lanes("cpu", backend)
    for i in (0, 1):
        np.testing.assert_array_equal(got[i][1], want[i][1])
        fin = np.isfinite(want[i][0])
        np.testing.assert_array_equal(np.isfinite(got[i][0]), fin)
        err = np.abs(got[i][0][fin] - want[i][0][fin]).max()
        assert err <= REL * np.abs(want[i][0][fin]).max()
    assert gstats["h2d_pinned_staging"] and not wstats["h2d_pinned_staging"]
    for key in wstats:
        if key not in WALL_TIME_KEYS and key != "h2d_pinned_staging":
            assert gstats[key] == wstats[key], key


def test_pool_on_cuda_equals_cpu(cuda):
    """A 2-lane pool (online DVFS with BER, compact readout, async drain)
    on the card equals the same pool on the CPU: kept masks exact, scores
    within ``1e-5 * max|R|``, stats equal apart from wall-clock keys."""
    _assert_pool_cuda_equals_cpu("fused", ("fused_step", "harris",
                                           "compact"))


def test_pool_batched_backend_on_cuda_equals_cpu(cuda):
    """The same on backend ``"batched"``: K5, K2 and K3 on the card."""
    _assert_pool_cuda_equals_cpu("batched", ("batched", "harris", "compact"))


@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_pool_round_pushes_with_one_launch(cuda, readout):
    """Every pool round is one K3 ring-push launch, in both readouts."""
    ops.reset_launch_counts()
    _, stats = _serve_two_lanes("cuda", readout=readout)
    assert ops.LAUNCHES["compact"] == stats["rounds_executed"] > 0


@pytest.mark.parametrize("shards", [1, 2])
def test_sharded_pool_on_cuda_equals_unsharded(cuda, shards, monkeypatch):
    """``shard=True`` on the card: a 1-wide lane mesh, and a 2-shard mesh
    that repeats ``cuda:0`` (the split, the per-shard launches and the
    gather, all on the card), bit-equal to the unsharded pool on the card;
    ``pool_stats()`` equal apart from ``sharded`` / ``devices``; one K3
    push per round and shard."""
    from repro_torch.launch import sharding
    mesh = sharding.LaneMesh((torch.device("cuda", 0),) * shards)
    monkeypatch.setattr(sharding, "local_lane_mesh", lambda *a, **k: mesh)
    want, wstats = _serve_two_lanes("cuda", shard=False)
    ops.reset_launch_counts()
    got, gstats = _serve_two_lanes("cuda", shard=True)
    for i in (0, 1):
        for g, w in zip(got[i], want[i]):
            np.testing.assert_array_equal(g, w)
    assert gstats["sharded"] and gstats["devices"] == shards
    assert ops.LAUNCHES["compact"] == shards * gstats["rounds_executed"] > 0
    for key in wstats:
        if key not in WALL_TIME_KEYS | {"sharded", "devices"}:
            assert gstats[key] == wstats[key], key


def _serve_adaptive(device, readout):
    """Three online-DVFS lanes with BER under ``policy="adaptive"`` on
    ramps that move them between buckets, one shedding and one capped."""
    cfg = pipeline.PipelineConfig(
        height=180, width=240, chunk=128, lut_every_chunks=2, dvfs=True,
        dvfs_online=True, inject_ber=True, device=device)
    half = cfg.dvfs_cfg.half_us
    rates = ([100] * 3 + [1500] * 5 + [400] * 4,
             [400] * 4 + [100] * 5 + [1500] * 3,
             [100] * 12)
    streams = [synthetic.ramp_stream(r, half, seed=s)
               for s, r in enumerate(rates)]
    pool = DetectorPool(cfg, 3, ring_rounds=4, buckets=(128, 512, 2048),
                        policy="adaptive", migrate_patience=2,
                        readout=readout)
    lanes = [pool.connect(seed=s, chunk=128) for s in range(3)]
    pool.set_lane_control(lanes[1], lut_every=3, shed=True)
    pool.set_lane_control(lanes[2], vdd_cap=0)
    outs = {i: [] for i in range(3)}
    for j in range(12):
        for i, lane in enumerate(lanes):
            m = (streams[i].ts // half) == j
            pool.feed(lane, streams[i].xy[m], streams[i].ts[m])
        pool.pump()
        for i, lane in enumerate(lanes):
            outs[i].append(pool.poll(lane))
    for i, lane in enumerate(lanes):
        outs[i].append(pool.flush(lane))
    logs = [pool.stats(lane)["migration_log"] for lane in lanes]
    stats = pool.pool_stats()
    pool.close()
    return ({i: [np.concatenate(x) for x in zip(*o)] for i, o in
             outs.items()}, logs, stats)


@pytest.mark.parametrize("readout", ["dense", "compact"])
def test_adaptive_pool_on_cuda_equals_cpu(cuda, readout):
    """The adaptive pool on the card equals the same pool on the CPU:
    migration logs, kept masks and stats exact, scores within
    ``1e-5 * max|R|``, K1-K3 launched, one ring push per round."""
    ops.reset_launch_counts()
    got, glogs, gstats = _serve_adaptive("cuda", readout)
    assert min(ops.LAUNCHES[k] for k in ("fused_step", "harris",
                                         "compact")) > 0, ops.LAUNCHES
    assert ops.LAUNCHES["compact"] == gstats["rounds_executed"]
    want, wlogs, wstats = _serve_adaptive("cpu", readout)
    assert glogs == wlogs and len(glogs[0]) >= 2 and len(glogs[1]) >= 2
    for i in want:
        np.testing.assert_array_equal(got[i][1], want[i][1])
        fin = np.isfinite(want[i][0])
        np.testing.assert_array_equal(np.isfinite(got[i][0]), fin)
        if fin.any():
            err = np.abs(got[i][0][fin] - want[i][0][fin]).max()
            assert err <= REL * np.abs(want[i][0][fin]).max()
    assert gstats["shed_events_total"] > 0
    for key in wstats:
        if key not in WALL_TIME_KEYS and key != "h2d_pinned_staging":
            assert gstats[key] == wstats[key], key


def _serve_policy(device, policy, readout="dense"):
    """Under ``policy="ladder"``: a standard and a premium lane (online
    DVFS with BER) through a 2x burst on a one-round budget, then the
    recovery recipe; under ``"pack"``: three sparse lanes over buckets
    128 / 512 / 2048.  Returns per-lane outputs, the level after each
    pass, the lanes' stats and ``pool_stats()``."""
    from repro_torch.serve.scheduler import LadderConfig
    cfg = pipeline.PipelineConfig(
        height=180, width=240, chunk=128, lut_every_chunks=2, dvfs=True,
        dvfs_online=True, inject_ber=True, device=device)
    half = cfg.dvfs_cfg.half_us
    if policy == "ladder":
        streams = [synthetic.burst_stream(600, 12, half, burst_factor=2.0,
                                          seed=s) for s in (0, 1)]
        chunks, qos = (128, 128), ("standard", "premium")
        pool = DetectorPool(cfg, 2, buckets=(128,), policy="ladder",
                            ladder=LadderConfig(patience=1,
                                                recover_patience=1),
                            ring_rounds=2, drain_mode="sync",
                            readout=readout)
    else:
        streams = [synthetic.ramp_stream([150] * 12, half, seed=s)
                   for s in range(3)]
        chunks, qos = (128, 512, 2048), ("standard",) * 3
        pool = DetectorPool(cfg, 3, buckets=(128, 512, 2048),
                            policy="pack", migrate_patience=2,
                            ring_rounds=4, drain_mode="sync",
                            readout=readout)
    lanes = [pool.connect(seed=s, chunk=c, qos=q)
             for s, (c, q) in enumerate(zip(chunks, qos))]
    outs = {i: [] for i in range(len(lanes))}
    levels = []
    for j in range(12):
        for i, lane in enumerate(lanes):
            m = (streams[i].ts // half) == j
            pool.feed(lane, streams[i].xy[m], streams[i].ts[m])
        pool.pump_rounds(1 if policy == "ladder" else None)
        levels.append(pool.pool_stats().get("ladder_level"))
        for i, lane in enumerate(lanes):
            outs[i].append(pool.poll(lane, wait=policy == "pack"))
    for _ in range(20 if policy == "ladder" else 0):
        pool.pump()
        levels.append(pool.pool_stats()["ladder_level"])
        if levels[-1] == 0:
            break
    for i, lane in enumerate(lanes):
        outs[i].append(pool.flush(lane))
    stats = [pool.stats(lane) for lane in lanes]
    ps = pool.pool_stats()
    pool.close()
    return ({i: [np.concatenate(x) for x in zip(*o)] for i, o in
             outs.items()}, levels, stats, ps)


@pytest.mark.parametrize("policy,readout", [("ladder", "dense"),
                                            ("ladder", "compact"),
                                            ("pack", "dense")])
def test_ladder_and_pack_pools_on_cuda_equal_cpu(cuda, policy, readout):
    """A 2-lane ladder pool and a 3-bucket pack pool on the card equal the
    same pools on the CPU: levels, tiers, knobs, migration logs, kept
    masks and stats exact, scores within ``1e-5 * max|R|``; K1-K3
    launched, one ring push per round."""
    ops.reset_launch_counts()
    got, glev, gstats, gps = _serve_policy("cuda", policy, readout)
    assert min(ops.LAUNCHES[k] for k in ("fused_step", "harris",
                                         "compact")) > 0, ops.LAUNCHES
    assert ops.LAUNCHES["compact"] == gps["rounds_executed"]
    want, wlev, wstats, wps = _serve_policy("cpu", policy, readout)
    assert glev == wlev
    if policy == "ladder":
        assert max(glev) == 3 and glev[-1] == 0
        assert gps["shed_events_total"] > 0
    else:
        assert gps["pack_moves"] > 0 and gps["pack_saved_slots"] > 0
    for g, w in zip(gstats, wstats):
        for key in ("ladder_tier", "ctrl_lut_every", "ctrl_vdd_cap",
                    "ctrl_shed", "bucket", "migration_log", "kept_total",
                    "shed_events"):
            assert g[key] == w[key], key
    for i in want:
        np.testing.assert_array_equal(got[i][1], want[i][1])
        fin = np.isfinite(want[i][0])
        np.testing.assert_array_equal(np.isfinite(got[i][0]), fin)
        if fin.any():
            err = np.abs(got[i][0][fin] - want[i][0][fin]).max()
            assert err <= REL * np.abs(want[i][0][fin]).max()
    for key in wps:
        if key not in WALL_TIME_KEYS and key != "h2d_pinned_staging":
            assert gps[key] == wps[key], key


_CLI_RUNS = {
    "static": ["--policy", "static"],
    "adaptive": ["--policy", "adaptive", "--buckets", "64,256,1024",
                 "--connect-chunk", "64", "--migrate-patience", "1"],
    "ladder_compact": ["--policy", "ladder", "--burst-factor", "2",
                       "--qos", "standard,premium", "--slab", "1024",
                       "--readout", "compact"],
}


@pytest.mark.parametrize("name", sorted(_CLI_RUNS))
def test_serving_cli_on_cuda_equals_cpu(cuda, name, tmp_path, capsys):
    """``serve_events.main`` on the card and on the CPU: equal metrics
    records apart from wall clocks and an equal report apart from times;
    the card run pushes one K3 launch per pool round."""
    import re
    from repro_torch.launch import serve_events
    from repro_torch.obs import read_jsonl
    from repro_torch.obs.schema import steady_record
    local = re.compile(r"^(served|round latency|pump drain wait|metrics "
                       r"trail|  \[pool:)")
    out = {}
    for dev in ("cuda", "cpu"):
        path = tmp_path / f"{dev}.jsonl"
        ops.reset_launch_counts()
        serve_events.main(["--sessions", "2", "--duration-us", "6000",
                           "--dvfs", *_CLI_RUNS[name], "--device", dev,
                           "--metrics-out", str(path)])
        lines = capsys.readouterr().out.splitlines()
        out[dev] = ([steady_record(r) for r in read_jsonl(path)],
                    [ln for ln in lines
                     if not local.match(ln) and "rate est" not in ln],
                    [re.sub(r"rate est .*?\), ", "", ln) for ln in lines
                     if "rate est" in ln], dict(ops.LAUNCHES))
    assert out["cuda"][:3] == out["cpu"][:3]
    rounds = out["cuda"][0][-1]["metrics"]["rounds_executed"]
    assert out["cuda"][3]["compact"] == rounds
    assert out["cuda"][3]["fused_step"] > 0


def test_loader_chunks_and_close_on_cuda(cuda):
    """The loader's chunks on the card equal ``chunk_iterator``'s after the
    rebase, each item fresh tensors; a half-consumed loader closes within
    5 s with its worker dead."""
    import time
    from repro_torch.events import stream as stream_mod
    st = synthetic.shapes_stream(duration_us=20_000, seed=4)
    want = list(stream_mod.chunk_iterator(st, 256))
    with stream_mod.PrefetchingLoader(st, 256, rebase_us=100,
                                      device=cuda) as loader:
        got = list(loader)
    assert len(got) == len(want)
    for (gx, gt, gv), (wx, wt, wv) in zip(got, want):
        assert gx.is_cuda and gt.dtype == torch.int32
        np.testing.assert_array_equal(gx.cpu().numpy(), wx)
        np.testing.assert_array_equal(gt.cpu().numpy(),
                                      (wt - 100).astype(np.int32))
        np.testing.assert_array_equal(gv.cpu().numpy(), wv)
    assert len({t.data_ptr() for item in got for t in item}) == 3 * len(got)
    half = stream_mod.PrefetchingLoader(st, 64, depth=1, device=cuda)
    next(half)
    t0 = time.perf_counter()
    half.close()
    assert time.perf_counter() - t0 < 5.0 and not half._thread.is_alive()


@pytest.mark.parametrize("backend", ["nmc", "batched"])
def test_device_feed_and_oracle_on_cuda_equal_scan(cuda, backend):
    """The device-slab feed and the host-loop oracle (K4 / K5 + K2) on the
    card give the scan's (K1 + K2) outputs bit for bit."""
    from repro_torch.events import stream as stream_mod
    from repro_torch.serve import StreamingDetector, session_base_us
    st = synthetic.shapes_stream(duration_us=20_000, seed=0)
    cfg = pipeline.PipelineConfig(chunk=512, lut_every_chunks=2, vdd=0.6,
                                  inject_ber=True)
    scan = pipeline.run_pipeline(st.xy, st.ts, cfg)
    oracle = pipeline.run_pipeline_reference(
        st.xy, st.ts, dataclasses.replace(cfg, backend=backend))
    for f in ("scores", "kept", "tos", "lut", "vdd_trace"):
        np.testing.assert_array_equal(getattr(oracle, f), getattr(scan, f))
    assert oracle.energy_pj == scan.energy_pj
    base = session_base_us(int(st.ts[0]), cfg)
    det = StreamingDetector(cfg, base_ts=base)
    with stream_mod.PrefetchingLoader(st, cfg.chunk, device_slabs=True,
                                      rebase_us=base, device=cuda) as ld:
        scores = np.concatenate([det.feed_device_chunk(*c)[0] for c in ld])
    np.testing.assert_array_equal(scores, scan.scores)
    assert det.energy_pj == scan.energy_pj


def test_onehot_update_on_cuda_is_bit_equal(cuda):
    from repro_torch.core import tos as t_tos
    rng = np.random.default_rng(0)
    h, w, e = 180, 240, 1024
    xy = torch.as_tensor(np.stack([rng.integers(0, w, e),
                                   rng.integers(0, h, e)], 1),
                         dtype=torch.int32, device=cuda)
    valid = torch.as_tensor(rng.random(e) < 0.9, device=cuda)
    surf = torch.as_tensor(np.where(rng.random((h, w)) < 0.5,
                                    rng.integers(200, 256, (h, w)), 0),
                           dtype=torch.uint8, device=cuda)
    assert torch.equal(t_tos.tos_update_batched_onehot(surf, xy, valid),
                       t_tos.tos_update_batched(surf, xy, valid))


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmoe_1b_7b",
                                  "deepseek_v3_671b", "zamba2_1_2b"])
@pytest.mark.parametrize("greedy", [True, False])
def test_lm_serve_step_on_cuda_equals_cpu(cuda, arch, greedy):
    """The LM scaffold's serve step (float32 smoke config, TF32 off) on the
    card against the host, same weights and keys: next tokens equal,
    logits and caches within 1e-4 * max(1, max|cpu|)."""
    from repro_torch import configs
    from repro_torch.models import transformer as T
    from repro_torch.models.common import tree_map
    from repro_torch.train.train_step import make_serve_step
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              param_dtype=torch.float32,
                              act_dtype=torch.float32)
    params, _ = T.init_params(cfg, torch.Generator("cpu").manual_seed(0))
    on_card = tree_map(lambda a: a.to(cuda), params)
    step = make_serve_step(cfg, greedy=greedy, temperature=0.8)
    b, length = 3, 16
    toks = torch.tensor([[1], [2], [3]], dtype=torch.int32)
    runs = {}
    for dev, p in (("cpu", params), (cuda, on_card)):
        cache = T.zeros_cache(cfg, b, length, dev)
        key = prng.prng_key(7, device=dev)
        t, out = toks.to(dev), []
        for pos in range(4):
            key, sub = prng.split(key)
            t, logits, cache = step(p, t, cache, pos, sub)
            out.append((t.cpu(), logits.cpu(),
                        tree_map(lambda a: a.cpu(), cache)))
        runs[str(dev)] = out
    for (t_c, l_c, c_c), (t_g, l_g, c_g) in zip(runs["cpu"], runs["cuda"]):
        assert torch.equal(t_g, t_c)
        for got, want in [(l_g, l_c)] + [
                (g, w) for g, w in zip(_leaves(c_g), _leaves(c_c))]:
            bound = 1e-4 * max(1.0, float(want.abs().max()))
            assert float((got.float() - want.float()).abs().max()) <= bound


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmoe_1b_7b",
                                  "whisper_tiny"])
def test_lm_train_step_on_cuda_equals_cpu(cuda, arch):
    """One float32 train step of the LM scaffold (smoke config, TF32 off)
    on the card against the host, same weights and batch: the loss within
    1e-4 and grad_norm within 1e-3 relative (Whisper's grad_norm is 1.2e-4
    apart on an H100); per leaf ``max|dg| <= 2e-3 * max|g_cpu(leaf)| +
    1e-6 * max|g_cpu(tree)|``, twice the CPU tests' JAX-against-port
    bound (``tests/_torch_lm_harness.py``): cuBLAS sums float32 in another
    order than the host, and one Whisper leaf is 1.26e-3 of its largest
    gradient apart on an H100; parameters within ``2 * lr + 1e-6``, all
    but 1e-3 of the elements within 1e-5; the state stays on the card."""
    from repro_torch import configs
    from repro_torch.launch.train import synthetic_batch_fn
    from repro_torch.models import transformer as T
    from repro_torch.models.common import _leaves as named, tree_map
    from repro_torch.train.optimizer import AdamWConfig, adamw_init
    from repro_torch.train.train_step import make_grad_fn, make_train_step
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = dataclasses.replace(configs.get_smoke(arch),
                              param_dtype=torch.float32,
                              act_dtype=torch.float32)
    opt = AdamWConfig(lr=3e-4, warmup_steps=1, total_steps=3)
    params, _ = T.init_params(cfg, torch.Generator("cpu").manual_seed(0))
    runs = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev), params)
        batch = synthetic_batch_fn(cfg, 4, 32, device=dev)(0)
        (_, _), grads = make_grad_fn(cfg)(p, batch)
        p2, s2, m = make_train_step(cfg, opt)(p, adamw_init(p, opt), batch)
        assert s2["step"].device.type == torch.device(dev).type
        assert s2["step"].dtype == torch.int32
        runs[str(dev)] = (list(named(grads)), _leaves(p2),
                          {k: float(v) for k, v in m.items()})
    (g_c, p_c, m_c), (g_g, p_g, m_g) = runs["cpu"], runs["cuda"]
    assert set(m_g) == set(m_c)
    for k, rel in (("loss", 1e-4), ("grad_norm", 1e-3)):
        assert abs(m_g[k] - m_c[k]) <= rel * abs(m_c[k]), k
    top = max(float(g.abs().max()) for _, g in g_c)
    for (path, got), (_, want) in zip(g_g, g_c):
        bound = 2e-3 * float(want.abs().max()) + 1e-6 * top
        err = float((got.cpu() - want).abs().max())
        assert err <= bound, (path, err, bound)
    far = total = 0
    for got, want in zip(p_g, p_c):
        d = (got.cpu() - want).abs()
        assert float(d.max()) <= 2 * opt.lr + 1e-6
        far += int((d > 1e-5).sum())
        total += d.numel()
    assert far <= 1e-3 * total


def test_moe_a2a_on_a_one_card_nccl_mesh_equals_moe_apply(cuda):
    """The all-to-all MoE on the 1x1 mesh of one card (NCCL): olmoe smoke
    in float32, x (2, 32, d), equal to ``moe_apply`` on the card (values
    exactly, aux within 1e-6, the gradients of ``sum(y**2) + aux`` within
    1e-6), as on the host (``tests/test_torch_mesh.py``)."""
    import torch.distributed as dist
    from repro_torch import configs
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.meshctx import use_mesh_rules
    from repro_torch.models import mlp as TM
    from repro_torch.models.common import init_dense
    cfg = dataclasses.replace(configs.get_smoke("olmoe_1b_7b"),
                              param_dtype=torch.float32,
                              act_dtype=torch.float32)
    p, _ = init_dense(torch.Generator(cuda).manual_seed(0),
                      TM.moe_spec(cfg), torch.float32)
    x = torch.randn((2, 32, cfg.d_model), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(1))
    mesh = make_local_mesh(device=cuda)
    assert mesh.device_type == "cuda" and "nccl" in str(dist.get_backend())
    rules = sh.make_rules(cfg, mesh)
    runs = []
    for use in (False, True):
        pp = {k: v.clone().requires_grad_(True) for k, v in p.items()}
        xx = x.clone().requires_grad_(True)
        if use:
            with use_mesh_rules(mesh, rules):
                y, aux = TM.moe_apply_a2a(pp, xx, cfg)
        else:
            y, aux = TM.moe_apply(pp, xx, cfg)
        (y.square().sum() + aux).backward()
        runs.append((y.detach(), float(aux),
                     [pp[k].grad for k in sorted(pp)] + [xx.grad]))
    (y0, a0, g0), (y1, a1, g1) = runs
    assert torch.equal(y0, y1) and abs(a0 - a1) < 1e-6
    for a, b in zip(g0, g1):
        assert float((a - b).abs().max()) <= 1e-6
