"""The port's chunked TOS update (K4-K7 through ``ops.tos_update_op``; the
plain versions on the CPU) against the reference's Pallas kernels in
interpret mode.  Bound: every output equal, bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_events, make_tos  # noqa: E402
from repro.core import tos as j_tos  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import tos_update as j_tu  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import tos_update as t_tu  # noqa: E402

MODES = ("nmc", "batched", "nmc_binned", "batched_binned")

# tests/test_kernels.py's cases: DAVIS240, more than one 128-tile each way,
# patches 3 to 9.
TOS_CASES = [
    (64, 64, 16, 7, 225),
    (180, 240, 96, 7, 225),
    (100, 130, 33, 5, 240),
    (128, 200, 128, 9, 200),
    (260, 350, 64, 3, 225),
]


def _both(tos, xy, valid, *, patch=7, th=225, mode):
    """(port, reference) outputs of ``tos_update_op`` as numpy."""
    got = ops.tos_update_op(torch.from_numpy(tos), torch.from_numpy(xy),
                            torch.from_numpy(valid), patch=patch, th=th,
                            mode=mode)
    want = j_ops.tos_update_op(jnp.asarray(tos), jnp.asarray(xy),
                               jnp.asarray(valid), patch=patch, th=th,
                               mode=mode, interpret=True)
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("h,w,e,patch,th", TOS_CASES)
@pytest.mark.parametrize("mode", MODES)
def test_tos_update_op_matches_reference(h, w, e, patch, th, mode):
    rng = np.random.default_rng(h * w + e)
    xy, valid = make_events(rng, h, w, e)
    got, want = _both(make_tos(rng, h, w, th), xy, valid, patch=patch, th=th,
                      mode=mode)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_all_invalid_chunk_is_identity(mode):
    rng = np.random.default_rng(3)
    tos = make_tos(rng, 64, 64)
    xy = rng.integers(0, 64, (16, 2)).astype(np.int32)
    got, want = _both(tos, xy, np.zeros(16, bool), mode=mode)
    np.testing.assert_array_equal(got, tos)
    np.testing.assert_array_equal(want, tos)


@pytest.mark.parametrize("mode", MODES)
def test_events_on_image_and_tile_borders(mode):
    """Patches clipped at every image edge and split across 128-tile
    borders (x = 127/128, y = 127/128), repeated pixels included."""
    rng = np.random.default_rng(4)
    h, w = 200, 300
    pts = [(0, 0), (w - 1, h - 1), (0, h - 1), (w - 1, 0), (127, 50),
           (128, 50), (126, 127), (129, 128), (127, 128), (255, 127),
           (256, 128), (128, 128), (0, 128), (w - 1, 127), (127, 50)]
    xy = np.array(pts * 4, np.int32)
    valid = rng.random(len(xy)) < 0.85
    got, want = _both(make_tos(rng, h, w), xy, valid, patch=9, mode=mode)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", MODES)
def test_three_lanes_in_one_call(mode):
    """A ``(3, H, W)`` batch with different events per lane equals the
    reference lane by lane."""
    rng = np.random.default_rng(5)
    h, w, e = 140, 150, 48
    tos = np.stack([make_tos(rng, h, w) for _ in range(3)])
    evs = [make_events(rng, h, w, e, valid_frac=f) for f in (0.9, 0.5, 0.0)]
    xy = np.stack([x for x, _ in evs])
    valid = np.stack([v for _, v in evs])
    got = ops.tos_update_op(torch.from_numpy(tos), torch.from_numpy(xy),
                            torch.from_numpy(valid), mode=mode).numpy()
    for b in range(3):
        want = j_ops.tos_update_op(jnp.asarray(tos[b]), jnp.asarray(xy[b]),
                                   jnp.asarray(valid[b]), mode=mode,
                                   interpret=True)
        np.testing.assert_array_equal(got[b], np.asarray(want))


def test_unknown_mode_raises():
    t = torch.zeros((8, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="unknown mode"):
        ops.tos_update_op(t, torch.zeros((1, 2), dtype=torch.int32),
                          torch.ones(1, dtype=torch.bool), mode="onehot")


def _clustered(rng, h, w, e):
    """Events bunched around a few centres near 128-tile corners, so some
    tiles get far more hits than others."""
    centres = np.array([[126, 130], [250, 120], [40, 60], [300, 200]])
    pick = centres[rng.integers(0, len(centres), e)]
    xy = np.clip(pick + rng.integers(-9, 10, (e, 2)), 0, (w - 1, h - 1))
    return xy.astype(np.int32), rng.random(e) < 0.9


@pytest.mark.parametrize("patch", [3, 7])
def test_bin_events_to_tiles_matches_reference(patch):
    rng = np.random.default_rng(patch)
    xy, valid = _clustered(rng, 256, 384, 200)
    for cap in (5, 40, 200):
        got, gov = t_tu.bin_events_to_tiles(
            torch.from_numpy(xy)[None], torch.from_numpy(valid)[None],
            grid_hw=(2, 3), patch=patch, cap=cap)
        want, wov = j_tu.bin_events_to_tiles(
            jnp.asarray(xy), jnp.asarray(valid), grid_hw=(2, 3), patch=patch,
            cap=cap)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
        np.testing.assert_array_equal(gov[0].numpy(), np.asarray(wov))


@pytest.mark.parametrize("patch", [3, 7])
@pytest.mark.parametrize("cap_kind", ["truncating", "one", "lossless"])
@pytest.mark.parametrize("kernel", ["nmc", "batched"])
def test_binned_cap_matches_reference_kernel(kernel, cap_kind, patch):
    """K6/K7 with an explicit ``cap`` on a padded 256 x 384 surface: a tile
    keeps its first ``cap`` hits and drops the rest, as the reference's
    ``*_binned_call`` does."""
    rng = np.random.default_rng(patch + 10)
    h, w, e, th = 256, 384, 200, 225
    xy, valid = _clustered(rng, h, w, e)
    tos = make_tos(rng, h, w, th)
    jx, jv = jnp.asarray(xy), jnp.asarray(valid)
    bins, _ = j_tu.bin_events_to_tiles(jx, jv, grid_hw=(2, 3), patch=patch,
                                       cap=e)
    hits = np.asarray(bins)[..., 2].sum(-1)             # per tile
    cap = {"truncating": int(hits.max()) // 2, "one": 1,
           "lossless": 0}[cap_kind]
    if cap_kind == "truncating":
        assert (hits > cap).sum() >= 2                  # several tiles drop
    tx, tv = torch.from_numpy(xy)[None], torch.from_numpy(valid)[None]
    ttos = torch.from_numpy(tos)[None]
    if kernel == "nmc":
        want = j_tu.nmc_stream_binned_call(jnp.asarray(tos), jx, jv,
                                           patch=patch, th=th, cap=cap,
                                           interpret=True)
        got = t_tu.nmc_stream_binned_ref(ttos, tx, tv, patch=patch, th=th,
                                         cap=cap)
    else:
        r = (patch - 1) // 2
        vals = j_tos._clamp_threshold(
            255 - j_tos._suffix_cover_counts(jx, jv, r), th)
        centre = j_tos._scatter_last_center_value((h, w), jx, jv, vals)
        want = j_tu.batched_fused_binned_call(jnp.asarray(tos), jx, jv,
                                              centre, patch=patch, th=th,
                                              cap=cap, interpret=True)
        tcentre = ops.centre_surface((h, w), tx, tv, patch=patch, th=th)
        np.testing.assert_array_equal(tcentre[0].numpy(), np.asarray(centre))
        got = t_tu.batched_fused_binned_ref(ttos, tx, tv, tcentre,
                                            patch=patch, th=th, cap=cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))
    if cap_kind == "truncating":
        lossless = ops.tos_update_op(ttos, tx, tv, patch=patch, th=th,
                                     mode=kernel)
        assert not torch.equal(got, lossless)   # the cap really dropped hits


# The cases the 64x64 tiles of the card's K4-K7 make risky, small enough for
# interpret mode: (h, w, e, patch, layout, background).  ``one_tile`` puts
# every event in a 12 x 12 square across 64-tile borders (cover counts
# above 100, ten 32-event chunks); ``below_th`` is a uniform 0..255
# background, which K5's closed form zeroes where no event covers it and
# the NMC replay (K4, K6) leaves as it is.
EDGE_CASES = {
    "patch31": (100, 130, 40, 31, "spread", "tos"),
    "e37": (90, 140, 37, 7, "spread", "tos"),
    "clustered": (128, 200, 300, 7, "one_tile", "tos"),
    "below_th": (80, 120, 64, 5, "spread", "below_th"),
}


def _edge(case):
    h, w, e, patch, layout, background = EDGE_CASES[case]
    rng = np.random.default_rng(h + e + patch)
    tos = (rng.integers(0, 256, (h, w)).astype(np.uint8)
           if background == "below_th" else make_tos(rng, h, w))
    xy, valid = make_events(rng, h, w, e)
    if layout == "one_tile":
        xy = (np.array([58, 58]) + rng.integers(0, 12, (e, 2))).astype(
            np.int32)
    return tos, xy, valid, patch


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("mode", MODES)
def test_batched_edge_cases_match_reference(case, mode):
    tos, xy, valid, patch = _edge(case)
    got, want = _both(tos, xy, valid, patch=patch, mode=mode)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(EDGE_CASES))
@pytest.mark.parametrize("cap_kind", ["one", "half"])
@pytest.mark.parametrize("kernel", ["batched", "nmc"])
def test_batched_binned_cap_edge_cases(kernel, case, cap_kind):
    """Plain K7 / K6 with cap 1 and half the busiest tile's hits against
    the reference's ``batched_fused_binned_call`` / ``nmc_stream_binned_call``
    on the edge cases."""
    tos, xy, valid, patch = _edge(case)
    h, w = tos.shape
    th, r = 225, (patch - 1) // 2
    jx, jv = jnp.asarray(xy), jnp.asarray(valid)
    grid = (-(-h // t_tu.TILE), -(-w // t_tu.TILE))
    bins, _ = j_tu.bin_events_to_tiles(jx, jv, grid_hw=grid, patch=patch,
                                       cap=len(xy))
    busiest = int(np.asarray(bins)[..., 2].sum(-1).max())
    cap = 1 if cap_kind == "one" else max(1, busiest // 2)
    tx, tv = torch.from_numpy(xy)[None], torch.from_numpy(valid)[None]
    ttos = torch.from_numpy(tos)[None]
    if kernel == "nmc":
        want = j_tu.nmc_stream_binned_call(jnp.asarray(tos), jx, jv,
                                           patch=patch, th=th, cap=cap,
                                           interpret=True)
        got = t_tu.nmc_stream_binned_ref(ttos, tx, tv, patch=patch, th=th,
                                         cap=cap)
    else:
        vals = j_tos._clamp_threshold(
            255 - j_tos._suffix_cover_counts(jx, jv, r), th)
        centre = j_tos._scatter_last_center_value((h, w), jx, jv, vals)
        want = j_tu.batched_fused_binned_call(jnp.asarray(tos), jx, jv,
                                              centre, patch=patch, th=th,
                                              cap=cap, interpret=True)
        tcentre = ops.centre_surface((h, w), tx, tv, patch=patch, th=th)
        got = t_tu.batched_fused_binned_ref(ttos, tx, tv, tcentre,
                                            patch=patch, th=th, cap=cap)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


@pytest.mark.parametrize("name,th,match", [
    ("nmc_stream", 225, "CUDA"), ("nmc_stream_binned", 225, "CUDA"),
    ("batched_fused", 225, "CUDA"), ("batched_fused_binned", 225, "CUDA"),
    # The NMC replay has no closed form below th = 0 (values go negative):
    # K4/K6 refuse it before they look at the device.
    ("nmc_stream", -1, "th >= 0"), ("nmc_stream_binned", -1, "th >= 0"),
])
def test_launchers_refuse_cpu_tensors(name, th, match):
    t = torch.zeros((1, 8, 8), dtype=torch.uint8)
    args = [t, torch.zeros((1, 4, 2), dtype=torch.int32),
            torch.ones((1, 4), dtype=torch.bool)]
    if name.startswith("batched"):
        args.append(torch.full((1, 8, 8), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match=match):
        getattr(t_tu, f"{name}_cuda")(*args, patch=7, th=th)
