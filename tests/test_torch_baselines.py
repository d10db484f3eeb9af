"""The port's eHarris / evFAST / evARC (``repro_torch.core.baselines``) on
the CPU against ``repro.core.baselines``: on ``tests/test_baselines.py``'s
corner and edge cases and on SAEs of seeded ``shapes_stream``s with events
at the sensor's edges.

Bounds: evFAST, evARC, the binary surface and the circles exactly equal;
eHarris within ``1e-5 * max|score|`` over the valid events with the same
``-inf`` positions (the reference correlates through XLA's convolution,
whose rounding cannot be reproduced; the port folds the taps)."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import baselines as jb  # noqa: E402
from repro_torch.core import baselines as tb  # noqa: E402
from repro_torch.events import synthetic  # noqa: E402

REL = 1e-5
SCORES = ("fast_scores", "arc_scores", "eharris_scores")


def _corner_sae(h=48, w=48, t_new=10_000):
    """``tests/test_baselines.py``'s SAE: an L-shaped recent edge meeting at
    (24, 24), a corner, over a stale background."""
    sae = np.full((h, w), -(2**30), np.int32)
    sae[24, 4:25] = t_new - np.arange(21)[::-1] * 10
    sae[4:25, 24] = t_new - np.arange(21)[::-1] * 10
    return sae


def _stream_case(seed, n=9000, e=512, h=180, w=240):
    """An SAE of the first ``n`` events of a shapes stream and the next
    ``e`` events (a seventh invalid, four at the corners of the sensor)."""
    st = synthetic.shapes_stream(height=h, width=w, duration_us=40_000,
                                 seed=seed)
    sae = np.full((h, w), -(2**30), np.int32)
    np.maximum.at(sae, (st.xy[:n, 1], st.xy[:n, 0]),
                  st.ts[:n].astype(np.int32))
    xy = st.xy[n:n + e].astype(np.int32)
    ts = st.ts[n:n + e].astype(np.int32)
    xy[:4] = [[0, 0], [w - 1, h - 1], [1, h - 2], [w - 2, 2]]
    valid = np.ones((e,), bool)
    valid[::7] = False
    return sae, xy, ts, valid


def _both(name, sae, xy, ts, valid, **kw):
    want = np.asarray(getattr(jb, name)(
        jnp.asarray(sae), jnp.asarray(xy), jnp.asarray(ts),
        jnp.asarray(valid), **kw))
    got = getattr(tb, name)(
        torch.from_numpy(sae), torch.from_numpy(xy), torch.from_numpy(ts),
        torch.from_numpy(valid), **kw)
    assert got.dtype == torch.float32 and got.shape == (len(xy),)
    return got.numpy(), want


def _hold(name, got, want):
    if name == "eharris_scores":
        fin = np.isfinite(want)
        np.testing.assert_array_equal(np.isfinite(got), fin)
        np.testing.assert_array_equal(got[~fin], want[~fin])
        assert np.abs(got[fin] - want[fin]).max() <= (
            REL * np.abs(want[fin]).max())
    else:
        np.testing.assert_array_equal(got, want)


CORNER = (np.asarray([[24, 24], [12, 24], [40, 40]], np.int32),
          np.full((3,), 10_000, np.int32), np.asarray([True, True, False]))


@pytest.mark.parametrize("name", SCORES)
def test_corner_case_matches_reference(name):
    got, want = _both(name, _corner_sae(), *CORNER)
    _hold(name, got, want)
    assert got[2] == -np.inf


def test_eharris_corner_scores_higher_than_edge():
    xy, ts, _ = CORNER
    got, _ = _both("eharris_scores", _corner_sae(), xy, ts,
                   np.ones((3,), bool))
    assert got[0] > got[2] > got[1]


def test_fast_and_arc_finite_where_valid():
    for name in ("fast_scores", "arc_scores"):
        got, _ = _both(name, _corner_sae(), *CORNER)
        assert np.isfinite(got[:2]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", SCORES)
def test_shapes_stream_sae_matches_reference(name, seed):
    sae, xy, ts, valid = _stream_case(seed)
    got, want = _both(name, sae, xy, ts, valid)
    _hold(name, got, want)
    assert len(np.unique(got[valid])) > 1


@pytest.mark.parametrize("kw", [dict(window_us=5_000, patch=7, k=0.06),
                                dict(window_us=50_000, patch=11)])
def test_eharris_options_match_reference(kw):
    sae, xy, ts, valid = _stream_case(3, e=128)
    _hold("eharris_scores", *_both("eharris_scores", sae, xy, ts, valid,
                                    **kw))


def test_arc_band_option_matches_reference():
    sae, xy, ts, valid = _stream_case(4, e=256)
    got, want = _both("arc_scores", sae, xy, ts, valid, theta_min_deg=45.0,
                      theta_max_deg=135.0)
    np.testing.assert_array_equal(got, want)


def test_binary_surface_matches_reference():
    sae, _, ts, _ = _stream_case(5, e=8)
    t_now = int(ts[-1])
    want = np.asarray(jb.binary_surface(jnp.asarray(sae), t_now, 20_000))
    got = tb.binary_surface(torch.from_numpy(sae), t_now, 20_000)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_circle_geometry():
    np.testing.assert_array_equal(tb.CIRCLE3, jb.CIRCLE3)
    np.testing.assert_array_equal(tb.CIRCLE4, jb.CIRCLE4)
    assert tb.CIRCLE3.shape == (16, 2) and tb.CIRCLE4.shape == (20, 2)
    r3 = np.linalg.norm(tb.CIRCLE3, axis=1)
    r4 = np.linalg.norm(tb.CIRCLE4, axis=1)
    assert np.all((r3 > 2.7) & (r3 < 3.3))
    assert np.all((r4 > 3.5) & (r4 < 4.4))
    with pytest.raises(ValueError):
        tb._circle(5)


def test_ties_at_the_kth_newest_are_kept():
    """A ring whose timestamps tie at the k-th newest keeps every tie, in
    both packages."""
    sae = np.full((16, 16), -(2**30), np.int32)
    sae[3:13, 3:13] = 500              # every ring pixel ties
    xy = np.asarray([[8, 8], [7, 8]], np.int32)
    ts = np.full((2,), 600, np.int32)
    valid = np.ones((2,), bool)
    for name in ("fast_scores", "arc_scores"):
        got, want = _both(name, sae, xy, ts, valid)
        np.testing.assert_array_equal(got, want)
