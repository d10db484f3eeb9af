"""The rest of the reference's core and events in the port, on the CPU,
against the JAX package on its own tests' cases: the AER codec
(``events.aer``), ``tos.tos_invariant_ok`` and ``tos.TosStream``,
``stcf.stcf_sequential``, ``ber.inject_write_errors`` and
``ber.corrupt_surface``, and ``harris.corner_lut``.

Bounds: AER words, the invariant, surfaces, SAEs, keep masks and BER draws
exactly equal (draw-exact for the same key, at the 0.6-0.62 V rates too);
``stcf_sequential`` also equal to the port's ``stcf_chunked``; the LUT
within ``1e-5 * max|R|`` of JAX (XLA contracts its fold into FMAs) and
bit-equal to the port's ``harris_response``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from conftest import make_events, make_tos  # noqa: E402
from repro.core import ber as j_ber  # noqa: E402
from repro.core import harris as j_harris  # noqa: E402
from repro.core import hwmodel as j_hw  # noqa: E402
from repro.core import stcf as j_stcf  # noqa: E402
from repro.core import tos as j_tos  # noqa: E402
from repro.events import aer as j_aer  # noqa: E402
from repro_torch.core import ber as t_ber  # noqa: E402
from repro_torch.core import harris as t_harris  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import stcf as t_stcf  # noqa: E402
from repro_torch.core import tos as t_tos  # noqa: E402
from repro_torch.events import aer as t_aer  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

T = torch.from_numpy


# --- AER ---------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_aer_roundtrip_and_words_equal_reference(seed):
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.integers(0, 1280, 100), rng.integers(0, 720, 100)],
                  1).astype(np.int32)
    xy[0] = (t_aer.MAX_XY, t_aer.MAX_XY)
    pol = rng.choice(np.array([-1, 1], np.int8), 100)
    words = t_aer.pack(xy, pol)
    assert words.dtype == np.uint32
    np.testing.assert_array_equal(words, j_aer.pack(xy, pol))
    xy2, pol2 = t_aer.unpack(words)
    assert (xy2.dtype, pol2.dtype) == (np.int32, np.int8)
    np.testing.assert_array_equal(xy2, xy)
    np.testing.assert_array_equal(pol2, pol)
    want = j_aer.unpack(words)
    np.testing.assert_array_equal(xy2, want[0])
    np.testing.assert_array_equal(pol2, want[1])


@pytest.mark.parametrize("xy", [[[20000, 0]], [[0, t_aer.MAX_XY + 1]]])
def test_aer_range_check(xy):
    assert t_aer.MAX_XY == j_aer.MAX_XY == 16383
    pol = np.asarray([1], np.int8)
    with pytest.raises(ValueError, match="14-bit"):
        t_aer.pack(np.asarray(xy, np.int32), pol)
    with pytest.raises(ValueError, match="14-bit"):
        j_aer.pack(np.asarray(xy, np.int32), pol)


# --- TOS invariant and stream carry ------------------------------------


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("th", [200, 225, 250])
def test_tos_invariant_matches_reference(seed, th):
    r = np.random.default_rng(seed)
    h, w = 24, 32
    xy, valid = make_events(r, h, w, 60)
    t0 = make_tos(r, h, w, th)
    out = t_tos.tos_update_batched(T(t0), T(xy), T(valid), patch=5, th=th)
    got = t_tos.tos_invariant_ok(out, th)
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == bool(j_tos.tos_invariant_ok(jnp.asarray(out.numpy()),
                                                     th)) is True
    bad = out.clone()
    bad[3, 4] = th - 1
    assert bool(t_tos.tos_invariant_ok(bad, th)) == bool(
        j_tos.tos_invariant_ok(jnp.asarray(bad.numpy()), th)) is False


def _fold(stream, chunks, **kw):
    for xy, valid in chunks:
        stream = stream.update(xy, valid, **kw)
    return stream


@pytest.mark.parametrize("patch,th", [(3, 225), (7, 225), (7, 250)])
def test_tos_stream_folds_like_reference(patch, th):
    r = np.random.default_rng(patch + th)
    h, w = 32, 48
    chunks = [make_events(r, h, w, e) for e in (40, 1, 64)]
    want = _fold(j_tos.TosStream.init(h, w),
                 [(jnp.asarray(x), jnp.asarray(v)) for x, v in chunks],
                 patch=patch, th=th)
    got = _fold(t_tos.TosStream.init(h, w, device="cpu"),
                [(T(x), T(v)) for x, v in chunks], patch=patch, th=th)
    assert isinstance(got, t_tos.TosStream)
    assert got.surface.dtype == torch.uint8 and got.surface.shape == (h, w)
    np.testing.assert_array_equal(got.surface.numpy(),
                                  np.asarray(want.surface))
    seq = _fold(t_tos.TosStream.init(h, w, device="cpu"),
                [(T(x), T(v)) for x, v in chunks], patch=patch, th=th,
                update_fn=t_tos.tos_update_sequential)
    assert torch.equal(seq.surface, got.surface)


@pytest.mark.parametrize("mode", list(ops.TOS_MODES))
def test_tos_stream_takes_the_kernel_modes(mode):
    """``update_fn=partial(ops.tos_update_op, mode=...)``: K4-K7's plain
    versions on the CPU, equal to the default closed form."""
    r = np.random.default_rng(11)
    h, w = 40, 140                      # two 128-wide reference tiles
    chunks = [make_events(r, h, w, e) for e in (50, 30)]
    base = t_tos.TosStream.init(h, w, device="cpu")
    want = _fold(base, [(T(x), T(v)) for x, v in chunks])
    got = _fold(base, [(T(x), T(v)) for x, v in chunks],
                update_fn=functools.partial(ops.tos_update_op, mode=mode))
    assert torch.equal(got.surface, want.surface)


def test_tos_stream_init_refuses_cuda_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_tos.TosStream.init(8, 8)


# --- STCF oracle -------------------------------------------------------


def _stcf_stream(rng, h, w, e, tmax=20000):
    """``tests/test_stcf.py``'s stream: random pixels, sorted times, a
    tenth invalid at (0, 0)."""
    xy = np.stack([rng.integers(0, w, e), rng.integers(0, h, e)],
                  1).astype(np.int32)
    ts = np.sort(rng.integers(0, tmax, e)).astype(np.int32)
    valid = rng.random(e) < 0.9
    xy[~valid] = 0
    return xy, ts, valid


@pytest.mark.parametrize("seed,e", [(0, 1), (1, 37), (2, 100), (3, 100)])
@pytest.mark.parametrize("tw,support", [(1000, 1), (5000, 2), (5000, 3)])
def test_stcf_sequential_matches_reference_and_chunked(seed, e, tw, support):
    rng = np.random.default_rng(seed)
    h, w = 24, 32
    xy, ts, valid = _stcf_stream(rng, h, w, e)
    sae0 = np.full((h, w), t_stcf.NEVER, np.int32)
    if seed == 3:                        # a surface that fired before
        sae0[rng.random((h, w)) < 0.3] = -3000
    js, jk = j_stcf.stcf_sequential(jnp.asarray(sae0), jnp.asarray(xy),
                                    jnp.asarray(ts), jnp.asarray(valid),
                                    tw=tw, support=support)
    args = (T(sae0), T(xy), T(ts), T(valid))
    s, k = t_stcf.stcf_sequential(*args, tw=tw, support=support)
    assert (s.dtype, k.dtype) == (torch.int32, torch.bool)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    cs, ck = t_stcf.stcf_chunked(*args, tw=tw, support=support)
    assert torch.equal(s, cs) and torch.equal(k, ck)
    assert torch.equal(T(sae0), args[0])      # the input is not mutated


# --- BER ---------------------------------------------------------------


def _key(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(seed)


@pytest.mark.parametrize("rate", [0.0, -1.0])
def test_inject_write_errors_zero_rate_is_identity(rng, rate):
    t = T(make_tos(rng, 32, 32))
    assert t_ber.inject_write_errors(_key(0)[1], t, rate) is t


@pytest.mark.parametrize("rate,seed", [(0.5, 1), (0.025, 2), (0.002, 3),
                                       (0.025, 4)])
def test_inject_write_errors_draw_exact(rng, rate, seed):
    t = make_tos(rng, 64, 80)
    jk, tk = _key(seed)
    want = np.asarray(j_ber.inject_write_errors(jk, jnp.asarray(t), rate))
    got = t_ber.inject_write_errors(tk, T(t), rate)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.all((want == 0) | (want >= 225))


def test_zero_pixels_never_corrupted():
    out = t_ber.inject_write_errors(_key(1)[1],
                                    torch.zeros((64, 64), dtype=torch.uint8),
                                    0.5)
    assert not out.any()


def test_flip_rate_matches():
    t = torch.full((256, 256), 255, dtype=torch.uint8)
    out = t_ber.inject_write_errors(_key(3)[1], t, 0.025)
    assert 0.08 < (out != 255).float().mean().item() < 0.16


@pytest.mark.parametrize("vdd", [0.58, 0.6, 0.605, 0.61, 0.615, 0.62, 0.8,
                                 1.2])
def test_corrupt_surface_draw_exact_and_one_function(vdd):
    """The voltage spelling equals the reference's for the same key, and
    the three port spellings are one function."""
    r = np.random.default_rng(int(vdd * 1000))
    t = make_tos(r, 48, 48)
    seed = int(r.integers(0, 2**31 - 1))
    jk, tk = _key(seed)
    want = np.asarray(j_ber.corrupt_surface(jk, jnp.asarray(t), vdd))
    a = t_ber.corrupt_surface(tk, T(t), vdd)
    np.testing.assert_array_equal(a.numpy(), want)
    rate = j_hw.ber_at(vdd)
    b = t_ber.inject_write_errors_at(tk, T(t),
                                     torch.tensor(rate, dtype=torch.float32))
    c = t_ber.inject_write_errors(tk, T(t), rate)
    assert torch.equal(a, b) and torch.equal(a, c)
    if 0.6 <= vdd <= 0.61:
        assert not np.array_equal(want, t)       # errors were drawn


# --- the corner LUT ----------------------------------------------------


@pytest.mark.parametrize("sobel,window", [(5, 5), (3, 3), (7, 1)])
def test_corner_lut_matches_reference(sobel, window):
    r = np.random.default_rng(sobel * 10 + window)
    t = np.stack([make_tos(r, 40, 56) for _ in range(2)])
    for lane in t:
        want = np.asarray(j_harris.corner_lut(jnp.asarray(lane),
                                              sobel_size=sobel,
                                              window_size=window))
        got = t_harris.corner_lut(T(lane), sobel_size=sobel,
                                  window_size=window)
        assert got.dtype == torch.float32
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()
        assert torch.equal(got, t_harris.harris_response(
            T(lane), sobel_size=sobel, window_size=window))
