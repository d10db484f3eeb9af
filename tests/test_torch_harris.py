"""K2's plain version against the reference Harris, within the stated
bound: ``|delta| <= 1e-5 * max|R_ref|`` (the reference lets XLA contract
its tap fold into FMAs; the port rounds every product and sum).  The CUDA
kernel itself is held to the plain version on the card (``test_torch_cuda``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import harris as j_harris  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.core import harris as t_harris  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402

REL = 1e-5


def _tos(rng, shape, th=225):
    t = rng.integers(0, 256, shape)
    return np.where(t >= th, t, 0).astype(np.uint8)


def _assert_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    bound = REL * np.abs(want).max()
    np.testing.assert_array_less(np.abs(got - want), bound + 1e-30)


@pytest.mark.parametrize("hw", [(40, 56), (64, 96), (47, 61)])
def test_harris_plain_matches_reference(hw):
    tos = _tos(np.random.default_rng(hw[0]), hw)
    want = j_harris.harris_response(jnp.asarray(tos))
    got = t_ops.harris_response_op(torch.from_numpy(tos))
    _assert_close(got.numpy(), want)


@pytest.mark.parametrize("sizes", [(3, 3), (5, 3), (7, 5), (5, 7)])
def test_harris_sizes(sizes):
    sobel, window = sizes
    tos = _tos(np.random.default_rng(sobel * 10 + window), (40, 56))
    want = j_harris.harris_response(jnp.asarray(tos), sobel_size=sobel,
                                    window_size=window, k=0.05)
    got = t_harris.harris_response(torch.from_numpy(tos), sobel_size=sobel,
                                   window_size=window, k=0.05)
    _assert_close(got.numpy(), want)


def test_harris_matches_pallas_kernel_interpret():
    """Against the TPU kernel K2 itself, run in interpret mode."""
    tos = _tos(np.random.default_rng(9), (64, 96))
    want = j_ops.harris_response_op(jnp.asarray(tos), interpret=True)
    got = t_ops.harris_response_op(torch.from_numpy(tos))
    _assert_close(got.numpy(), want)


def test_harris_lane_batch_equals_per_lane():
    rng = np.random.default_rng(4)
    tos = torch.from_numpy(_tos(rng, (3, 40, 56)))
    batch = t_ops.harris_response_op(tos)
    for i in range(3):
        assert torch.equal(batch[i], t_ops.harris_response_op(tos[i]))


def test_score_events():
    rng = np.random.default_rng(5)
    lut = rng.standard_normal((40, 56)).astype(np.float32)
    xy = np.stack([rng.integers(0, 56, 50), rng.integers(0, 40, 50)],
                  1).astype(np.int32)
    valid = rng.random(50) < 0.7
    want = j_harris.score_events(jnp.asarray(lut), jnp.asarray(xy),
                                 jnp.asarray(valid))
    got = t_harris.score_events(torch.from_numpy(lut), torch.from_numpy(xy),
                                torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
