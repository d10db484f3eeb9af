"""The port's threefry against ``jax.random``: keys, splits and Bernoulli
bits equal across seeds, odd shapes and the ``(H, W, 5)`` BER draw."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ber as j_ber  # noqa: E402
from repro_torch.core import ber as t_ber  # noqa: E402
from repro_torch.core import prng  # noqa: E402

SEEDS = [0, 1, 7, 123456, 2**31 - 1, -3]


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_split_chain(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for _ in range(4):
        np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        np.testing.assert_array_equal(np.asarray(jsub), tsub.numpy())


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5), (13, 11, 5),
                                   (40, 56, 5)])
@pytest.mark.parametrize("p", [0.002, 0.025, 0.5])
def test_bernoulli_bits_equal(shape, p):
    key = jax.random.split(jax.random.PRNGKey(11))[1]
    want = np.asarray(jax.random.bernoulli(key, jnp.float32(p), shape))
    got = prng.bernoulli_bits(torch.from_numpy(np.asarray(key, np.int64)),
                              torch.tensor(p, dtype=torch.float32), shape)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_equal():
    key = jax.random.PRNGKey(5)
    want = np.asarray(jax.random.bits(key, (9, 4), jnp.uint32))
    got = prng.random_bits(prng.prng_key(5), (9, 4))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_lane_batched_draws_match_per_key():
    seeds = [2, 9, 31]
    bers = [0.002, 0.025, 0.0]
    keys = torch.stack([prng.split(prng.prng_key(s))[1] for s in seeds])
    got = t_ber.write_error_bits(keys, (12, 17),
                                 torch.tensor(bers, dtype=torch.float32))
    for i, (s, b) in enumerate(zip(seeds, bers)):
        sub = jax.random.split(jax.random.PRNGKey(s))[1]
        want = j_ber.write_error_bits(sub, (12, 17), jnp.float32(b))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_seed_outside_int32_rejected():
    with pytest.raises(ValueError):
        prng.prng_key(2**31)
