"""Core operators of the port against ``repro.core``: STCF, TOS, BER and the
online DVFS step exact; Harris within ``1e-5 * max|R|`` (module
``test_torch_harris`` holds the Harris cases)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ber as j_ber  # noqa: E402
from repro.core import dvfs as j_dvfs  # noqa: E402
from repro.core import stcf as j_stcf  # noqa: E402
from repro.core import tos as j_tos  # noqa: E402
from repro_torch.core import ber as t_ber  # noqa: E402
from repro_torch.core import dvfs as t_dvfs  # noqa: E402
from repro_torch.core import stcf as t_stcf  # noqa: E402
from repro_torch.core import tos as t_tos  # noqa: E402


def _chunk(rng, h, w, e, *, clustered=True, t_lo=0, t_hi=40_000):
    if clustered:   # events near a few centres, so STCF keeps some
        c = rng.integers(0, (w, h), (3, 2))[rng.integers(0, 3, e)]
        xy = np.clip(c + rng.integers(-4, 5, (e, 2)), 0, (w - 1, h - 1))
    else:
        xy = np.stack([rng.integers(0, w, e), rng.integers(0, h, e)], 1)
    ts = np.sort(rng.integers(t_lo, t_hi, e))
    valid = np.arange(e) < e - 5
    return xy.astype(np.int32), ts.astype(np.int32), valid


def _surfaces(rng, h, w):
    tos = np.zeros((h, w), np.uint8)
    hot = rng.random((h, w)) < 0.3
    tos[hot] = rng.integers(225, 256, hot.sum())
    sae = np.full((h, w), t_stcf.NEVER, np.int32)
    seen = rng.random((h, w)) < 0.4
    sae[seen] = rng.integers(0, 30_000, seen.sum())
    return tos, sae


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("support", [1, 2, 3])
def test_stcf_chunked_exact(seed, support):
    rng = np.random.default_rng(seed)
    _, sae = _surfaces(rng, 40, 56)
    xy, ts, valid = _chunk(rng, 40, 56, 200, t_lo=20_000)
    js, jk = j_stcf.stcf_chunked(jnp.asarray(sae), jnp.asarray(xy),
                                 jnp.asarray(ts), jnp.asarray(valid),
                                 support=support, tw=3000)
    ts_, tk = t_stcf.stcf_chunked(*_t(sae, xy, ts, valid), support=support,
                                  tw=3000)
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert 0 < int(tk.sum()) < int(valid.sum())


def test_stcf_step_disabled_is_identity():
    rng = np.random.default_rng(2)
    _, sae = _surfaces(rng, 40, 56)
    xy, ts, valid = _chunk(rng, 40, 56, 64)
    s, k = t_stcf.stcf_step(*_t(sae, xy, ts, valid), enabled=False)
    np.testing.assert_array_equal(s.numpy(), sae)
    np.testing.assert_array_equal(k.numpy(), valid)


@pytest.mark.parametrize("patch", [3, 5, 7, 9])
def test_tos_batched_and_sequential_exact(patch):
    rng = np.random.default_rng(patch)
    tos, _ = _surfaces(rng, 48, 64)
    xy, _, valid = _chunk(rng, 48, 64, 160)
    want = np.asarray(j_tos.tos_update_batched(
        jnp.asarray(tos), jnp.asarray(xy), jnp.asarray(valid), patch=patch))
    got = t_tos.tos_update_batched(*_t(tos, xy, valid), patch=patch)
    seq = t_tos.tos_update_sequential(*_t(tos, xy, valid), patch=patch)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(seq.numpy(), want)
    assert got.dtype == torch.uint8


@pytest.mark.parametrize("ber", [0.0, 0.002, 0.025])
def test_ber_injection_exact(ber):
    rng = np.random.default_rng(7)
    tos, _ = _surfaces(rng, 40, 56)
    key = jax.random.split(jax.random.PRNGKey(4))[1]
    want = j_ber.inject_write_errors_at(key, jnp.asarray(tos),
                                        jnp.float32(ber))
    got = t_ber.inject_write_errors_at(
        torch.from_numpy(np.asarray(key, np.int64)), torch.from_numpy(tos),
        torch.tensor(ber, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    codes = np.arange(256, dtype=np.uint8)
    np.testing.assert_array_equal(
        t_ber.encode5(torch.from_numpy(codes)).numpy(),
        np.asarray(j_ber.encode5(jnp.asarray(codes))))
    np.testing.assert_array_equal(
        t_ber.decode5(torch.from_numpy(codes)).numpy(),
        np.asarray(j_ber.decode5(jnp.asarray(codes))))


def test_online_dvfs_step_exact_over_lanes():
    """Three lanes with different rates fold the same chunk sequence as
    three separate reference carries."""
    cfg_j, cfg_t = j_dvfs.DvfsConfig(tw_us=200), t_dvfs.DvfsConfig(tw_us=200)
    caps_j = jnp.asarray(j_dvfs.op_point_table(cfg_j).caps)
    caps_t = torch.from_numpy(t_dvfs.op_point_table(cfg_t).caps)
    rng = np.random.default_rng(3)
    lanes, e = 3, 256
    rates = [0.5, 8.0, 40.0]                      # events per microsecond
    t_now = np.zeros(lanes)
    jr = [j_dvfs.rate_state_init() for _ in range(lanes)]
    tr = t_dvfs.rate_state_init(lanes)
    for step in range(30):
        ts = np.zeros((lanes, e), np.int32)
        for i in range(lanes):
            gaps = rng.exponential(1.0 / rates[i], e)
            ts[i] = (t_now[i] + np.cumsum(gaps)).astype(np.int32)
            t_now[i] = ts[i, -1]
        valid = np.ones((lanes, e), bool)
        valid[:, e - step % 7:] = False
        tr, t_idx = t_dvfs.online_vdd_from_chunk_ts(
            tr, torch.from_numpy(ts), torch.from_numpy(valid), cfg=cfg_t,
            caps=caps_t)
        for i in range(lanes):
            jr[i], j_idx = j_dvfs.online_vdd_from_chunk_ts(
                jr[i], jnp.asarray(ts[i]), jnp.asarray(valid[i]), cfg=cfg_j,
                caps=caps_j)
            assert int(t_idx[i]) == int(j_idx)
            for f in range(4):
                assert int(tr[f][i]) == int(jr[i][f])
    assert len({int(i) for i in t_idx}) > 1
