"""K1's plain version (what ``kernels.ops.fused_step_op`` runs for CPU
tensors) against the reference fused step: the Pallas kernel in interpret
mode and the composed jnp oracle.  Every output is exact.  The CUDA kernel
itself is held to the plain version on the card (``test_torch_cuda``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ber as j_ber  # noqa: E402
from repro.core import stcf as j_stcf  # noqa: E402
from repro.core import tos as j_tos  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro_torch.core import ber as t_ber  # noqa: E402
from repro_torch.kernels import fused_step  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402

TW, SUPPORT = 5000, 2


def _lane(rng, h, w, e):
    tos = np.zeros((h, w), np.uint8)
    hot = rng.random((h, w)) < 0.3
    tos[hot] = rng.integers(225, 256, hot.sum())
    sae = np.full((h, w), j_stcf._NEVER, np.int32)
    seen = rng.random((h, w)) < 0.4
    sae[seen] = rng.integers(0, 30_000, seen.sum())
    lut = rng.standard_normal((h, w)).astype(np.float32)
    c = rng.integers(0, (w, h), (4, 2))[rng.integers(0, 4, e)]
    xy = np.clip(c + rng.integers(-5, 6, (e, 2)), 0, (w - 1, h - 1))
    ts = np.sort(rng.integers(20_000, 40_000, e))
    valid = np.arange(e) < e - 11
    return (tos, sae, lut, xy.astype(np.int32), ts.astype(np.int32), valid)


def _jax_oracle(tos, sae, lut, xy, ts, valid, bits, ber, *, patch,
                stcf_enabled):
    sae2, keep = j_stcf.stcf_step(sae, xy, ts, valid, enabled=stcf_enabled,
                                  support=SUPPORT, tw=TW)
    tos2 = j_tos.tos_update_batched(tos, xy, keep, patch=patch, th=225)
    if bits is not None:
        tos2 = j_ber.apply_write_errors(tos2, bits, ber)
    scores = jnp.where(keep, lut[xy[:, 1], xy[:, 0]], -jnp.inf)
    return tos2, sae2, keep, scores


@pytest.mark.parametrize("patch", [5, 7])
@pytest.mark.parametrize("inject", [False, True])
@pytest.mark.parametrize("stcf_enabled", [True, False])
def test_fused_plain_matches_reference(patch, inject, stcf_enabled):
    """B = 2 lanes through one call vs the reference lane by lane."""
    rng = np.random.default_rng(patch * 4 + 2 * inject + stcf_enabled)
    h, w, e, b = 40, 56, 192, 2
    lanes = [_lane(rng, h, w, e) for _ in range(b)]
    bers = np.array([0.025, 0.002], np.float32)
    keys = [jax.random.split(jax.random.PRNGKey(s))[1] for s in (3, 8)]
    j_bits = [j_ber.write_error_bits(k, (h, w), jnp.float32(r))
              for k, r in zip(keys, bers)]

    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*lanes)]
    t_bits = None
    if inject:
        t_bits = t_ber.write_error_bits(
            torch.from_numpy(np.stack([np.asarray(k, np.int64)
                                       for k in keys])),
            (h, w), torch.from_numpy(bers))
        np.testing.assert_array_equal(
            t_bits.numpy(), np.stack([np.asarray(x) for x in j_bits]))
    got = t_ops.fused_step_op(*stacked, torch.from_numpy(bers), t_bits,
                              patch=patch, th=225, support=SUPPORT, tw=TW,
                              stcf_enabled=stcf_enabled)
    assert t_ops.LAUNCHES == {"fused_step": 0, "harris": 0}  # plain only

    for i, lane in enumerate(lanes):
        jl = [jnp.asarray(a) for a in lane]
        bits = j_bits[i] if inject else None
        ber = jnp.float32(bers[i])
        pallas = j_ops.fused_step_op(
            *jl, ber, bits, patch=patch, th=225, support=SUPPORT, tw=TW,
            stcf_enabled=stcf_enabled, inject_ber=inject, interpret=True)
        oracle = _jax_oracle(*jl, bits, ber, patch=patch,
                             stcf_enabled=stcf_enabled)
        for name, g, p, o in zip(("tos", "sae", "keep", "scores"), got,
                                 pallas, oracle):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(p),
                                          err_msg=name)
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(o),
                                          err_msg=name)
    if stcf_enabled:
        assert 0 < int(got[2].sum()) < int(stacked[5].sum())


def test_fused_single_lane_shapes():
    rng = np.random.default_rng(0)
    lane = [torch.from_numpy(a) for a in _lane(rng, 40, 56, 64)]
    out = t_ops.fused_step_op(*lane)
    assert [tuple(t.shape) for t in out] == [(40, 56), (40, 56), (64,),
                                             (64,)]
    assert [t.dtype for t in out] == [torch.uint8, torch.int32, torch.bool,
                                      torch.float32]


def test_fused_inputs_left_unchanged():
    rng = np.random.default_rng(1)
    lane = [torch.from_numpy(a) for a in _lane(rng, 40, 56, 64)]
    before = [t.clone() for t in lane]
    t_ops.fused_step_op(*lane)
    for a, b in zip(lane, before):
        assert torch.equal(a, b)


def test_cuda_wrapper_rejects_cpu_tensors():
    rng = np.random.default_rng(2)
    lane = [torch.from_numpy(a)[None] for a in _lane(rng, 40, 56, 64)]
    with pytest.raises(ValueError):
        fused_step.fused_step_cuda(*lane, patch=7, th=225, support=2,
                                   tw=TW, stcf_enabled=True)
