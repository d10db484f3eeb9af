"""K3's plain version (``repro_torch.kernels.compact.compact_ref``) on the
CPU against the reference's Pallas kernel (interpret mode, through
``repro.kernels.ops.compact_slots_op``) and its jnp oracle
``repro.kernels.ref.compact_ref``.  Every output is held exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as j_ops  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.kernels import compact  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CASES = [(e, cap) for e in (16, 64, 96, 128) for cap in (1, 2, 8, 16, 96)
         if cap <= e]


def _inputs(seed, shape, density):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.random(shape) < density)


def _assert_equal(got, want):
    for g, w, name in zip(got, want, ("idx", "val", "count")):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=name)


@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("e,cap", CASES)
def test_compact_ref_matches_reference(e, cap, density):
    scores, keep = _inputs(e * 1000 + cap * 10 + int(density * 7), (3, e),
                           density)
    got = compact.compact_ref(torch.from_numpy(scores),
                              torch.from_numpy(keep), cap=cap)
    pallas = j_ops.compact_slots_op(jnp.asarray(scores), jnp.asarray(keep),
                                    cap=cap)
    oracle = jax.vmap(lambda s, k: j_ref.compact_ref(s, k, cap=cap))(
        jnp.asarray(scores), jnp.asarray(keep, jnp.int32))
    _assert_equal(got, pallas)
    _assert_equal(got, oracle)
    np.testing.assert_array_equal(got[2].numpy(), keep.sum(1))


def test_compact_op_leading_shape_takes_the_plain_path_on_cpu():
    scores, keep = _inputs(3, (4, 3, 32), 0.3)
    ops.reset_launch_counts()
    got = ops.compact_slots_op(torch.from_numpy(scores),
                               torch.from_numpy(keep), cap=4)
    assert ops.LAUNCHES["compact"] == 0
    assert [tuple(t.shape) for t in got] == [(4, 3, 4), (4, 3, 4), (4, 3)]
    want = j_ops.compact_slots_op(jnp.asarray(scores), jnp.asarray(keep),
                                  cap=4)
    _assert_equal(got, want)
