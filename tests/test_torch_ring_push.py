"""The port's plain ring push (``repro_torch.core.state.ring_push`` /
``ring_push_compact`` on CPU tensors, i.e. ``kernels.compact.ring_push_ref``)
against the reference's ``repro.core.state.ring_push`` /
``ring_push_compact`` (``active=True``, ``compact_fn`` bound to the vmapped
jnp oracle ``repro.kernels.ref.compact_ref``).

Sequences of pushes made from a numpy seed: rows with none kept and rows
with all kept, more pushes than the ring has slots (so ``dropped``
counts), and a drain's ``_reset_ring`` between pushes.  After every push
each leaf, the cursors included, is held bit for bit.  The launcher's
Python checks of ``ring_push_cuda`` are held here too; the kernel itself
runs only on the card (``tests/test_torch_cuda.py``)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import state as j_state  # noqa: E402
from repro.kernels import ref as j_ref  # noqa: E402
from repro_torch.core import state as t_state  # noqa: E402
from repro_torch.kernels import compact, ops  # noqa: E402
from repro_torch.serve.runtime import PoolRuntime  # noqa: E402


def _rounds(seed, n, lanes, e):
    """``n`` rounds of lane rows: the first keeps nothing, the second
    everything, the rest a random share per lane."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        density = {0: 0.0, 1: 1.0}.get(i, rng.random((lanes, 1)))
        keep = rng.random((lanes, e)) < density
        out.append(dict(
            scores=rng.standard_normal((lanes, e)).astype(np.float32),
            keep=keep, n_kept=keep.sum(-1).astype(np.int32),
            vdd_idx=rng.integers(0, 9, lanes).astype(np.int32),
            n_valid=rng.integers(0, e + 1, lanes).astype(np.int32),
            mask=rng.random(lanes) < 0.7))
    return out


def _assert_ring_equal(got, want, fields, step):
    for name in fields:
        np.testing.assert_array_equal(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            err_msg=f"{name} after push {step}")


@functools.lru_cache(maxsize=None)
def _j_push(cap):
    if cap is None:
        return jax.jit(j_state.ring_push)
    oracle = jax.vmap(functools.partial(j_ref.compact_ref, cap=cap))
    return jax.jit(functools.partial(j_state.ring_push_compact,
                                     compact_fn=oracle))


@pytest.mark.parametrize("cap", ["dense", 1, "E/8", "E"])
@pytest.mark.parametrize("e", [37, 512])
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("rounds", [1, 3])
def test_plain_push_matches_reference(rounds, lanes, e, cap):
    cap = {"dense": None, "E/8": e // 8, "E": e}.get(cap, cap)
    if cap is None:
        got = t_state.ring_init(rounds, lanes, e, device="cpu")
        want = j_state.ring_init(rounds, lanes, e)
        push = t_state.ring_push
    else:
        got = t_state.compact_ring_init(rounds, lanes, e, cap, device="cpu")
        want = j_state.compact_ring_init(rounds, lanes, e, cap)
        push = t_state.ring_push_compact
    n = 2 * rounds + 3
    for step, r in enumerate(_rounds(rounds * 100 + lanes * 10 + e, n,
                                     lanes, e)):
        if step == rounds + 1:          # a drain between pushes
            PoolRuntime._reset_ring(got)
            want = want._replace(count=np.int32(0), dropped=np.int32(0))
        t_outs = t_state.ChunkOutput(
            *(torch.from_numpy(r[k])
              for k in ("scores", "keep", "n_kept", "vdd_idx")))
        before = dict(ops.LAUNCHES)
        assert push(got, t_outs, torch.from_numpy(r["mask"]),
                    torch.from_numpy(r["n_valid"])) is got
        assert ops.LAUNCHES == before   # the plain version, not the kernel
        j_outs = j_state.ChunkOutput(
            *(r[k] for k in ("scores", "keep", "n_kept", "vdd_idx")))
        want = _j_push(cap)(want, j_outs, r["mask"], r["n_valid"], True)
        _assert_ring_equal(got, want, type(got)._fields, step)
    assert int(got.dropped) > 0     # R + 2 pushes after the drain


def _ring(compact_ring):
    if compact_ring:
        return t_state.compact_ring_init(3, 4, 64, 8, device="cpu")
    return t_state.ring_init(3, 4, 64, device="cpu")


def _rows(lanes=4, e=64):
    return (torch.zeros((lanes, e)),
            torch.zeros((lanes, e), dtype=torch.bool),
            *(torch.zeros(lanes, dtype=torch.int32) for _ in range(3)),
            torch.zeros(lanes, dtype=torch.bool))


@pytest.mark.parametrize("compact_ring", [False, True])
def test_push_launcher_checks(compact_ring):
    """``ring_push_cuda``'s host side: a CPU ring is refused before any
    launch; a ring is checked once (its plan is kept on ``head``), and
    each push's rows against it."""
    ring = _ring(compact_ring)
    with pytest.raises(ValueError, match="needs a CUDA ring"):
        compact.ring_push_cuda(ring, *_rows())
    plan = compact._plan(ring)
    assert compact._plan(ring) is plan
    assert (plan.desc.cap > 0) == compact_ring
    assert plan.desc.cursors == ring.head.data_ptr()
    compact._check_rows(plan, _rows())
    bad = list(_rows())
    bad[0] = bad[0][:, :32]
    with pytest.raises(ValueError, match="scores must be"):
        compact._check_rows(plan, bad)
    bad = list(_rows())
    bad[3] = bad[3].long()
    with pytest.raises(ValueError, match="vdd_idx must be"):
        compact._check_rows(plan, bad)
    bad = list(_rows())
    bad[1] = torch.zeros((64, 4), dtype=torch.bool).t()
    with pytest.raises(ValueError, match="keep must be"):
        compact._check_rows(plan, bad)


def test_push_launcher_refuses_loose_cursors():
    """A ring whose cursors are not ``ring_init``'s block of four has no
    room for the kernel's ticket."""
    ring = _ring(False)
    loose = ring._replace(head=torch.zeros((), dtype=torch.int32),
                          count=torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="one int32 block of four"):
        compact._plan(loose)
    # a ring rebuilt around another leaf gets a plan of its own
    plan = compact._plan(ring)
    other = ring._replace(scores=torch.zeros_like(ring.scores))
    assert compact._plan(other) is not plan
    assert compact._plan(other).desc.scores == other.scores.data_ptr()
