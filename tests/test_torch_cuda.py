"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips without a CUDA device.  This module imports
no jax, so it also runs on a GPU host without the JAX reference:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import ber as t_ber  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.stcf import NEVER  # noqa: E402
from repro_torch.kernels import fused_step, harris_conv, ops  # noqa: E402

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


@pytest.mark.parametrize("hw", [(180, 240), (720, 1280), (37, 101)])
def test_harris_kernel_matches_plain(cuda, hw):
    rng = np.random.default_rng(hw[0])
    tos = rng.integers(0, 256, (2, *hw))
    tos = torch.from_numpy(np.where(tos >= 225, tos, 0).astype(np.uint8))
    plain = harris_conv.harris_ref(tos.to(cuda))
    got = harris_conv.harris_cuda(tos.to(cuda))
    err = (got - plain).abs().max().item()
    assert err <= REL * plain.abs().max().item()
