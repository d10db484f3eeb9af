"""The LM scaffold's full-sequence forwards in the port, per architecture,
held to ``repro.models.transformer`` on the same weights and batches at
the smoke configs: ``forward_prefill`` (last-position logits; Whisper's is
the loss) and the ``forward_train`` loss with its metrics (CE, MoE aux,
DeepSeek's MTP), in float32; then one bf16 case per family (decode and
prefill logits) at the reference's own bf16 bound.

Bounds: float32 ``F32 = 1e-4`` times ``max(1, max|ref|)``.  bf16: the
reference's bound ``BF16 = 5e-2`` (``tests/test_serving_parity.py``) on
top of the reference's own bf16 error: max |port bf16 - ref f32| <=
max |ref bf16 - ref f32| + 5e-2, where "ref f32" is the reference in
float32 on the same bf16-rounded weights.  A direct port-vs-reference bf16
bound of 5e-2 does not hold everywhere: two bf16 implementations round
differently, and MoE capacity competition and Zamba2's stack amplify it
(max |delta| 0.08-0.20, with both runs 0.1-0.9 from float32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_lm_harness import (BF16, assert_close, batch_pair, cfg_pair,
                               params_pair, t, to_np)
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch.models import transformer as TT

FAMILY_CASES = {}
for _a in jconfigs.ARCHS:
    FAMILY_CASES.setdefault(jconfigs.get_smoke(_a).family, _a)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_prefill_and_loss_match(arch):
    jcfg, tcfg = cfg_pair(arch)
    jp, tp = params_pair(jcfg, tcfg)
    jb, tb = batch_pair(jcfg, tcfg, b=2, s=64)

    want = jax.jit(lambda p, b: JT.forward_prefill(p, b, jcfg))(jp, jb)
    got = TT.forward_prefill(tp, tb, tcfg)
    assert tuple(got.shape) == tuple(np.shape(want))
    assert_close(got, want, what=f"{arch} forward_prefill")

    loss_j, m_j = jax.jit(lambda p, b: JT.forward_train(p, b, jcfg))(jp, jb)
    loss_t, m_t = TT.forward_train(tp, tb, tcfg)
    assert np.isfinite(float(loss_t))
    assert_close(loss_t, loss_j, what=f"{arch} loss")
    assert set(m_t) == set(m_j)
    for k in m_j:
        assert_close(m_t[k], m_j[k], what=f"{arch} metric {k}")


def _bf16_err(got, want, truth):
    """The port's bf16 run may sit no farther from the float32 run than
    the reference's bf16 run does, plus the reference's bf16 bound."""
    got, want, truth = to_np(got), to_np(want), to_np(truth)
    port, ref = np.abs(got - truth).max(), np.abs(want - truth).max()
    assert port <= ref + BF16, (port, ref)


@pytest.mark.parametrize("family", sorted(FAMILY_CASES))
def test_bf16_matches_within_the_reference_bound(family):
    arch = FAMILY_CASES[family]
    jcfg, tcfg = cfg_pair(arch, "bf16")
    j32, _ = cfg_pair(arch, "f32")
    jp, tp = params_pair(jcfg, tcfg)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    b, length = 2, 16
    step = jax.jit(lambda p, x, c, pos: JT.forward_decode(p, x, c, pos,
                                                          jcfg))
    step32 = jax.jit(lambda p, x, c, pos: JT.forward_decode(p, x, c, pos,
                                                            j32))
    jc = JT.zeros_cache(jcfg, b, length)
    jc32 = JT.zeros_cache(j32, b, length)
    tc = TT.zeros_cache(tcfg, b, length, "cpu")
    stream = np.random.default_rng(1).integers(1, jcfg.vocab, (4, b, 1))
    for pos in range(4):
        toks = jnp.asarray(stream[pos].astype(np.int32))
        jl, jc = step(jp, toks, jc, jnp.int32(pos))
        jl32, jc32 = step32(jp32, toks, jc32, jnp.int32(pos))
        tl, tc = TT.forward_decode(tp, t(np.asarray(toks)), tc, pos, tcfg)
        _bf16_err(tl, jl, jl32)
    jb, tb = batch_pair(jcfg, tcfg, b=2, s=32)
    jb32, _ = batch_pair(j32, tcfg, b=2, s=32)
    want = jax.jit(lambda p, bb: JT.forward_prefill(p, bb, jcfg))(jp, jb)
    truth = jax.jit(lambda p, bb: JT.forward_prefill(p, bb, j32))(jp32, jb32)
    _bf16_err(TT.forward_prefill(tp, tb, tcfg), want, truth)
