"""The LM scaffold's decode path in the port, per architecture, held to
``repro.models.transformer`` on the same weights (JAX's ``init_params``
at ``PRNGKey(0)``, carried over) at the smoke configs in float32:
``forward_decode`` for 3 steps from ``zeros_cache`` (logits and every
cache leaf), the greedy tokens, and ``forward_prefill_cache`` against JAX
and against the port's own stepwise decode.

Bounds: ``F32 = 1e-4`` times ``max(1, max|ref|)`` (max |delta| per
tree); greedy tokens exact; the caller's cache untouched.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_harness import (assert_close, batch_pair, cfg_pair,
                               params_pair, t, to_np)
from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch.models import transformer as TT

B, CACHE_LEN = 2, 16
PREFILL_ARCHS = [a for a in jconfigs.ARCHS
                 if jconfigs.get_smoke(a).family in ("dense", "vlm", "moe")]


@pytest.fixture(scope="module", params=jconfigs.ARCHS)
def arch(request):
    return request.param


@pytest.fixture(scope="module")
def decode_run(arch):
    """Three greedy steps in both packages, each fed JAX's argmax."""
    jcfg, tcfg = cfg_pair(arch)
    jp, tp = params_pair(jcfg, tcfg)
    step = jax.jit(lambda p, x, c, pos: JT.forward_decode(p, x, c, pos,
                                                          jcfg))
    jc = JT.zeros_cache(jcfg, B, CACHE_LEN)
    tc = TT.zeros_cache(tcfg, B, CACHE_LEN, "cpu")
    toks = np.random.default_rng(0).integers(1, jcfg.vocab, (B, 1))
    toks = toks.astype(np.int32)
    steps = []
    for pos in range(3):
        jl, jc = step(jp, jnp.asarray(toks), jc, jnp.int32(pos))
        before = to_np(tc)
        tl, tc_new = TT.forward_decode(tp, t(toks), tc, pos, tcfg)
        steps.append(dict(jl=jl, tl=tl, jc=jc, tc=tc_new,
                          untouched=_tree_equal(to_np(tc), before)))
        tc = tc_new
        toks = np.asarray(jl)[:, -1].argmax(-1)[:, None].astype(np.int32)
    return steps


def _tree_equal(a, b):
    if isinstance(a, dict):
        return all(_tree_equal(a[k], b[k]) for k in a)
    return np.array_equal(a, b)


def test_decode_logits_match(decode_run, arch):
    for pos, s in enumerate(decode_run):
        assert s["tl"].shape == s["jl"].shape
        assert_close(s["tl"], s["jl"], what=f"{arch} logits at {pos}")


def test_decode_caches_match(decode_run, arch):
    for pos, s in enumerate(decode_run):
        assert_close(s["tc"], s["jc"], what=f"{arch} cache at {pos}")
        assert s["untouched"], "forward_decode wrote into its input cache"


def test_decode_greedy_tokens_equal(decode_run):
    for s in decode_run:
        want = np.asarray(s["jl"])[:, -1].argmax(-1)
        got = s["tl"][:, -1].float().argmax(-1).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("prefill_arch", PREFILL_ARCHS)
def test_prefill_cache_matches_reference_and_stepwise_decode(prefill_arch):
    jcfg, tcfg = cfg_pair(prefill_arch)
    jp, tp = params_pair(jcfg, tcfg)
    # the image stub takes the first n_img_tokens slots of the prompt
    seq = 12 + (jcfg.n_img_tokens if jcfg.family == "vlm" else 0)
    jb, tb = batch_pair(jcfg, tcfg, b=2, s=seq, labels=False)
    cache_len = seq + 12
    jl, jc, jpos = jax.jit(lambda p, b: JT.forward_prefill_cache(
        p, b, jcfg, cache_len))(jp, jb)
    tl, tc, tpos = TT.forward_prefill_cache(tp, tb, tcfg, cache_len)
    assert tpos == int(jpos) == seq
    assert_close(tl, jl, what="prefill logits")
    assert_close(tc, jc, what="prefill cache")

    # the port's own stepwise decode from an empty cache agrees
    if jcfg.family != "vlm":
        sc = TT.zeros_cache(tcfg, 2, cache_len, "cpu")
        for i in range(seq):
            sl, sc = TT.forward_decode(tp, tb["tokens"][:, i:i + 1], sc, i,
                                       tcfg)
        assert_close(sl, tl, what="stepwise vs prefill logits")
        assert_close(sc, tc, what="stepwise vs prefill cache")
    nxt = tl[:, -1].float().argmax(-1)[:, None].to(torch.int32)
    la, _ = TT.forward_decode(tp, nxt, tc, tpos, tcfg)
    lj, _ = jax.jit(lambda p, x, c: JT.forward_decode(
        p, x, c, jnp.int32(seq), jcfg))(jp, jnp.asarray(nxt.numpy()), jc)
    assert_close(la, lj, what="decode after prefill")


def test_prefill_cache_refuses_other_families():
    for arch in ("mamba2_370m", "zamba2_1_2b", "whisper_tiny"):
        _, tcfg = cfg_pair(arch)
        with pytest.raises(NotImplementedError):
            TT.forward_prefill_cache({}, {"tokens": torch.zeros(1, 4)},
                                     tcfg, 8)
