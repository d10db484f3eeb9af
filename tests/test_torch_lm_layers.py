"""The LM scaffold's layer functions in the port, held to ``repro.models``
on the same numpy inputs and weights: norms and RoPE, GQA attention (dense,
blockwise, decode with and without int8 KV and ring writes), MLA train and
decode, the SwiGLU MLP, MoE (capacity-limited and dropless) and the SSD
blocks.

Bounds (float32): ``F32 = 1e-4`` times ``max(1, max|ref|)`` (max |delta|
over the output); the int8 KV values, MoE routing integers (``topi``,
``order``, ``pos_in_e``, ``keep``, ``idx``) and top-k tie order exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_harness import BF16, assert_close, cfg_pair, t, to_np
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import mlp as JM
from repro.models import ssm as JS
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import mlp as TM
from repro_torch.models import ssm as TS


def _params(spec_j, spec_t, seed, tcfg):
    p, _ = JC.init_dense(jax.random.PRNGKey(seed), spec_j, jnp.float32)
    return p, TC.params_from_numpy(to_np(p), tcfg, "cpu")


def _x(shape, seed=0, scale=1.0):
    a = (np.random.default_rng(seed).normal(0, scale, shape)
         .astype(np.float32))
    return jnp.asarray(a), t(a)


# --- norms, RoPE ------------------------------------------------------------


def test_norms_and_rope_match():
    xj, xt = _x((2, 5, 48), 1, 3.0)
    gj, gt = _x((48,), 2)
    bj, bt = _x((48,), 3)
    assert_close(TC.rms_norm(xt, gt, 1e-6), JC.rms_norm(xj, gj, 1e-6),
                 what="rms_norm")
    assert_close(TC.layer_norm(xt, gt, bt, 1e-5),
                 JC.layer_norm(xj, gj, bj, 1e-5), what="layer_norm")
    # An angle is position times frequency, and the frequencies come from
    # two float32 ``pow``s: the tables are held up to position 4,000.
    pos = np.arange(0, 4000, 37)[None, :]
    for dim, theta in ((64, 1e6), (16, 1e4), (8, 1e4)):
        cj, sj = JC.make_rope(jnp.asarray(pos), dim, theta)
        ct, st = TC.make_rope(t(pos), dim, theta)
        assert_close(ct, cj, 1e-5, "cos")
        assert_close(st, sj, 1e-5, "sin")
    cj, sj = JC.make_rope(jnp.arange(5)[None], 48, 1e4)
    ct, st = TC.make_rope(torch.arange(5)[None], 48, 1e4)
    qj, qt = _x((2, 5, 3, 48), 4)
    assert_close(TC.apply_rope(qt, ct, st), JC.apply_rope(qj, cj, sj),
                 what="apply_rope")
    np.testing.assert_array_equal(TC.sinusoidal_positions(30, 16),
                                  JC.sinusoidal_positions(30, 16))


# --- GQA ---------------------------------------------------------------------


@pytest.mark.parametrize("window", [0, 5])
def test_attend_and_blockwise_match(window):
    jcfg, tcfg = cfg_pair("qwen2_5_3b", sliding_window=window)
    b, s, h, k, dh = 2, 32, 4, 2, 16
    qj, qt = _x((b, s, h, dh), 1)
    kj, kt = _x((b, s, k, dh), 2)
    vj, vt = _x((b, s, k, dh), 3)
    mask_j = JA._causal_mask(s, s, 0, window)
    mask_t = TA._causal_mask(s, s, 0, window)
    np.testing.assert_array_equal(to_np(mask_t), to_np(mask_j))
    dense_j = JA._attend(qj, kj, vj, mask_j, jcfg)
    dense_t = TA._attend(qt, kt, vt, mask_t, tcfg)
    assert_close(dense_t, dense_j, what="_attend")
    for chunk in (8, 32):
        blk_j = JA._attend_blockwise_causal(qj, kj, vj, jcfg, chunk)
        blk_t = TA._attend_blockwise_causal(qt, kt, vt, tcfg, chunk)
        assert_close(blk_t, blk_j, what=f"blockwise chunk {chunk}")
        assert_close(blk_t, dense_t, what=f"blockwise vs dense {chunk}")


def test_self_attend_switches_to_blockwise_as_the_reference():
    jcfg, tcfg = cfg_pair("qwen2_5_3b", attn_chunk=1024)
    b, s, h, k, dh = 1, 2048, 2, 1, 8
    qj, qt = _x((b, s, h, dh), 5)
    kj, kt = _x((b, s, k, dh), 6)
    vj, vt = _x((b, s, k, dh), 7)
    assert_close(TA._self_attend(qt, kt, vt, tcfg),
                 JA._self_attend(qj, kj, vj, jcfg), what="2048 tokens")


def test_gqa_train_returns_the_roped_kv():
    jcfg, tcfg = cfg_pair("qwen2_0_5b")
    pj, pt = _params(JA.gqa_spec(jcfg), TA.gqa_spec(tcfg), 1, tcfg)
    pj = dict(pj, bq=pj["bq"] + 0.1, bk=pj["bk"] - 0.2, bv=pj["bv"] + 0.3)
    pt = TC.params_from_numpy(to_np(pj), tcfg, "cpu")
    xj, xt = _x((2, 12, jcfg.d_model), 2)
    cj, sj = JC.make_rope(jnp.arange(12)[None], jcfg.head_dim, 1e4)
    ct, st = TC.make_rope(torch.arange(12)[None], tcfg.head_dim, 1e4)
    oj, (kj, vj) = JA.gqa_train(pj, xj, cj, sj, jcfg, return_kv=True)
    ot, (kt, vt) = TA.gqa_train(pt, xt, ct, st, tcfg, return_kv=True)
    assert_close(ot, oj, what="out")
    assert_close(kt, kj, what="k")
    assert_close(vt, vj, what="v")


def test_kv_quant_rounds_half_to_even_as_the_reference():
    # values whose scaled form lands on .5: 127 * v / max|v|
    row = np.array([127.0, 0.5, 1.5, 2.5, -3.5, -0.5, 63.5, -126.5],
                   np.float32)
    a = np.stack([row, row * 0.37, -row * 1e-3, np.zeros(8, np.float32)])
    a = a.reshape(1, 1, 4, 8)
    qj, sj = JA._kv_quant(jnp.asarray(a))
    qt, st = TA._kv_quant(t(a))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(
        TA._kv_dequant(qt, st, torch.float32).numpy(),
        np.asarray(JA._kv_dequant(qj, sj, jnp.float32)))


@pytest.mark.parametrize("case", ["plain", "int8", "ring", "int8 ring",
                                  "window"])
def test_gqa_decode_matches(case):
    window = 6 if case in ("ring", "int8 ring", "window") else 0
    jcfg, tcfg = cfg_pair("qwen2_0_5b", kv_quant="int8" in case,
                          sliding_window=window)
    pj, pt = _params(JA.gqa_spec(jcfg), TA.gqa_spec(tcfg), 3, tcfg)
    b, length = 2, 6 if "ring" in case else 16
    spec = TA.gqa_cache_spec(tcfg, b, length)
    ct = {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in spec.items()}
    cj = {k: jnp.zeros(v.shape, v.dtype)
          for k, v in JA.gqa_cache_spec(jcfg, b, length).items()}
    steps = 11 if "ring" in case else length     # a ring wraps once
    xs = np.random.default_rng(4).normal(0, 1, (steps, b, 1, jcfg.d_model))
    for pos in range(steps):
        x = xs[pos].astype(np.float32)
        wp = pos % length if "ring" in case else None
        oj, cj = JA.gqa_decode(pj, jnp.asarray(x), cj, jnp.int32(pos), jcfg,
                               write_pos=None if wp is None
                               else jnp.int32(wp))
        before = {k: v.clone() for k, v in ct.items()}
        ot, ct2 = TA.gqa_decode(pt, t(x), ct, pos, tcfg, write_pos=wp)
        assert all(torch.equal(before[k], ct[k]) for k in ct)  # functional
        ct = ct2
        assert_close(ot, oj, what=f"{case} out at {pos}")
        for k in ct:
            if ct[k].dtype == torch.int8:
                np.testing.assert_array_equal(ct[k].numpy(), np.asarray(cj[k]))
            else:
                assert_close(ct[k], cj[k], what=f"{case} cache {k} at {pos}")


def test_mla_train_and_decode_match():
    jcfg, tcfg = cfg_pair("deepseek_v3_671b")
    pj, pt = _params(JA.mla_spec(jcfg), TA.mla_spec(tcfg), 3, tcfg)
    b, s = 2, 8
    xj, xt = _x((b, s, jcfg.d_model), 4)
    cj, sj = JC.make_rope(jnp.arange(s)[None], jcfg.qk_rope_dim, 1e4)
    ct, st = TC.make_rope(torch.arange(s)[None], tcfg.qk_rope_dim, 1e4)
    yj, (ckv_j, kr_j) = JA.mla_train(pj, xj, cj, sj, jcfg, return_kv=True)
    yt, (ckv_t, kr_t) = TA.mla_train(pt, xt, ct, st, tcfg, return_kv=True)
    assert_close(yt, yj, what="mla_train")
    assert_close(ckv_t, ckv_j, what="ckv")
    assert_close(kr_t, kr_j, what="k_rope")
    cache_j = {k: jnp.zeros(v.shape, v.dtype)
               for k, v in JA.mla_cache_spec(jcfg, b, s).items()}
    cache_t = {k: torch.zeros(v.shape, dtype=v.dtype)
               for k, v in TA.mla_cache_spec(tcfg, b, s).items()}
    for pos in range(s):
        dj, cache_j = JA.mla_decode(pj, xj[:, pos:pos + 1], cache_j,
                                    jnp.int32(pos), jcfg)
        dt, cache_t = TA.mla_decode(pt, xt[:, pos:pos + 1], cache_t, pos,
                                    tcfg)
        assert_close(dt, dj, what=f"mla_decode at {pos}")
        for k in cache_t:
            assert_close(cache_t[k], cache_j[k], what=f"cache {k} at {pos}")
    # the absorbed-matrix decode equals the train attention's last position
    assert_close(dt, yt[:, -1:], 1e-3, "decode vs train")


# --- MLP, MoE ----------------------------------------------------------------


def test_mlp_apply_matches():
    jcfg, tcfg = cfg_pair("stablelm_3b")
    pj, pt = _params(JM.mlp_spec(jcfg), TM.mlp_spec(tcfg), 5, tcfg)
    xj, xt = _x((2, 7, jcfg.d_model), 6)
    assert_close(TM.mlp_apply(pt, xt), JM.mlp_apply(pj, xj), what="mlp")


def test_top_k_orders_ties_as_the_reference():
    s = np.array([[0.5, 0.2, 0.5, 0.5, 0.1, 0.2],
                  [0.1, 0.1, 0.1, 0.1, 0.1, 0.1],
                  [0.3, 0.9, 0.3, 0.9, 0.0, 0.3]], np.float32)
    for k in (1, 2, 3, 5):
        wj, ij = jax.lax.top_k(jnp.asarray(s), k)
        wt, it = TM._top_k(t(s), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(wt.numpy(), np.asarray(wj))


def _reference_routing(x2, router, cfg, capacity, score_fn):
    """``moe_apply``'s integer routing, line for line (mlp.py:107-128)."""
    t_, e, k = x2.shape[0], cfg.n_experts, cfg.top_k
    logits = jnp.einsum("td,de->te", x2, router)
    topw, topi, _ = JM._route(logits, k, score_fn)
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=e)
    starts = jnp.cumsum(counts) - counts
    pos_in_e = (jnp.arange(t_ * k, dtype=jnp.int32)
                - starts[sorted_e].astype(jnp.int32))
    keep = pos_in_e < capacity
    token_of = (order // k).astype(jnp.int32)
    idx = jnp.full((e, capacity), t_, dtype=jnp.int32)
    safe_pos = jnp.clip(pos_in_e, 0, capacity - 1)
    idx = idx.at[sorted_e, safe_pos].set(jnp.where(keep, token_of, t_))
    return {"topi": topi, "order": order, "pos_in_e": pos_in_e,
            "keep": keep, "idx": idx}


@pytest.mark.parametrize("arch,dropless,tokens", [
    ("olmoe_1b_7b", False, 32), ("olmoe_1b_7b", True, 32),
    ("olmoe_1b_7b", False, 5), ("deepseek_v3_671b", False, 24),
    ("deepseek_v3_671b", True, 3)])
def test_moe_apply_matches_with_exact_routing(arch, dropless, tokens):
    jcfg, tcfg = cfg_pair(arch)
    score_fn = "sigmoid" if jcfg.mla else "softmax"
    pj, pt = _params(JM.moe_spec(jcfg), TM.moe_spec(tcfg), 7, tcfg)
    # a router that favours two experts, so capacity overflows
    r = np.asarray(pj["router"]).copy()
    r[:, :2] += 0.5
    pj = dict(pj, router=jnp.asarray(r))
    pt = TC.params_from_numpy(to_np(pj), tcfg, "cpu")
    xj, xt = _x((2, tokens // 2 or 1, jcfg.d_model), 8)
    if tokens % 2:
        xj, xt = _x((1, tokens, jcfg.d_model), 8)
    oj, aj = JM.moe_apply(pj, xj, jcfg, score_fn=score_fn, dropless=dropless)
    ot, at = TM.moe_apply(pt, xt, tcfg, score_fn=score_fn, dropless=dropless)
    assert_close(ot, oj, what="moe out")
    assert_close(at, aj, what="aux")

    t_ = xj.shape[0] * xj.shape[1]
    e, k = jcfg.n_experts, jcfg.top_k
    capacity = t_ if dropless else max(int(t_ * k / e * 1.25), k)
    want = _reference_routing(xj.reshape(t_, -1), pj["router"], jcfg,
                              capacity, score_fn)
    logits = torch.einsum("td,de->te", xt.reshape(t_, -1), pt["router"])
    topw, topi, _ = TM._route(logits, k, score_fn)
    got = dict(TM.moe_dispatch(topi, topw, e, capacity), topi=topi)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(w),
                                      err_msg=name)
    if not dropless:
        assert not bool(jnp.all(want["keep"])), "no assignment was dropped"


# --- SSD -----------------------------------------------------------------------


def test_ssm_train_and_decode_match():
    jcfg, tcfg = cfg_pair("mamba2_370m")
    pj, pt = _params(JS.ssm_spec(jcfg), TS.ssm_spec(tcfg), 1, tcfg)
    b, seq = 2, 32
    xj, xt = _x((b, seq, jcfg.d_model), 2)
    yj = JS.ssm_train(pj, xj, jcfg)
    yt = TS.ssm_train(pt, xt, tcfg)
    assert_close(yt, yj, what="ssm_train")
    conv_j, _ = JS._causal_conv(JS._split_proj(pj, xj, jcfg)[1],
                                pj["conv_w"], pj["conv_b"])
    conv_t, _ = TS._causal_conv(TS._split_proj(pt, xt, tcfg)[1],
                                pt["conv_w"], pt["conv_b"])
    assert_close(conv_t, conv_j, what="_causal_conv")
    a = np.random.default_rng(3).normal(0, 1, (2, 3, 16)).astype(np.float32)
    sj, st = JS._segsum(jnp.asarray(a)), TS._segsum(t(a))
    np.testing.assert_array_equal(np.isinf(st.numpy()), np.isinf(sj))
    fin = np.isfinite(np.asarray(sj))
    assert_close(st.numpy()[fin], np.asarray(sj)[fin], what="_segsum")

    state_j = {k: jnp.zeros(v.shape, v.dtype)
               for k, v in JS.ssm_state_spec(jcfg, b).items()}
    state_t = {k: torch.zeros(v.shape, dtype=v.dtype)
               for k, v in TS.ssm_state_spec(tcfg, b).items()}
    ys = []
    for i in range(seq):
        oj, state_j = JS.ssm_decode(pj, xj[:, i:i + 1], state_j, jcfg)
        ot, state_t = TS.ssm_decode(pt, xt[:, i:i + 1], state_t, tcfg)
        assert_close(ot, oj, what=f"ssm_decode at {i}")
        for k in state_t:
            assert_close(state_t[k], state_j[k], what=f"state {k} at {i}")
        ys.append(ot)
    # SSD parallel == recurrent, the reference's own bound
    np.testing.assert_allclose(yt.numpy(), torch.cat(ys, 1).numpy(),
                               atol=2e-5, rtol=1e-4)


def test_ssm_bf16_matches_within_the_reference_bound():
    jcfg, tcfg = cfg_pair("mamba2_370m", "bf16")
    p32j, _ = JC.init_dense(jax.random.PRNGKey(1), JS.ssm_spec(jcfg),
                            jnp.float32)
    pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16), p32j)
    pt = TC.params_from_numpy(to_np(pj), tcfg, "cpu")
    xj, xt = _x((2, 32, jcfg.d_model), 2)
    yj = JS.ssm_train(pj, xj.astype(jnp.bfloat16), jcfg)
    yt = TS.ssm_train(pt, xt.to(torch.bfloat16), tcfg)
    np.testing.assert_allclose(to_np(yt), to_np(yj), atol=BF16, rtol=BF16)
