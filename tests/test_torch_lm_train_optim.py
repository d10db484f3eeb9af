"""The LM scaffold's optimizer and gradient compression in the port
(``repro_torch.train.optimizer``, ``repro_torch.train.compression``) held
to the reference's on the same inputs, then the reference's own cases of
``tests/test_train_infra.py`` reproduced on the port.

Bounds: ``adamw_update`` fed the same gradients: params, ``m`` and ``v``
within ``1e-6 * max(1, max|ref|)``, ``step`` exactly equal, ``lr`` within
``LR_REL`` of the peak rate ``cfg.lr``, ``grad_norm`` within 1e-6
relative; ``cosine_lr`` within the same bound over steps 0-300, exactly
equal at step 0 and at the end of the warm-up.  (``lr`` is not exact:
the reference is not exact to itself there.  Under ``jax.jit`` XLA
divides by the constant warm-up as a multiply by its reciprocal and takes
its own ``cos``, and differs from its eager run by an ulp at 1 step in 3;
near the end of the schedule ``1 + cos`` cancels, so an ulp of ``cos`` is
4.5e-6 of the rate.); ``quant_int8``'s ``q`` and ``scale``, ``fake_quant_int8``
and ``ErrorFeedback`` (output and residual) exactly equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_harness import flat, t, to_np
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro_torch.train import compression as tcomp
from repro_torch.train import optimizer as topt

OPT_BOUND = 1e-6
LR_REL = 1e-6


SHAPES = {"w": (3, 17, 5), "b": (17,), "nested": {"x": (300,)}}


def _nested(shapes, rng, scale=1.0):
    if isinstance(shapes, dict):
        return {k: _nested(v, rng, scale) for k, v in shapes.items()}
    return (scale * rng.normal(0, 1, shapes)).astype(np.float32)


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return t(tree)


def _close(got, want, what):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        scale = max(1.0, float(np.abs(w[k]).max()))
        err = float(np.abs(g[k] - w[k]).max())
        assert err <= OPT_BOUND * scale, (what, k, err)


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])
def test_adamw_update_matches_on_the_same_gradients(clip_norm):
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=5, clip_norm=clip_norm)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    rng = np.random.default_rng(0)
    params = _nested(SHAPES, rng)
    jp, tp = _jax(params), _torch(params)
    js, ts = jopt.adamw_init(jp, jcfg), topt.adamw_init(tp, tcfg)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    jupd = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jcfg))
    for step in range(1, 7):
        grads = _nested(SHAPES, rng, scale=0.3 * step)
        before = flat(tp)      # float64 copies
        jp, js, jm = jupd(jp, _jax(grads), js)
        tp2, ts, tm = topt.adamw_update(tp, _torch(grads), ts, tcfg)
        assert all(np.array_equal(before[k], v) for k, v in flat(tp).items())
        tp = tp2
        _close(tp, jp, f"params at {step}")
        _close(ts["m"], js["m"], f"m at {step}")
        _close(ts["v"], js["v"], f"v at {step}")
        assert ts["step"].dtype == torch.int32
        assert int(ts["step"]) == int(js["step"]) == step
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= LR_REL * kw["lr"]
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-6 * float(jm["grad_norm"])


def test_adamw_keeps_dtypes():
    cfg = topt.AdamWConfig(state_dtype=torch.bfloat16)
    params = {"a": torch.ones(4, dtype=torch.bfloat16),
              "b": torch.ones(3, dtype=torch.float32)}
    state = topt.adamw_init(params, cfg)
    grads = {"a": torch.full((4,), 0.5, dtype=torch.bfloat16),
             "b": torch.full((3,), 0.5, dtype=torch.float32)}
    p2, s2, m = topt.adamw_update(params, grads, state, cfg)
    assert p2["a"].dtype == torch.bfloat16 and p2["b"].dtype == torch.float32
    assert s2["m"]["a"].dtype == s2["v"]["b"].dtype == torch.bfloat16
    assert m["grad_norm"].dtype == m["lr"].dtype == torch.float32


def test_cosine_lr_matches_over_300_steps():
    kw = dict(lr=3e-4, warmup_steps=20, total_steps=250)
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    steps = np.arange(0, 301, dtype=np.int32)
    want = np.asarray(jax.jit(lambda s: jopt.cosine_lr(jcfg, s))(steps))
    got = topt.cosine_lr(tcfg, t(steps)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LR_REL * kw["lr"])
    assert got[0] == want[0] == 0.0 and got[20] == want[20] == np.float32(3e-4)
    for s in (0, 7, 20, 133, 250, 300):
        assert np.float32(topt.cosine_lr(tcfg, s)) == got[s]


@pytest.mark.parametrize("shape", [(1000,), (256,), (7,), (3, 300), (2, 128)])
def test_quant_int8_matches_exactly(shape):
    x = np.random.default_rng(3).normal(0, 2, shape).astype(np.float32)
    q_j, s_j, shape_j, pad_j = jcomp.quant_int8(jnp.asarray(x))
    q_t, s_t, shape_t, pad_t = tcomp.quant_int8(t(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert shape_t == tuple(shape_j) and pad_t == pad_j
    np.testing.assert_array_equal(
        tcomp.dequant_int8(q_t, s_t, shape_t, pad_t).numpy(),
        np.asarray(jcomp.dequant_int8(q_j, s_j, shape_j, pad_j)))


def test_quant_rounds_half_to_even():
    # scale 1 (block max 127): levels x exactly, halves to the even level
    x = np.zeros(256, np.float32)
    x[:6] = [127.0, 2.5, 3.5, -2.5, 0.5, -1.5]
    q_t = tcomp.quant_int8(t(x))[0].numpy()[0, :6]
    q_j = np.asarray(jcomp.quant_int8(jnp.asarray(x))[0])[0, :6]
    np.testing.assert_array_equal(q_t, [127, 2, 4, -2, 0, -2])
    np.testing.assert_array_equal(q_t, q_j)


def test_fake_quant_and_error_feedback_match():
    rng = np.random.default_rng(4)
    grads = {"w": rng.normal(0, 1, (5, 77)).astype(np.float32),
             "b": {"c": rng.normal(0, 1e-3, (300,)).astype(np.float32)}}
    np.testing.assert_equal(to_np(tcomp.fake_quant_int8(_torch(grads))),
                            to_np(jcomp.fake_quant_int8(_jax(grads))))
    bf = {"w": t(grads["w"]).to(torch.bfloat16)}
    assert tcomp.fake_quant_int8(bf)["w"].dtype == torch.bfloat16
    ef_j, ef_t = jcomp.ErrorFeedback(_jax(grads)), \
        tcomp.ErrorFeedback(_torch(grads))
    for i in range(5):
        g = jax.tree.map(lambda a: a * (1 + i), grads)
        np.testing.assert_equal(to_np(ef_t.apply(_torch(g))),
                                to_np(ef_j.apply(_jax(g))))
        np.testing.assert_equal(to_np(ef_t.residual), to_np(ef_j.residual))


# --- the reference's own cases (tests/test_train_infra.py) ------------


def test_adamw_minimises_quadratic():
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=1,
                           total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.adamw_init(params, cfg)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, m = topt.adamw_update(params, grads, state, cfg)
    assert float(torch.max(torch.abs(params["w"]))) < 0.5


def test_grad_clip_bounds_update():
    cfg = topt.AdamWConfig(lr=1.0, clip_norm=1.0, weight_decay=0.0,
                           warmup_steps=1, total_steps=10)
    params = {"w": torch.zeros(3)}
    state = topt.adamw_init(params, cfg)
    _, _, m = topt.adamw_update(params, {"w": torch.tensor([1e6, 0.0, 0.0])},
                                state, cfg)
    assert float(m["grad_norm"]) == pytest.approx(1e6)


def test_cosine_schedule_shape():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(topt.cosine_lr(cfg, s)) for s in [0, 5, 10, 55, 100]]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(0.0, abs=1e-6)


def test_int8_quant_error_bound():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(0, 1, (1000,)).astype(np.float32))
    q, s, shape, pad = tcomp.quant_int8(g)
    back = tcomp.dequant_int8(q, s, shape, pad)
    err = (back - g).abs().numpy()
    # max error <= scale/2 per block; scale ~ max|g|/127
    assert err.max() <= float(g.abs().max()) / 127 + 1e-6


def test_error_feedback_reduces_bias():
    rng = np.random.default_rng(1)
    g = {"w": torch.from_numpy(rng.normal(0, 1, (512,)).astype(np.float32))}
    ef = tcomp.ErrorFeedback(g)
    total_plain = np.zeros(512)
    total_ef = np.zeros(512)
    for _ in range(20):
        total_plain += tcomp.fake_quant_int8(g)["w"].numpy()
        total_ef += ef.apply(g)["w"].numpy()
    true = 20 * g["w"].numpy()
    assert np.abs(total_ef - true).mean() <= \
        np.abs(total_plain - true).mean() + 1e-4
