"""Whole train steps of the LM scaffold in the port
(``repro_torch.train.train_step.make_train_step``) held to the
reference's (``repro.train.train_step.make_train_step`` under
``jax.jit``) on the same weights and the same synthetic batches
(``synthetic_batch_fn`` of each package), one and three steps, plain and
with ``microbatches=2, compress_grads=True``, at the dense, MoE and
encoder-decoder smoke configs in float32.

Each port step is held twice: to the reference's free-running step, and
to the reference's step taken from the port's own state (so that one
step's error is seen apart from the drift of the two trajectories).

Bounds (``tests/_torch_lm_harness.py``): the loss within 1e-4 relative
in both; ``lr`` within 1e-6 of the peak rate, ``step`` exact, the metrics'
keys equal; every parameter within ``2 * lr * steps + 1e-6`` (AdamW's
ceiling when rounding noise in a zero gradient, a key bias's, gives the
two packages' updates opposite signs) free-running after 1 and 3 steps
and from the same state after each step; all but 1e-3 of the elements
within 1e-5 from the same state after each step and free-running after
the first.  (Free-running after three steps Whisper has 1.3% of its
elements beyond 1e-5: the first step's key-bias noise moves every later
gradient a little, and AdamW's normalised update turns that into a
visible step where a gradient is small.)  ``grad_norm`` from the same state within
``GNORM_REL`` = 1e-3 relative, the scale of the per-leaf gradient bound
(Whisper's second step, a loss spike, is 2.1e-4 off; 1e-4 does not
hold), and compressed within ``GNORM_REL_Q`` = 1e-2: one int8 level that
flips moves the norm by at most a quantum, 1/127 of a block's largest
gradient.  Free-running, ``grad_norm`` drifts with the parameters (up to
5.5e-3 relative after one step), and is not held.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_lm_harness import (assert_params_after_steps, assert_rel,
                               cfg_pair, flat, jax_params_jit, params_pair,
                               to_np)
from repro.launch.train import synthetic_batch_fn as j_batches
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.launch.train import synthetic_batch_fn as t_batches
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_step

STEPS = 3
GNORM_REL = 1e-3
GNORM_REL_Q = 1e-2
OPT = dict(lr=3e-4, warmup_steps=min(20, STEPS // 10 + 1),
           total_steps=STEPS)       # the CLI's schedule for 3 steps


@pytest.mark.parametrize("arch", ["qwen2_0_5b", "olmoe_1b_7b",
                                  "whisper_tiny"])
@pytest.mark.parametrize("mb,compress", [(1, False), (2, True)])
def test_train_steps_match(arch, mb, compress):
    jcfg, tcfg = cfg_pair(arch)
    jp, tp = params_pair(jcfg, tcfg, jax_params_jit)
    jo, to = jopt.AdamWConfig(**OPT), topt.AdamWConfig(**OPT)
    js, ts = jopt.adamw_init(jp, jo), topt.adamw_init(tp, to)
    jstep = jax.jit(j_make_train_step(jcfg, jo, microbatches=mb,
                                      compress_grads=compress))
    tstep = make_train_step(tcfg, to, microbatches=mb,
                            compress_grads=compress)
    jb, tb = j_batches(jcfg, 4, 32), t_batches(tcfg, 4, 32, device="cpu")
    for step in range(STEPS):
        batch_j, batch_t = jb(step), tb(step)
        for k, v in batch_j.items():
            np.testing.assert_array_equal(batch_t[k].numpy(), np.asarray(v))
        before = flat(tp)
        jp_x, _, jm_x = jstep(*_jax((tp, ts)), batch_j)   # from the port's
        jp, js, jm = jstep(jp, js, batch_j)
        tp2, ts, tm = tstep(tp, ts, batch_t)
        assert all(np.array_equal(before[k], v) for k, v in flat(tp).items())
        tp = tp2

        assert set(tm) == set(jm)
        assert set(tm) >= {"loss", "grad_norm", "lr"}
        if mb > 1:
            assert set(tm) == {"loss", "grad_norm", "lr"}
        assert_rel(tm["loss"], jm_x["loss"], f"{arch} loss at {step}")
        assert_rel(tm["loss"], jm["loss"], f"{arch} loss at {step}")
        assert_rel(tm["grad_norm"], jm_x["grad_norm"],
                   f"grad_norm at {step}", GNORM_REL_Q if compress
                   else GNORM_REL)
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= 1e-6 * OPT["lr"]
        assert ts["step"].dtype == torch.int32
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert all(v.dtype == torch.float32 for v in flat_tensors(tp))
        assert_params_after_steps(tp, jp_x, OPT["lr"], 1,
                                  f"{arch} params, step {step} alone")
        if step in (0, STEPS - 1):
            assert_params_after_steps(tp, jp, OPT["lr"], step + 1,
                                      f"{arch} params after {step + 1}",
                                      share=step == 0)


def _jax(tree):
    return jax.tree.map(jnp.asarray, to_np(tree))


def flat_tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in flat_tensors(v)]
    return [tree]


def test_microbatch_gradients_stay_float32_for_bf16_params():
    """The microbatch path sums into float32 zeros and divides by the
    count, so the optimizer sees float32 gradients even for bf16
    parameters; the single-batch path keeps the parameter's dtype."""
    _, tcfg = cfg_pair("qwen2_0_5b", "bf16")
    seen = {}
    import repro_torch.train.train_step as ts_mod
    update = ts_mod.adamw_update

    def spy(params, grads, state, cfg):
        seen["dtypes"] = {g.dtype for g in flat_tensors(grads)}
        return update(params, grads, state, cfg)

    from repro_torch.models import transformer as TT
    params, _ = TT.init_params(tcfg, torch.Generator().manual_seed(0))
    opt = topt.AdamWConfig(**OPT)
    batch = t_batches(tcfg, 4, 32, device="cpu")(0)
    ts_mod.adamw_update = spy
    try:
        for mb, compress, want in ((2, False, {torch.float32}),
                                   (2, True, {torch.float32}),
                                   (1, False, {torch.bfloat16}),
                                   (1, True, {torch.bfloat16})):
            step = make_train_step(tcfg, opt, microbatches=mb,
                                   compress_grads=compress)
            p, _, m = step(params, topt.adamw_init(params, opt), batch)
            assert seen["dtypes"] == want, (mb, compress)
            assert all(v.dtype == torch.bfloat16 for v in flat_tensors(p))
            assert np.isfinite(float(m["loss"]))
    finally:
        ts_mod.adamw_update = update
