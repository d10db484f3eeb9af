"""Shared helpers for the LM scaffold's parity tests: the same numpy inputs
and the same weights (JAX's ``init_params(PRNGKey(0))``, carried over by
``repro_torch.models.common.params_from_numpy``) go through ``repro`` and
``repro_torch`` on the CPU.

Bounds: float32 configs within ``F32 * max(1, max|ref|)`` (max |delta|
over a whole tree); bf16 configs within the reference's own bf16 bound,
``BF16`` (``tests/test_serving_parity.py``: atol = rtol = 5e-2); integer
routing and greedy tokens exact.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.models.common import params_from_numpy

F32 = 1e-4
BF16 = 5e-2


def cfg_pair(arch, dtype="f32", **kw):
    """(reference config, port config) of ``arch``'s smoke config."""
    jd, td = {"f32": (jnp.float32, torch.float32),
              "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jc = dataclasses.replace(jconfigs.get_smoke(arch), param_dtype=jd,
                             act_dtype=jd, **kw)
    tc = dataclasses.replace(tconfigs.get_smoke(arch), param_dtype=td,
                             act_dtype=td, **kw)
    return jc, tc


def to_np(tree):
    """A JAX or port tree as float32 (integer leaves kept) numpy."""
    if isinstance(tree, dict):
        return {k: to_np(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_np(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        if tree.dtype.is_floating_point:
            return tree.detach().float().cpu().numpy()
        return tree.detach().cpu().numpy()
    a = np.asarray(tree)
    if np.issubdtype(a.dtype, np.integer) or a.dtype == bool:
        return a
    return np.asarray(jnp.asarray(tree, jnp.float32))


def max_err(got, want) -> float:
    """max |got - want| over two trees of the same keys."""
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        return max(max_err(got[k], want[k]) for k in want)
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    return float(np.abs(g.astype(np.float64) - w.astype(np.float64)).max())


def max_abs(tree) -> float:
    if isinstance(tree, dict):
        return max(max_abs(v) for v in tree.values())
    return float(np.abs(to_np(tree)).max())


def assert_close(got, want, bound=F32, what=""):
    """max |got - want| <= bound * max(1, max|want|) over the tree."""
    err, scale = max_err(got, want), max(1.0, max_abs(want))
    assert err <= bound * scale, f"{what}: max|delta| {err} > {bound} * {scale}"
    return err


@functools.lru_cache(maxsize=None)
def jax_params(jcfg):
    """The reference's ``init_params(cfg, PRNGKey(0))`` (cached per config)."""
    return JT.init_params(jcfg, jax.random.PRNGKey(0))[0]


def params_pair(jcfg, tcfg, init=jax_params):
    jp = init(jcfg)
    return jp, params_from_numpy(to_np(jp), tcfg, "cpu")


@functools.lru_cache(maxsize=None)
def jax_params_jit(jcfg):
    """``jax_params`` drawn under ``jax.jit``: 2-3x faster, and within
    2.4e-7 of the eager draw (not bit-equal), so a test that carries them
    across holds both packages to the same weights all the same."""
    return jax.jit(lambda k: JT.init_params(jcfg, k)[0])(
        jax.random.PRNGKey(0))


def t(a, dtype=None):
    """A numpy array as a CPU tensor."""
    out = torch.from_numpy(np.array(a))
    return out if dtype is None else out.to(dtype)


def batch_pair(jcfg, tcfg, b=2, s=32, seed=0, labels=True):
    """The same token batch (and stub embeddings) for both packages."""
    rng = np.random.default_rng(seed)
    if jcfg.family == "encdec":
        s = min(s, jcfg.max_target_len)
    nb = {"tokens": rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)}
    if labels:
        nb["labels"] = rng.integers(0, jcfg.vocab, (b, s)).astype(np.int32)
        nb["mask"] = (rng.random((b, s)) < 0.9).astype(np.float32)
    if jcfg.family == "vlm":
        nb["img_embeds"] = rng.normal(
            0, 1, (b, jcfg.n_img_tokens, jcfg.d_model)).astype(np.float32)
    if jcfg.family == "encdec":
        nb["frames"] = rng.normal(
            0, 1, (b, jcfg.n_audio_frames, jcfg.d_model)).astype(np.float32)
    jb = {k: jnp.asarray(v, jcfg.act_dtype if v.dtype == np.float32
                         and k != "mask" else None)
          for k, v in nb.items()}
    tb = {k: t(v) for k, v in nb.items()}
    return jb, tb


# --- training (gradients, AdamW steps) ---------------------------------
#
# Gradients, per leaf: max|g - g_ref| <= GRAD_LEAF * max|g_ref(leaf)| +
# GRAD_TREE * max|g_ref(tree)|; the floor covers leaves whose true
# gradient is zero (a key bias: softmax ignores a shift shared by a row's
# scores), where both packages return rounding noise.  Parameters after
# ``steps`` AdamW steps: every element within 2 * lr * steps + 1e-6 (the
# update's ceiling when that noise gives the two packages opposite
# signs), all but a share ``STEP_SHARE`` of the elements within
# ``STEP_CLOSE``.  Loss and grad norm within ``STEP_REL`` relative.

GRAD_LEAF = 1e-3
GRAD_TREE = 1e-6
STEP_CLOSE = 1e-5
STEP_SHARE = 1e-3
STEP_REL = 1e-4


def flat(tree, path=()):
    """{"a/b": float64 numpy} over a (JAX or port) tree of dicts."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], (*path, k)))
        return out
    return {"/".join(path): to_np(tree).astype(np.float64)}


def assert_grads_close(got, want, what=""):
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w), (sorted(g), sorted(w))
    top = max(float(np.abs(a).max()) for a in w.values())
    worst = 0.0
    for k in w:
        assert g[k].shape == w[k].shape, (k, g[k].shape, w[k].shape)
        err = float(np.abs(g[k] - w[k]).max())
        bound = GRAD_LEAF * float(np.abs(w[k]).max()) + GRAD_TREE * top
        assert err <= bound, f"{what} grad {k}: {err} > {bound}"
        worst = max(worst, err / bound)
    return worst


def assert_params_after_steps(got, want, lr, steps, what="", share=True):
    """The ceiling on every element; with ``share``, also the share of
    elements beyond ``STEP_CLOSE``."""
    g, w = flat(got), flat(want)
    assert sorted(g) == sorted(w)
    far = total = 0
    for k in w:
        d = np.abs(g[k] - w[k])
        assert d.max() <= 2 * lr * steps + 1e-6, (what, k, d.max())
        far += int((d > STEP_CLOSE).sum())
        total += d.size
    assert not share or far <= STEP_SHARE * total, \
        f"{what}: {far} of {total} > 1e-5"
    return far, total


def assert_rel(got, want, what="", rel=STEP_REL):
    got, want = float(got), float(want)
    assert abs(got - want) <= rel * abs(want), f"{what}: {got} vs {want}"
