"""Gradients of the LM scaffold's training loss in the port
(``repro_torch.train.train_step.make_grad_fn``: autograd through
``forward_train``) held to ``jax.value_and_grad`` of the reference's on
the same weights and batches, at every family's smoke config in float32;
then the rematerialisation settings (``cfg.remat``) and the ``"dots"``
policy's saved products.

Bounds (``tests/_torch_lm_harness.py``): per leaf ``max|dg| <= 1e-3 *
max|g_ref(leaf)| + 1e-6 * max|g_ref(tree)|``; loss and metrics within
``1e-4`` relative; int8-compressed gradients in whole quanta: block
scales within the gradient bound over 127, levels within one plus twice
the gradient bound in the block's quanta (a gradient that differs by
1e-6 may round to the neighbouring level); ``none`` / ``dots`` / ``full``
gradients bit-equal on the CPU.
"""
import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_lm_harness import (assert_grads_close, assert_rel, batch_pair,
                               cfg_pair, flat, jax_params_jit, params_pair)
from repro.train import compression as jcomp
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro_torch import configs as tconfigs
from repro_torch.models import transformer as TT
from repro_torch.train import compression as tcomp
from repro_torch.train.train_step import make_grad_fn

# one smoke config per family, and DeepSeek-V3 (MLA + MTP)
GRAD_ARCHS = ("qwen2_0_5b", "olmoe_1b_7b", "deepseek_v3_671b",
              "phi_3_vision_4_2b", "whisper_tiny", "mamba2_370m",
              "zamba2_1_2b")


def test_grad_archs_cover_every_family():
    assert {tconfigs.get_smoke(a).family for a in GRAD_ARCHS} == \
        {tconfigs.get_smoke(a).family for a in tconfigs.ARCHS}


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_gradients_match(arch):
    jcfg, tcfg = cfg_pair(arch)
    jp, tp = params_pair(jcfg, tcfg, jax_params_jit)
    jb, tb = batch_pair(jcfg, tcfg, b=2, s=32)
    f = jax.jit(jax.value_and_grad(j_make_loss_fn(jcfg), has_aux=True))
    (loss_j, m_j), g_j = f(jp, jb)
    (loss_t, m_t), g_t = make_grad_fn(tcfg)(tp, tb)

    assert_rel(loss_t, loss_j, f"{arch} loss")
    assert set(m_t) == set(m_j)
    for k in m_j:
        assert abs(float(m_t[k]) - float(m_j[k])) <= \
            1e-4 * max(1.0, abs(float(m_j[k]))), k
    for (_, leaf), (_, g) in zip(sorted(flat(tp).items()),
                                 sorted(flat(g_t).items())):
        assert leaf.shape == g.shape
    assert all(v.dtype == tcfg.param_dtype and not v.requires_grad
               for v in _tensors(g_t))
    assert_grads_close(g_t, g_j, arch)

    # int8-compressed, in whole quanta: each block's levels within one
    # of the reference's plus the gradient bound in that block's quanta
    # (a gradient that differs by 1e-6 may round to the next level; in a
    # block of rounding noise, as a key bias's, the bound spans many)
    top = max(float(np.abs(a).max()) for a in flat(g_j).values())
    quant_j = jax.jit(lambda g: jax.tree.map(
        lambda x: jcomp.quant_int8(x)[:2], g))(g_j)
    for (k, gj), (_, gt) in zip(sorted(_leaf_items(g_j)),
                                sorted(_leaf_items(g_t))):
        q_j, s_j = (np.asarray(a) for a in _at(quant_j, k))
        q_t, s_t, _, _ = tcomp.quant_int8(gt)
        bound = 1e-3 * float(np.abs(np.asarray(gj)).max()) + 1e-6 * top
        assert float(np.abs(s_t.numpy() - s_j).max()) <= bound / 127, k
        levels = np.abs(q_t.numpy().astype(np.int32) - q_j.astype(np.int32))
        assert np.all(levels <= np.floor(1 + 2 * bound / s_j)), k


def _at(tree, path):
    for key in path.split("/"):
        tree = tree[key]
    return tree


def _leaf_items(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in tree for x in _leaf_items(tree[k], (*path, k))]
    return [("/".join(path), tree)]


def _tensors(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    return [tree]


def _port_batch(tcfg, seed=1, b=2, s=32):
    g = torch.Generator().manual_seed(seed)
    if tcfg.family == "encdec":
        s = min(s, tcfg.max_target_len)
    batch = {
        "tokens": torch.randint(0, tcfg.vocab, (b, s), generator=g,
                                dtype=torch.int32),
        "labels": torch.randint(0, tcfg.vocab, (b, s), generator=g,
                                dtype=torch.int32),
        "mask": (torch.rand((b, s), generator=g) < 0.9).float()}
    if tcfg.family == "encdec":
        batch["frames"] = torch.randn((b, tcfg.n_audio_frames,
                                       tcfg.d_model), generator=g)
    if tcfg.family == "vlm":
        batch["img_embeds"] = torch.randn((b, tcfg.n_img_tokens,
                                           tcfg.d_model), generator=g)
    return batch


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_remat_settings_give_equal_gradients(arch):
    base = dataclasses.replace(tconfigs.get_smoke(arch),
                               param_dtype=torch.float32,
                               act_dtype=torch.float32)
    params, _ = TT.init_params(base, torch.Generator().manual_seed(0))
    batch = _port_batch(base)
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        (loss, _), grads = make_grad_fn(cfg)(params, batch)
        out[remat] = (loss, _tensors(grads))
    for remat in ("dots", "full"):
        assert torch.equal(out[remat][0], out["none"][0])
        assert all(torch.equal(a, b) for a, b in
                   zip(out[remat][1], out["none"][1])), remat


_MATMULS = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
            torch.ops.aten.matmul.default, torch.ops.aten.dot.default,
            torch.ops.aten.mv.default}


class _MatmulLog(TorchDispatchMode):
    """The matrix-product aten ops a forward dispatches to, with the batch
    extent of each ``bmm``."""

    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _MATMULS:
            batch = args[0].shape[0] if func is torch.ops.aten.bmm.default \
                else None
            self.ops[(str(func), batch)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch,saved,recomputed", [
    # per layer: q, k, v, o and the SwiGLU's gate, up, down projections
    # saved; the attention scores and values recomputed
    ("qwen2_0_5b", 7, 2),
    # q, k, v, o and the router saved; the experts' gate, up and down
    # (batched over experts) and the two attention products recomputed
    ("olmoe_1b_7b", 5, 5),
])
def test_dots_policy_saves_unbatched_products(monkeypatch, arch, saved,
                                              recomputed):
    cfg = dataclasses.replace(tconfigs.get_smoke(arch), n_layers=1,
                              param_dtype=torch.float32,
                              act_dtype=torch.float32, remat="dots")
    params, _ = TT.init_params(cfg, torch.Generator().manual_seed(0))
    batch = _port_batch(cfg)

    # every product the block's einsums reach is an aten mm/bmm, the
    # projections with a batch extent of 1
    with _MatmulLog() as log:
        TT.forward_train(params, batch, cfg)
    assert {op for op, _ in log.ops} <= {"aten.bmm.default",
                                         "aten.mm.default"}, log.ops

    decisions = []
    policy = TT._save_dots

    def spy(ctx, op, *args, **kwargs):
        out = policy(ctx, op, *args, **kwargs)
        if not ctx.is_recompute and op in _MATMULS:
            decisions.append((str(op), tuple(args[0].shape), out.name))
        return out

    monkeypatch.setattr(TT, "_save_dots", spy)
    (_, _), _ = make_grad_fn(cfg)(params, batch)
    kinds = collections.Counter(d for _, _, d in decisions)
    assert kinds == {"MUST_SAVE": saved, "PREFER_RECOMPUTE": recomputed}, \
        decisions
    assert all(shape[0] == 1 for _, shape, d in decisions
               if d == "MUST_SAVE")
    assert all(shape[0] > 1 for _, shape, d in decisions
               if d == "PREFER_RECOMPUTE")


def test_only_differentiated_calls_go_through_remat(monkeypatch):
    cfg = dataclasses.replace(tconfigs.get_smoke("qwen2_0_5b"),
                              param_dtype=torch.float32,
                              act_dtype=torch.float32, remat="full")
    params, _ = TT.init_params(cfg, torch.Generator().manual_seed(0))
    calls = []
    checkpoint = TT.ckpt.checkpoint
    monkeypatch.setattr(TT.ckpt, "checkpoint",
                        lambda *a, **k: calls.append(1) or checkpoint(*a, **k))
    cache = TT.zeros_cache(cfg, 2, 8, "cpu")
    TT.forward_decode(params, torch.ones((2, 1), dtype=torch.int32), cache,
                      0, cfg)
    assert calls == []
    with torch.no_grad():
        TT.forward_train(params, _port_batch(cfg), cfg)
    TT.forward_prefill(params, _port_batch(cfg), cfg)   # nothing needs grad
    assert calls == []
    make_grad_fn(cfg)(params, _port_batch(cfg))
    assert len(calls) == cfg.n_layers
