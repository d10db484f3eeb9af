"""Train and serve step builders of the LM scaffold (the port of
``repro.train.train_step``).

``make_train_step(cfg, opt_cfg)`` returns
    (params, opt_state, batch) -> (params, opt_state, metrics)
with optional microbatch gradient accumulation and int8 gradient
compression (``repro_torch.train.compression``).  The step is functional:
the caller's trees are left untouched, so a retried step starts again from
the same state.

``make_serve_step(cfg)`` returns
    (params, tokens, cache, pos, key) -> (next_tokens, logits, cache)

where ``key`` is a threefry key (``core.prng``, JAX's uint32 pair), used
only when sampling.  The serve step is functional too.

Gradients come from ``torch.autograd.grad`` over detached copies of the
parameter leaves (``make_grad_fn``, the counterpart of
``jax.value_and_grad(loss_fn, has_aux=True)``); a leaf the loss does not
reach gets zeros, as in JAX.  Parity with the reference on the same
weights and batches (CPU, float32 smoke configs): per leaf,
``max|dg| <= 1e-3 * max|g_ref(leaf)| + 1e-6 * max|g_ref(tree)|``.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, _leaves, _set, tree_map
from repro_torch.train import compression
from repro_torch.train.optimizer import AdamWConfig, adamw_update

__all__ = ["make_train_step", "make_serve_step", "make_loss_fn",
           "make_grad_fn"]


def make_loss_fn(cfg: ModelConfig):
    def loss_fn(params, batch):
        loss, metrics = T.forward_train(params, batch, cfg)
        return loss, metrics

    return loss_fn


def _detached(x, like: torch.Tensor) -> torch.Tensor:
    """A metric as a detached float32 tensor on ``like``'s device (a
    family without MoE reports its aux loss as the float 0.0)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.full((), x, dtype=torch.float32, device=like.device)


def make_grad_fn(cfg: ModelConfig):
    """(params, batch) -> ((loss, metrics), grads): the loss and metrics
    detached, the gradients a tree like ``params`` in each leaf's dtype."""
    loss_fn = make_loss_fn(cfg)

    def grad_fn(params, batch):
        paths, leaves = [], []
        for path, p in _leaves(params):
            paths.append(path)
            leaves.append(p.detach().requires_grad_())
        tree: dict = {}
        for path, leaf in zip(paths, leaves):
            _set(tree, path, leaf)
        loss, metrics = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        out: dict = {}
        for path, g in zip(paths, grads):
            _set(out, path, g)
        loss = loss.detach()
        return (loss, {k: _detached(v, loss) for k, v in metrics.items()}), \
            out

    return grad_fn


def make_train_step(
    cfg: ModelConfig,
    opt_cfg: AdamWConfig,
    *,
    microbatches: int = 1,
    compress_grads: bool = False,
):
    grad_fn = make_grad_fn(cfg)

    def train_step(params, opt_state, batch):
        if microbatches > 1:
            # the reference's scan: rows split contiguously, gradients
            # summed in float32, the float32 mean loss, no forward metrics
            def split(x):
                b = x.shape[0]
                return x.reshape(microbatches, b // microbatches,
                                 *x.shape[1:])

            mb = {k: split(v) for k, v in batch.items()}
            gsum = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = 0.0
            for i in range(microbatches):
                (loss, _), grads = grad_fn(
                    params, {k: v[i] for k, v in mb.items()})
                gsum = tree_map(torch.add, gsum, grads)
                lsum = lsum + loss
            grads = tree_map(lambda g: g / microbatches, gsum)
            loss = lsum / microbatches
            metrics = {}
        else:
            (loss, metrics), grads = grad_fn(params, batch)

        if compress_grads:
            grads = compression.fake_quant_int8(grads)

        params, opt_state, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig, *, greedy: bool = True,
                    temperature: float = 1.0):
    def serve_step(params, tokens, cache, pos, key):
        logits, cache = T.forward_decode(params, tokens, cache, pos, cfg)
        lf = logits[:, -1, :].float()
        if greedy:
            nxt = torch.argmax(lf, dim=-1)
        else:
            nxt = prng.categorical(key.to(lf.device), lf / temperature)
        return nxt.to(torch.int32)[:, None], logits, cache

    return serve_step
