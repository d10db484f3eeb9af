"""AdamW with global-norm clipping and a cosine schedule (the port of
``repro.train.optimizer``).

The arithmetic and its order are the reference's: the global norm is
summed over the leaves in the reference's flatten order (sorted keys), the
bias corrections ``b1 ** step`` and ``b2 ** step`` are taken in float32,
and each leaf is updated in float32, then cast back to the parameter's
dtype and to ``state_dtype``.  ``step`` stays an int32 tensor on the
parameters' device and the update never reads a value back to the host,
so a train step does not wait on the device.  The update is functional:
it returns new trees and leaves its inputs untouched.

Parity with the reference on the same gradients (CPU, float32): params,
``m`` and ``v`` within ``1e-6 * max(1, max|ref|)`` (XLA and torch round
``pow``, ``sqrt`` and fused multiply-adds differently by an ulp); ``step``
and ``lr`` exactly equal; ``grad_norm`` within 1e-6 relative (the
reductions sum in another order).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.common import _leaves, _set, tree_map

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    state_dtype: Any = torch.float32


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 tensor on ``step``'s device."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((s - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    return cfg.lr * warm * (0.5 * (1 + torch.cos(math.pi * t)))


def adamw_init(params, cfg: AdamWConfig) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    dev = next(_leaves(params))[1].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(tree) -> torch.Tensor:
    total = 0
    for _, leaf in _leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = cosine_lr(cfg, step)

    sf = step.to(torch.float32)

    def const(x):      # filled on the device: no host-to-device copy
        return torch.full((), x, dtype=torch.float32, device=sf.device)

    b1c = 1.0 - torch.pow(const(cfg.b1), sf)
    b2c = 1.0 - torch.pow(const(cfg.b2), sf)

    def upd(p, g, m, v):
        gf = g.float() * scale
        m2 = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        mh = m2 / b1c
        vh = v2 / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p.float()
        p2 = p.float() - lr * delta
        return (p2.to(p.dtype), m2.to(cfg.state_dtype),
                v2.to(cfg.state_dtype))

    new_p: dict = {}
    new_m: dict = {}
    new_v: dict = {}
    for (path, p), (_, g), (_, m), (_, v) in zip(
            _leaves(params), _leaves(grads), _leaves(state["m"]),
            _leaves(state["v"])):
        p2, m2, v2 = upd(p, g, m, v)
        _set(new_p, path, p2)
        _set(new_m, path, m2)
        _set(new_v, path, v2)
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_p, {"m": new_m, "v": new_v, "step": step}, metrics
