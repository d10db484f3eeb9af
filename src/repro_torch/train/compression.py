"""Gradient compression for the cross-pod all-reduce (the port of
``repro.train.compression``): blockwise symmetric int8 quantisation, 256
values a block along the flattened leaf.

  * ``fake_quant_int8`` quantises and dequantises each gradient leaf (int8
    on the wire), returning it in the leaf's dtype; ``make_train_step``
    applies it before the optimizer.
  * ``ErrorFeedback`` carries the quantisation residual into the next step
    (EF-SGD), so repeated quantisation error does not bias convergence.

``torch.round`` rounds half to even, as ``jnp.round`` does, so the same
float32 input gives the reference's ``q`` and ``scale`` exactly.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import _leaves, _set, tree_map

__all__ = ["fake_quant_int8", "quant_int8", "dequant_int8", "ErrorFeedback"]

_BLOCK = 256


def quant_int8(x: torch.Tensor):
    """Returns (q int8 (n_blocks, 256), scale float32 (n_blocks, 1), the
    leaf's shape, the padding)."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, _BLOCK).float()
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, tuple(x.shape), pad


def dequant_int8(q, scale, shape, pad):
    out = (q.float() * scale).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(shape)


def fake_quant_int8(grads):
    """Quantise and dequantise each gradient leaf (int8 on the wire)."""
    def one(g):
        q, s, shape, pad = quant_int8(g)
        return dequant_int8(q, s, shape, pad).to(g.dtype)

    return tree_map(one, grads)


class ErrorFeedback:
    """EF-SGD: carry the quantisation residual into the next step."""

    def __init__(self, params_like):
        self.residual = tree_map(
            lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device), params_like)

    def apply(self, grads):
        out: dict = {}
        residual: dict = {}
        for (path, g), (_, r) in zip(_leaves(grads), _leaves(self.residual)):
            gf = g.float() + r
            q, s, shape, pad = quant_int8(gf)
            deq = dequant_int8(q, s, shape, pad)
            _set(out, path, deq.to(g.dtype))
            _set(residual, path, gf - deq)
        self.residual = residual
        return out
