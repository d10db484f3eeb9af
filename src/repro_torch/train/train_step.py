"""Serve step builder of the LM scaffold (the port of
``repro.train.train_step.make_serve_step``; the train step is not ported
yet).

``make_serve_step(cfg)`` returns
    (params, tokens, cache, pos, key) -> (next_tokens, logits, cache)

where ``key`` is a threefry key (``core.prng``, JAX's uint32 pair), used
only when sampling.  The step is functional: the caller's cache is left
untouched.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig

__all__ = ["make_serve_step"]


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
