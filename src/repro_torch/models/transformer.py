"""Model assembly of the LM scaffold (the port of
``repro.models.transformer``): decoder-only LM (dense / MoE / SSM / hybrid
/ VLM) and encoder-decoder (Whisper).

Public surface:
    init_spec(cfg)            -> tree of ParamSpec (stacked layers)
    init_params(cfg, gen)     -> (params, logical_axes)
    forward_train(params, batch, cfg) -> (loss, metrics)
    forward_prefill(params, batch, cfg) -> last-position logits
    forward_prefill_cache(params, batch, cfg, cache_len)
                              -> (last logits, cache, next pos)
    init_cache(cfg, batch, length)    -> decode cache as meta tensors
    zeros_cache(cfg, batch, length, device) -> the same, materialised
    forward_decode(params, tokens, cache, pos, cfg) -> (logits, new cache)

Per-layer parameters are stacked on axis 0 ('layers'), as in the
reference; its ``lax.scan`` over that axis is a Python loop here, its
``lax.cond`` an ``if``.  The reference's ``shard_act`` sites are kept
(``repro_torch.meshctx``): the identity without a mesh or on plain
tensors.  ``forward_decode`` is functional: the caller's cache is left
untouched.

Training differentiates ``forward_train`` with autograd.  The per-layer
bodies it runs (the decoder stack's, Whisper's encoder and decoder) go
through ``_remat``, the reference's ``jax.checkpoint`` policy set by
``cfg.remat``; decode does not.  A recomputed body runs under the mesh and
rules that were active when it first ran.
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.core.state import resolve_device
from repro_torch.meshctx import (current_mesh, current_rules, shard_act,
                                 use_mesh_rules)
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ModelConfig, ParamSpec, _leaves,
                                       init_dense, make_rope, rms_norm,
                                       sinusoidal_positions, tree_map)

__all__ = [
    "init_spec", "init_params", "forward_train", "forward_prefill",
    "forward_prefill_cache", "forward_decode", "init_cache", "stack_n",
    "zeros_cache",
]


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _block_spec(cfg: ModelConfig) -> dict:
    """Spec of ONE decoder block (unstacked)."""
    d = cfg.d_model
    if cfg.family in ("ssm", "hybrid"):
        return {
            "norm1": ParamSpec((d,), ("embed",), init="ones"),
            "ssm": ssm_mod.ssm_spec(cfg),
        }
    block = {
        "norm1": ParamSpec((d,), ("embed",), init="ones"),
        "attn": attn.mla_spec(cfg) if cfg.mla else attn.gqa_spec(cfg),
        "norm2": ParamSpec((d,), ("embed",), init="ones"),
    }
    if cfg.family == "moe":
        block["moe"] = mlp_mod.moe_spec(cfg)
    else:
        block["mlp"] = mlp_mod.mlp_spec(cfg)
    return block


def _shared_attn_spec(cfg: ModelConfig) -> dict:
    """Zamba2's shared transformer block (concat(h, x0) input)."""
    d = cfg.d_model
    return {
        "in_proj": ParamSpec((2 * d, d), ("embed2", "embed")),
        "norm1": ParamSpec((d,), ("embed",), init="ones"),
        "attn": attn.gqa_spec(cfg),
        "norm2": ParamSpec((d,), ("embed",), init="ones"),
        "mlp": mlp_mod.mlp_spec(cfg),
    }


def _enc_block_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "norm1": ParamSpec((d,), ("embed",), init="ones"),
        "attn": attn.gqa_spec(cfg),
        "norm2": ParamSpec((d,), ("embed",), init="ones"),
        "mlp": mlp_mod.mlp_spec(cfg),
    }


def _dec_block_spec_encdec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "norm1": ParamSpec((d,), ("embed",), init="ones"),
        "attn": attn.gqa_spec(cfg),
        "normx": ParamSpec((d,), ("embed",), init="ones"),
        "xattn": attn.gqa_spec(cfg),
        "norm2": ParamSpec((d,), ("embed",), init="ones"),
        "mlp": mlp_mod.mlp_spec(cfg),
    }


def _stack(spec: dict, n: int) -> dict:
    """Prepend a stacked 'layers' axis to every leaf of a block spec."""
    return tree_map(lambda s: ParamSpec((n, *s.shape), ("layers", *s.axes),
                                        init=s.init, scale=s.scale), spec)


def init_spec(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab
    spec: dict[str, Any] = {
        "embed": ParamSpec((v, d), ("vocab", "embed"), scale=1.0),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec((d, v), ("embed", "vocab"))

    if cfg.family == "encdec":
        spec["enc"] = _stack(_enc_block_spec(cfg), cfg.n_enc_layers)
        spec["enc_norm"] = ParamSpec((d,), ("embed",), init="ones")
        spec["dec"] = _stack(_dec_block_spec_encdec(cfg), cfg.n_layers)
        return spec

    spec["blocks"] = _stack(_block_spec(cfg), cfg.n_layers)
    if cfg.family == "hybrid" and cfg.shared_attn_every:
        spec["shared_attn"] = _shared_attn_spec(cfg)
    if cfg.mtp:
        spec["mtp_proj"] = ParamSpec((2 * d, d), ("embed2", "embed"))
        spec["mtp_block"] = _block_spec(cfg)
        spec["mtp_norm"] = ParamSpec((d,), ("embed",), init="ones")
    return spec


def init_params(cfg: ModelConfig, gen: torch.Generator):
    """Random parameters drawn from ``gen``, on its device."""
    return init_dense(gen, init_spec(cfg), cfg.param_dtype)


def _layers(tree: dict) -> list[dict]:
    """The per-layer slices of a tree stacked on axis 0.  One ``unbind``
    per leaf: its backward stacks the layers' gradients once, where
    indexing each layer would materialise a zero-padded copy of the whole
    stacked leaf per layer."""
    first = tree
    while isinstance(first, dict):
        first = next(iter(first.values()))
    split = tree_map(lambda a: a.unbind(0), tree)
    return [tree_map(lambda s: s[i], split) for i in range(first.shape[0])]


def _stack_trees(trees: list[dict]) -> dict:
    return tree_map(lambda *xs: torch.stack(xs, 0), *trees)


# ---------------------------------------------------------------------------
# Rematerialisation (the reference's ``_remat``)
# ---------------------------------------------------------------------------

_ATEN = torch.ops.aten


def _save_dots(ctx, op, *args, **kwargs):
    """JAX's ``checkpoint_dots_with_no_batch_dims``: save the output of a
    matrix product that has no batch dimension, recompute the rest.
    ``torch.einsum`` reaches ``aten.bmm`` with a batch extent of 1 for the
    projections and with the batch (and head) extents for the attention
    scores and values and the experts, so a ``bmm`` whose batch extent is
    1 counts as unbatched.  (An attention product at batch 1 with one KV
    head would be saved too: more memory, the same values.)"""
    if op in (_ATEN.mm.default, _ATEN.addmm.default) or (
            op is _ATEN.bmm.default and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``: ``"none"`` saves every activation for the
    backward, ``"full"`` saves only ``fn``'s inputs and recomputes its body
    in the backward, and any other value (``"dots"``) saves only the
    unbatched matrix products (``_save_dots``).  Recomputation gives the
    same values, so the gradients do not depend on the setting.  The
    recomputation may run on another thread (the backward's device
    thread), so it re-enters the mesh and rules of the first run."""
    if cfg.remat == "none":
        return fn
    kw = {} if cfg.remat == "full" else {"context_fn": functools.partial(
        ckpt.create_selective_checkpoint_contexts, _save_dots)}

    def wrapped(*args):
        if not (torch.is_grad_enabled() and any(
                isinstance(t, torch.Tensor) and t.requires_grad
                for a in args for _, t in _leaves(a))):
            return fn(*args)       # inference: nothing to save or recompute
        mesh, rules = current_mesh(), current_rules()

        def under_mesh(*a):
            with (use_mesh_rules(mesh, rules) if mesh is not None
                  else contextlib.nullcontext()):
                return fn(*a)

        return ckpt.checkpoint(under_mesh, *args, use_reentrant=False, **kw)

    return wrapped


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _dense_block(p, x, cos, sin, cfg: ModelConfig):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    h = attn.mla_train(p["attn"], h, cos, sin, cfg) if cfg.mla else \
        attn.gqa_train(p["attn"], h, cos, sin, cfg)
    x = x + h
    h = rms_norm(x, p["norm2"], cfg.norm_eps)
    if "moe" in p:
        moe_fn = mlp_mod.moe_apply_a2a if cfg.moe_a2a else mlp_mod.moe_apply
        h, aux = moe_fn(
            p["moe"], h, cfg, score_fn="sigmoid" if cfg.mla else "softmax")
    else:
        h, aux = mlp_mod.mlp_apply(p["mlp"], h), 0.0
    return x + h, aux


def _ssm_block(p, x, cfg: ModelConfig):
    h = rms_norm(x, p["norm1"], cfg.norm_eps)
    return x + ssm_mod.ssm_train(p["ssm"], h, cfg), 0.0


def _shared_block_apply(sp, x, x0, cos, sin, cfg: ModelConfig):
    h = torch.einsum("bse,ed->bsd", torch.cat([x, x0], -1), sp["in_proj"])
    a = rms_norm(h, sp["norm1"], cfg.norm_eps)
    h = h + attn.gqa_train(sp["attn"], a, cos, sin, cfg)
    m = rms_norm(h, sp["norm2"], cfg.norm_eps)
    return x + h + mlp_mod.mlp_apply(sp["mlp"], m)


def _decoder_stack(params, x, cos, sin, cfg: ModelConfig):
    """The stacked blocks in turn; returns (h, aux_loss_sum)."""
    x0 = x
    shared = params.get("shared_attn")

    def body(lp, h, idx):
        if cfg.family == "ssm":
            h, a = _ssm_block(lp, h, cfg)
        elif cfg.family == "hybrid":
            h, a = _ssm_block(lp, h, cfg)
            period = cfg.shared_attn_every
            if period and idx % period == period - 1:
                h = _shared_block_apply(shared, h, x0, cos, sin, cfg)
        else:
            h, a = _dense_block(lp, h, cos, sin, cfg)
        return shard_act(h, "batch", "seq", "act_embed"), a

    body = _remat(body, cfg)
    h, aux = x, 0.0
    for idx, lp in enumerate(_layers(params["blocks"])):
        h, a = body(lp, h, idx)
        aux = aux + a
    return h, aux


# ---------------------------------------------------------------------------
# Train forward + chunked CE loss
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg: ModelConfig):
    return params["embed"][tokens.long()].to(cfg.act_dtype)


def _lm_head(params, h, cfg: ModelConfig):
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", h, w)


def _chunked_ce(params, h, labels, mask, cfg: ModelConfig):
    """CE over sequence chunks: never materialises (B, S, V) at once."""
    b, s, d = h.shape
    c = min(cfg.loss_chunk, s)
    assert s % c == 0, f"seq {s} %% loss_chunk {c} != 0"
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(s // c):
        sl = slice(i * c, (i + 1) * c)
        logits = _lm_head(params, h[:, sl], cfg).float()
        logits = shard_act(logits, "batch", "seq", "vocab")
        lse = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, labels[:, sl, None].long())[..., 0]
        mm = mask[:, sl].float()
        tot = tot + torch.sum((lse - gold) * mm)
        cnt = cnt + torch.sum(mm)
    return tot / torch.clamp(cnt, min=1.0)


def _rope_tables(x, cfg: ModelConfig):
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    rope_dim = (cfg.qk_rope_dim if cfg.mla else cfg.head_dim) or 2
    return make_rope(positions, rope_dim, cfg.rope_theta)


def _decoder_input(params, batch, cfg: ModelConfig):
    tokens = batch["tokens"]
    s = tokens.shape[1]
    x = _embed(params, tokens, cfg)
    if cfg.family == "vlm":
        img = batch["img_embeds"].to(cfg.act_dtype)
        x = torch.cat([img, x[:, : s - cfg.n_img_tokens]], 1)
    return shard_act(x, "batch", "seq", "act_embed")


def forward_train(params, batch, cfg: ModelConfig):
    """The training loss and its metrics.  batch: tokens (B,S) int, labels
    (B,S) int, mask (B,S) f32; vlm adds 'img_embeds' (B, n_img, D); encdec
    adds 'frames' (B, T, D)."""
    if cfg.family == "encdec":
        return _encdec_train(params, batch, cfg)
    s = batch["tokens"].shape[1]
    x = _decoder_input(params, batch, cfg)
    cos, sin = _rope_tables(x, cfg)

    h, aux = _decoder_stack(params, x, cos, sin, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)

    loss = _chunked_ce(params, h, batch["labels"], batch["mask"], cfg)
    metrics = {"ce": loss, "aux": aux}

    if cfg.mtp:
        # DeepSeek-V3 MTP: one extra block predicts token t+2 from
        # [h_t ; embed(token_{t+1})] — shared head, weighted loss.
        emb_next = _embed(params, batch["labels"], cfg)
        hm = torch.einsum(
            "bse,ed->bsd",
            torch.cat([rms_norm(h, params["mtp_norm"], cfg.norm_eps),
                       emb_next], -1),
            params["mtp_proj"])
        hm, _ = _dense_block(params["mtp_block"], hm, cos, sin, cfg)
        mtp_labels = torch.roll(batch["labels"], -1, 1)
        mtp_mask = batch["mask"] * (
            torch.arange(s, device=hm.device)[None, :] < s - 1
        ).to(batch["mask"].dtype)
        mtp_loss = _chunked_ce(params, hm, mtp_labels, mtp_mask, cfg)
        metrics["mtp"] = mtp_loss
        loss = loss + 0.3 * mtp_loss

    return loss + aux, metrics


def forward_prefill_cache(params, batch, cfg: ModelConfig, cache_len: int):
    """Serving prefill for attention families: run the stack over the prompt
    AND materialise the decode cache (RoPE'd K/V per layer for GQA; the
    compressed (ckv, k_rope) latents for MLA), padded to ``cache_len``.

    Returns (last_logits, cache, next_pos).
    """
    if cfg.family not in ("dense", "vlm", "moe"):
        raise NotImplementedError(
            "cache-filling prefill covers attention decoder families; "
            "ssm/hybrid decode from the SSD state, encdec from enc_out")
    x = _decoder_input(params, batch, cfg)
    cos, sin = _rope_tables(x, cfg)

    h = x
    kvs = []
    for lp in _layers(params["blocks"]):
        hh = rms_norm(h, lp["norm1"], cfg.norm_eps)
        train = attn.mla_train if cfg.mla else attn.gqa_train
        o, kv = train(lp["attn"], hh, cos, sin, cfg, return_kv=True)
        h = h + o
        m = rms_norm(h, lp["norm2"], cfg.norm_eps)
        if "moe" in lp:
            f, _ = mlp_mod.moe_apply(
                lp["moe"], m, cfg,
                score_fn="sigmoid" if cfg.mla else "softmax",
                dropless=True,     # serving: must match stepwise decode
            )
        else:
            f = mlp_mod.mlp_apply(lp["mlp"], m)
        h = h + f
        kvs.append(kv)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = _lm_head(params, h[:, -1:, :], cfg)

    seq = x.shape[1]
    pad = cache_len - seq
    if pad < 0:
        raise ValueError(f"cache_len {cache_len} < prompt {seq}")

    def padded(i):                            # (L, B, S, ...) -> (L, B, len, ...)
        a = torch.stack([kv[i] for kv in kvs], 0)
        shape = (*a.shape[:2], pad, *a.shape[3:])
        return torch.cat([a, a.new_zeros(shape)], 2).to(cfg.act_dtype)

    names = ("ckv", "krope") if cfg.mla else ("k", "v")
    cache = {"kv": {n: padded(i) for i, n in enumerate(names)}}
    return logits, cache, seq


def forward_prefill(params, batch, cfg: ModelConfig):
    """Inference prefill: run the stack over the prompt, return
    last-position logits (encdec: the loss, as the reference does)."""
    if cfg.family == "encdec":
        loss, _ = _encdec_train(params, batch, cfg)
        return loss
    x = _decoder_input(params, batch, cfg)
    cos, sin = _rope_tables(x, cfg)
    h, _ = _decoder_stack(params, x, cos, sin, cfg)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return shard_act(_lm_head(params, h[:, -1:, :], cfg), "batch", None,
                     "vocab")


# ---------------------------------------------------------------------------
# Encoder-decoder (Whisper)
# ---------------------------------------------------------------------------


def _xattn_train(p, x, enc_out, cfg: ModelConfig):
    """Cross-attention: q from x, k/v from encoder output (no RoPE)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("btd,dhk->bthk", enc_out, p["wk"])
    v = torch.einsum("btd,dhk->bthk", enc_out, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    zero = torch.zeros((1, 1, q.shape[1], k.shape[1]), dtype=torch.float32,
                       device=x.device)
    out = attn._attend(q, k, v, zero, cfg)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _encode(params, frames, cfg: ModelConfig):
    """Whisper's encoder over (B, T, D) stub frame embeddings."""
    frames = frames.to(cfg.act_dtype)
    t = frames.shape[1]
    pos_enc = torch.from_numpy(sinusoidal_positions(t, cfg.d_model)).to(
        device=frames.device, dtype=cfg.act_dtype)
    h = shard_act(frames + pos_enc[None], "batch", "seq", "act_embed")
    zero = torch.zeros((1, 1, t, t), dtype=torch.float32, device=h.device)

    def body(lp, h):
        a = rms_norm(h, lp["norm1"], cfg.norm_eps)
        # bidirectional: no causal mask
        q, k, v = attn._qkv(lp["attn"], a, cfg)
        o = attn._attend(q, k, v, zero, cfg)
        h = h + torch.einsum("bshk,hkd->bsd", o, lp["attn"]["wo"])
        m = rms_norm(h, lp["norm2"], cfg.norm_eps)
        return h + mlp_mod.mlp_apply(lp["mlp"], m)

    body = _remat(body, cfg)
    for lp in _layers(params["enc"]):
        h = body(lp, h)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def _encdec_train(params, batch, cfg: ModelConfig):
    enc_out = _encode(params, batch["frames"], cfg)
    tokens = batch["tokens"]
    s = tokens.shape[1]
    y = _embed(params, tokens, cfg)
    cos, sin = make_rope(torch.arange(s, device=y.device)[None, :],
                         cfg.head_dim, cfg.rope_theta)

    def body(lp, h):
        a = rms_norm(h, lp["norm1"], cfg.norm_eps)
        h = h + attn.gqa_train(lp["attn"], a, cos, sin, cfg)
        cx = rms_norm(h, lp["normx"], cfg.norm_eps)
        h = h + _xattn_train(lp["xattn"], cx, enc_out, cfg)
        m = rms_norm(h, lp["norm2"], cfg.norm_eps)
        return h + mlp_mod.mlp_apply(lp["mlp"], m)

    body = _remat(body, cfg)
    h = y
    for lp in _layers(params["dec"]):
        h = body(lp, h)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    loss = _chunked_ce(params, h, batch["labels"], batch["mask"], cfg)
    return loss, {"ce": loss}


# ---------------------------------------------------------------------------
# Decode path (serve_step)
# ---------------------------------------------------------------------------


def stack_n(tree, n):
    """Prepend an axis of ``n`` to every (meta) leaf of a cache spec."""
    return tree_map(lambda s: torch.empty((n, *s.shape), dtype=s.dtype,
                                          device="meta"), tree)


def init_cache(cfg: ModelConfig, batch: int, length: int):
    """The decode cache as meta tensors (shape and dtype, no storage),
    stacked over layers."""
    if cfg.family == "ssm":
        return {"ssm": stack_n(ssm_mod.ssm_state_spec(cfg, batch),
                               cfg.n_layers)}
    if cfg.family == "hybrid":
        c = {"ssm": stack_n(ssm_mod.ssm_state_spec(cfg, batch), cfg.n_layers)}
        if cfg.shared_attn_every:
            n_sites = cfg.n_layers // cfg.shared_attn_every
            win = min(length, cfg.sliding_window) if cfg.sliding_window \
                else length
            c["shared_kv"] = stack_n(attn.gqa_cache_spec(cfg, batch, win),
                                     n_sites)
        return c
    if cfg.family == "encdec":
        sl = min(length, cfg.max_target_len)
        return {
            "kv": stack_n(attn.gqa_cache_spec(cfg, batch, sl), cfg.n_layers),
            "enc_out": torch.empty((batch, cfg.n_audio_frames, cfg.d_model),
                                   dtype=cfg.act_dtype, device="meta"),
        }
    if cfg.mla:
        return {"kv": stack_n(attn.mla_cache_spec(cfg, batch, length),
                              cfg.n_layers)}
    return {"kv": stack_n(attn.gqa_cache_spec(cfg, batch, length),
                          cfg.n_layers)}


def zeros_cache(cfg: ModelConfig, batch: int, length: int, device="cuda"):
    """Materialised (all-zero) decode cache on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    init_cache(cfg, batch, length))


def forward_decode(params, tokens, cache, pos, cfg: ModelConfig):
    """One decode step. tokens: (B, 1); pos: int.  Returns
    (logits (B, 1, V), new_cache); ``cache`` is left untouched."""
    pos = int(pos)
    x = shard_act(_embed(params, tokens, cfg), "batch", None, "act_embed")

    if cfg.family == "ssm":
        h, states = x, []
        for lp, st in zip(_layers(params["blocks"]), _layers(cache["ssm"])):
            a = rms_norm(h, lp["norm1"], cfg.norm_eps)
            o, st2 = ssm_mod.ssm_decode(lp["ssm"], a, st, cfg)
            h = h + o
            states.append(st2)
        new_cache = {"ssm": _stack_trees(states)}
    elif cfg.family == "hybrid":
        h, new_cache = _hybrid_decode(params, x, cache, pos, cfg)
    elif cfg.family == "encdec":
        h, new_cache = _encdec_decode(params, x, cache, pos, cfg)
    else:
        decode_fn = attn.mla_decode if cfg.mla else attn.gqa_decode
        h, kvs = x, []
        for lp, kv in zip(_layers(params["blocks"]), _layers(cache["kv"])):
            a = rms_norm(h, lp["norm1"], cfg.norm_eps)
            o, kv2 = decode_fn(lp["attn"], a, kv, pos, cfg)
            h = h + o
            m = rms_norm(h, lp["norm2"], cfg.norm_eps)
            if "moe" in lp:
                f, _ = mlp_mod.moe_apply(
                    lp["moe"], m, cfg,
                    score_fn="sigmoid" if cfg.mla else "softmax",
                    dropless=True,     # serving: no capacity competition
                )
            else:
                f = mlp_mod.mlp_apply(lp["mlp"], m)
            h = h + f
            kvs.append(kv2)
        new_cache = {"kv": _stack_trees(kvs)}

    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    logits = shard_act(_lm_head(params, h, cfg), "batch", None, "vocab")
    return logits, new_cache


def _hybrid_decode(params, x, cache, pos: int, cfg: ModelConfig):
    """Mamba runs between the shared-attention sites (every ``period``
    layers; a trailing run shorter than ``period`` has no site)."""
    period = cfg.shared_attn_every
    x0 = h = x
    n_sites = cfg.n_layers // period if period else 0
    blocks = _layers(params["blocks"])
    ssm_states = _layers(cache["ssm"])
    sp = params.get("shared_attn")
    states, kvs = [], []
    site = lo = 0
    while lo < cfg.n_layers:
        hi = min(lo + period, cfg.n_layers) if period else cfg.n_layers
        for lp, st in zip(blocks[lo:hi], ssm_states[lo:hi]):
            a = rms_norm(h, lp["norm1"], cfg.norm_eps)
            o, st2 = ssm_mod.ssm_decode(lp["ssm"], a, st, cfg)
            h = h + o
            states.append(st2)
        if period and hi == lo + period and site < n_sites:
            kv = tree_map(lambda a: a[site], cache["shared_kv"])
            hh = torch.einsum("bse,ed->bsd", torch.cat([h, x0], -1),
                              sp["in_proj"])
            a = rms_norm(hh, sp["norm1"], cfg.norm_eps)
            win = kv["k"].shape[1]
            o, kv2 = attn.gqa_decode(
                sp["attn"], a, kv, pos, cfg,
                write_pos=(pos % win) if cfg.sliding_window else None)
            hh = hh + o
            m = rms_norm(hh, sp["norm2"], cfg.norm_eps)
            h = h + hh + mlp_mod.mlp_apply(sp["mlp"], m)
            kvs.append(kv2)
            site += 1
        lo = hi

    new_cache = {"ssm": _stack_trees(states)}
    if kvs:
        new_cache["shared_kv"] = _stack_trees(kvs)
    return h, new_cache


def _encdec_decode(params, x, cache, pos: int, cfg: ModelConfig):
    enc_out = cache["enc_out"]
    h, kvs = x, []
    for lp, kv in zip(_layers(params["dec"]), _layers(cache["kv"])):
        a = rms_norm(h, lp["norm1"], cfg.norm_eps)
        o, kv2 = attn.gqa_decode(lp["attn"], a, kv, pos, cfg)
        h = h + o
        cx = rms_norm(h, lp["normx"], cfg.norm_eps)
        h = h + _xattn_train(lp["xattn"], cx, enc_out, cfg)
        m = rms_norm(h, lp["norm2"], cfg.norm_eps)
        h = h + mlp_mod.mlp_apply(lp["mlp"], m)
        kvs.append(kv2)
    return h, {"kv": _stack_trees(kvs), "enc_out": enc_out}
