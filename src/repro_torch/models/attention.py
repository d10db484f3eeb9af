"""Attention blocks of the LM scaffold (the port of
``repro.models.attention``): GQA (with MQA as n_kv=1) and DeepSeek-style
MLA.

Conventions:
  x          : (B, S, D) activations
  GQA cache  : {'k': (B, L, K, dh), 'v': (B, L, K, dh)} updated at ``pos``
  MLA cache  : {'ckv': (B, L, r_kv), 'krope': (B, L, d_rope)} — the
               compressed latent cache
  masks      : causal within the current segment; optional sliding window.

All softmax/logit math in float32; outputs cast back to the activation
dtype.  Attention is spelled as the reference spells it (einsum, additive
mask, softmax), not through a fused library attention.  Decode is
functional: it returns a new cache and leaves its input untouched.
``pos`` is a Python int (the host loop's step).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.meshctx import shard_act
from repro_torch.models.common import (ModelConfig, ParamSpec, apply_rope,
                                       make_rope, rms_norm)

__all__ = [
    "gqa_spec", "gqa_train", "gqa_decode", "gqa_cache_spec",
    "mla_spec", "mla_train", "mla_decode", "mla_cache_spec",
]

_NEG_INF = float("-inf")


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------


def gqa_spec(cfg: ModelConfig) -> dict:
    d, h, k, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.head_dim
    spec = {
        "wq": ParamSpec((d, h, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, k, dh), ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, k, dh), ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((h, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((h, dh), ("heads", "head_dim"), init="zeros")
        spec["bk"] = ParamSpec((k, dh), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = ParamSpec((k, dh), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _qkv(p, x, cfg: ModelConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    kk = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"]
        kk = kk + p["bk"]
        v = v + p["bv"]
    return q, kk, v


def _sqrt32(n: int) -> float:
    """``jnp.sqrt(n)``: the float32 square root."""
    return float(np.sqrt(np.float32(n)))


def _inv_sqrt32(n: int) -> float:
    """``1.0 / jnp.sqrt(n)`` in float32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(n)))


def _attend(q, k, v, mask, cfg: ModelConfig):
    """q: (B,Sq,H,dh); k,v: (B,Sk,K,dh); mask: (B|1, 1, Sq, Sk) additive f32."""
    b, sq, h, dh = q.shape
    kheads = k.shape[2]
    g = h // kheads
    qf = q.reshape(b, sq, kheads, g, dh).float()
    scores = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float()) / _sqrt32(dh)
    scores = scores + mask[:, :, None, :, :]
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) causal attention — O(chunk^2) score memory.
# ---------------------------------------------------------------------------

BLOCKWISE_MIN_SEQ = 2048     # use blockwise self-attention above this length
DEFAULT_ATTN_CHUNK = 1024


def _attend_blockwise_causal(q, k, v, cfg: ModelConfig, chunk: int):
    """Causal self-attention via online softmax over (q-block, k-block)
    tiles: never more than (B, K, G, C, C) scores.  Equal to ``_attend``
    with a causal mask to float tolerance; optional sliding window;
    Sq == Sk (self-attention, offset 0).  The reference's ``lax.map`` over
    q blocks and ``lax.scan`` over k blocks are Python loops here, every k
    block visited as there, with the same fully-masked-row guards."""
    b, s, h, dh = q.shape
    kheads = k.shape[2]
    vd = v.shape[-1]
    g = h // kheads
    c = min(chunk, s)
    assert s % c == 0, f"seq {s} %% attn chunk {c} != 0"
    n = s // c
    dev = q.device

    qf = q.reshape(b, n, c, kheads, g, dh).float()
    kf = k.reshape(b, n, c, kheads, dh).float()
    vf = v.reshape(b, n, c, kheads, vd).float()
    scale = _inv_sqrt32(dh)
    pos_in = torch.arange(c, device=dev)

    outs = []
    for qi in range(n):
        qb = qf[:, qi]                                   # (B, C, K, G, dh)
        m = torch.full((b, kheads, g, c), _NEG_INF, device=dev)
        l_sum = torch.zeros((b, kheads, g, c), device=dev)
        acc = torch.zeros((b, kheads, g, c, vd), device=dev)
        qpos = (qi * c + pos_in)[:, None]
        for ki in range(n):
            scores = torch.einsum("bqkgd,bskd->bkgqs", qb, kf[:, ki]) * scale
            kpos = (ki * c + pos_in)[None, :]
            ok = kpos <= qpos
            if cfg.sliding_window > 0:
                ok &= kpos > qpos - cfg.sliding_window
            scores = torch.where(ok, scores, _NEG_INF)
            m_new = torch.maximum(m, scores.amax(-1))
            # guard fully-masked rows (m == -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(scores - m_safe[..., None])
            p = torch.where(ok, p, 0.0)
            corr = torch.exp(torch.where(torch.isfinite(m), m - m_safe,
                                         _NEG_INF))
            corr = torch.where(torch.isfinite(corr), corr, 0.0)
            l_sum = l_sum * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p, vf[:, ki])
            m = m_new
        out = acc / torch.clamp(l_sum[..., None], min=1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, C, K, G, vd)
    out = torch.stack(outs, 1).reshape(b, s, h, vd)
    return out.to(q.dtype)


def _self_attend(q, k, v, cfg: ModelConfig):
    """Causal self-attention; blockwise from ``BLOCKWISE_MIN_SEQ`` on."""
    s = q.shape[1]
    chunk = cfg.attn_chunk or DEFAULT_ATTN_CHUNK
    if s >= BLOCKWISE_MIN_SEQ and s % chunk == 0:
        return _attend_blockwise_causal(q, k, v, cfg, chunk)
    mask = _causal_mask(s, s, 0, cfg.sliding_window, q.device)
    return _attend(q, k, v, mask, cfg)


def _causal_mask(sq: int, sk: int, offset: int, window: int, device=None
                 ) -> torch.Tensor:
    """Additive mask (1, 1, sq, sk). offset = absolute position of q[0]."""
    qpos = offset + torch.arange(sq, device=device)[:, None]
    kpos = torch.arange(sk, device=device)[None, :]
    ok = kpos <= qpos
    if window > 0:
        ok &= kpos > qpos - window
    return _additive(ok)[None, None]


def _additive(ok: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros((), dtype=torch.float32, device=ok.device)
    return torch.where(ok, zero, _NEG_INF)


def gqa_train(p, x, cos, sin, cfg: ModelConfig, *, return_kv: bool = False):
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    q = shard_act(q, "batch", "seq", "heads", None)
    k = shard_act(k, "batch", "seq", "kv_heads", None)
    out = _self_attend(q, k, v, cfg)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    out = shard_act(out, "batch", "seq", "act_embed")
    if return_kv:
        return out, (k, v)      # RoPE'd K — exactly what the decode cache holds
    return out


def gqa_cache_spec(cfg: ModelConfig, batch: int, length: int) -> dict:
    """The layer cache as meta tensors (shape and dtype, no storage)."""
    k, dh = cfg.n_kv, cfg.head_dim
    if cfg.kv_quant:
        # int8 per-(token, head) symmetric quantisation: values + f32 scales.
        kv = _meta((batch, length, k, dh), torch.int8)
        sc = _meta((batch, length, k, 1), torch.float32)
        return {"k": kv, "k_scale": sc, "v": kv, "v_scale": sc}
    kv = _meta((batch, length, k, dh), cfg.act_dtype)
    return {"k": kv, "v": kv}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _kv_quant(x):
    """(B,1,K,dh) -> int8 values + per-(token,head) scale."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True)
    scale = torch.clamp(scale, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def _kv_dequant(q, scale, dtype):
    return (q.float() * scale).to(dtype)


def _write(cache: torch.Tensor, new: torch.Tensor, at: int) -> torch.Tensor:
    """``lax.dynamic_update_slice(cache, new, (0, at, ...))`` along axis 1:
    a new tensor, the start clamped so the update fits."""
    at = min(max(int(at), 0), cache.shape[1] - new.shape[1])
    return cache.slice_scatter(new.to(cache.dtype), dim=1, start=at,
                               end=at + new.shape[1])


def gqa_decode(p, x, cache, pos, cfg: ModelConfig, write_pos=None):
    """One-token decode. x: (B, 1, D); pos: int current position.

    Returns (out, new_cache).  Attends over cache[0:pos] + the new token.

    ``write_pos``: physical cache slot (defaults to ``pos``).  Ring-buffer
    sliding-window caches pass ``pos % window`` here and clamp ``pos`` to
    ``min(pos, window-1)``: attention is permutation-invariant over keys
    (RoPE is baked into cached K at insert time), so 'first N slots valid'
    is exact whatever the ring's rotation.
    """
    pos = int(pos)
    cos, sin = _rope_at(pos, cfg, x.device)
    q, k, v = _qkv(p, x, cfg)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    wp = pos if write_pos is None else int(write_pos)
    mask_pos = pos if write_pos is None else min(pos, cache["k"].shape[1] - 1)
    if cfg.kv_quant:
        kq, ks = _kv_quant(k)
        vq, vs = _kv_quant(v)
        new_cache = {
            "k": _write(cache["k"], kq, wp),
            "k_scale": _write(cache["k_scale"], ks, wp),
            "v": _write(cache["v"], vq, wp),
            "v_scale": _write(cache["v_scale"], vs, wp),
        }
        ck = _kv_dequant(new_cache["k"], new_cache["k_scale"], k.dtype)
        cv = _kv_dequant(new_cache["v"], new_cache["v_scale"], v.dtype)
    else:
        ck = _write(cache["k"], k, wp)
        cv = _write(cache["v"], v, wp)
        new_cache = {"k": ck, "v": cv}
    length = ck.shape[1]
    kpos = torch.arange(length, device=x.device)[None, :]
    ok = kpos <= mask_pos
    if cfg.sliding_window > 0 and write_pos is None:
        ok &= kpos > pos - cfg.sliding_window
    mask = _additive(ok)[:, None, None, :]
    out = _attend(q, ck, cv, mask, cfg)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, new_cache


def _rope_at(pos: int, cfg: ModelConfig, device):
    dim = cfg.qk_rope_dim if cfg.mla else cfg.head_dim
    return make_rope(torch.tensor([[pos]], device=device), dim,
                     cfg.rope_theta)


# ---------------------------------------------------------------------------
# MLA — Multi-head Latent Attention (DeepSeek-V2/V3)
# ---------------------------------------------------------------------------


def mla_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h = cfg.n_heads
    rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    return {
        "wq_a": ParamSpec((d, rq), ("embed", "q_lora")),
        "q_norm": ParamSpec((rq,), ("q_lora",), init="ones"),
        "wq_b": ParamSpec((rq, h, dn + dr), ("q_lora", "heads", "head_dim")),
        "wkv_a": ParamSpec((d, rkv + dr), ("embed", "kv_lora")),
        "kv_norm": ParamSpec((rkv,), ("kv_lora",), init="ones"),
        "wk_b": ParamSpec((rkv, h, dn), ("kv_lora", "heads", "head_dim")),
        "wv_b": ParamSpec((rkv, h, dv), ("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((h, dv, d), ("heads", "head_dim", "embed")),
    }


def _mla_qkv_latent(p, x, cfg: ModelConfig):
    """Shared front: q heads (nope+rope) and the compressed kv latent."""
    rkv = cfg.kv_lora_rank
    cq = rms_norm(torch.einsum("bsd,dr->bsr", x, p["wq_a"]), p["q_norm"],
                  cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, p["wq_b"])
    q_nope, q_rope = q[..., : cfg.qk_nope_dim], q[..., cfg.qk_nope_dim:]
    kv_a = torch.einsum("bsd,dr->bsr", x, p["wkv_a"])
    ckv = rms_norm(kv_a[..., :rkv], p["kv_norm"], cfg.norm_eps)
    k_rope = kv_a[..., rkv:]                        # (B, S, dr), shared by heads
    return q_nope, q_rope, ckv, k_rope


def mla_train(p, x, cos, sin, cfg: ModelConfig, *, return_kv: bool = False):
    b, s, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, ckv, k_rope = _mla_qkv_latent(p, x, cfg)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]
    latent_cache = (ckv, k_rope)

    k_nope = torch.einsum("bsr,rhk->bshk", ckv, p["wk_b"])
    v = torch.einsum("bsr,rhk->bshk", ckv, p["wv_b"])

    qf = torch.cat([q_nope, q_rope], -1)
    kf = torch.cat(
        [k_nope, k_rope[:, :, None, :].expand(b, s, h, cfg.qk_rope_dim)], -1)
    qf = shard_act(qf, "batch", "seq", "heads", None)
    kf = shard_act(kf, "batch", "seq", "heads", None)

    # MLA is full MHA over (dn+dr)-dim keys and dv-dim values; reuse the
    # blockwise path (kheads == n_heads, distinct v dim).
    out = _self_attend(qf, kf, v, cfg)
    out = torch.einsum("bqhv,hvd->bqd", out, p["wo"])
    out = shard_act(out, "batch", "seq", "act_embed")
    if return_kv:
        return out, latent_cache   # compressed (ckv, k_rope) decode cache
    return out


def mla_cache_spec(cfg: ModelConfig, batch: int, length: int) -> dict:
    return {
        "ckv": _meta((batch, length, cfg.kv_lora_rank), cfg.act_dtype),
        "krope": _meta((batch, length, cfg.qk_rope_dim), cfg.act_dtype),
    }


def mla_decode(p, x, cache, pos, cfg: ModelConfig):
    """Absorbed-matrix MLA decode: attention runs in the compressed latent
    space, so a step reads (L, r_kv + d_rope) of cache per token instead of
    (L, H*(dn+dr))."""
    pos = int(pos)
    dn = cfg.qk_nope_dim
    cos, sin = _rope_at(pos, cfg, x.device)

    q_nope, q_rope, ckv_new, k_rope_new = _mla_qkv_latent(p, x, cfg)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope_new = apply_rope(k_rope_new[:, :, None, :], cos, sin)[:, :, 0, :]

    ckv = _write(cache["ckv"], ckv_new, pos)
    krope = _write(cache["krope"], k_rope_new, pos)

    # Absorb W_k^b into the query:  q_lat (B,1,H,rkv)
    q_lat = torch.einsum("bqhk,rhk->bqhr", q_nope.float(), p["wk_b"].float())
    scale = _inv_sqrt32(dn + cfg.qk_rope_dim)
    s_lat = torch.einsum("bqhr,bsr->bhqs", q_lat, ckv.float())
    s_rope = torch.einsum("bqhk,bsk->bhqs", q_rope.float(), krope.float())
    scores = (s_lat + s_rope) * scale
    length = ckv.shape[1]
    ok = torch.arange(length, device=x.device)[None, :] <= pos
    mask = _additive(ok)[:, None, None, :]
    w = torch.softmax(scores + mask, dim=-1)
    # Attend in latent space, then expand through W_v^b once per token.
    o_lat = torch.einsum("bhqs,bsr->bqhr", w, ckv.float())
    out = torch.einsum("bqhr,rhv->bqhv", o_lat, p["wv_b"].float())
    out = torch.einsum("bqhv,hvd->bqd", out.to(x.dtype), p["wo"])
    return out, {"ckv": ckv, "krope": krope}
