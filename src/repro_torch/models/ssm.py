"""Mamba2 / SSD (state-space duality) blocks of the LM scaffold (the port of
``repro.models.ssm``) — Dao & Gu 2024.

The SSD chunked algorithm decomposes the linear recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t (B_t  x_t^T),      y_t = C_t h_t + D x_t

into intra-chunk quadratic attention-like products plus an inter-chunk
state carry (a short loop over L/Q chunks).

Shapes (single layer):
    x       : (B, L, D_model)
    d_inner : expand * d_model;   heads H = d_inner / headdim P
    B, C    : (B, L, N) with one group (G=1), N = ssm_state
    dt      : (B, L, H) positive via softplus(+bias)
    state   : (B, H, P, N) carried between chunks / decode steps

The depthwise causal conv stays the reference's explicit shift-and-add
(no ``conv1d``, whose cuDNN path may run in TF32 on the card).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.meshctx import shard_act
from repro_torch.models.common import ModelConfig, ParamSpec, rms_norm

__all__ = ["ssm_spec", "ssm_train", "ssm_decode", "ssm_state_spec"]


def ssm_spec(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    cw = cfg.ssm_conv
    return {
        "in_proj": ParamSpec((d, 2 * di + 2 * n + h), ("embed", "inner_all")),
        "conv_w": ParamSpec((cw, di + 2 * n), (None, "inner_all"), scale=0.5),
        "conv_b": ParamSpec((di + 2 * n,), ("inner_all",), init="zeros"),
        "a_log": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "d_skip": ParamSpec((h,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((h,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((di,), ("inner",), init="ones"),
        "out_proj": ParamSpec((di, d), ("inner", "embed")),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (no threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split_proj(p, x, cfg: ModelConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    zxbcdt = torch.einsum("bld,de->ble", x, p["in_proj"])
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di: 2 * di + 2 * n]
    dt = zxbcdt[..., 2 * di + 2 * n:]
    dt = _softplus(dt.float() + p["dt_bias"].float())
    return z, xbc, dt


def _causal_conv(xbc, w, b, cache=None):
    """Depthwise causal conv over time. cache: (B, cw-1, C) trailing context."""
    cw = w.shape[0]
    if cache is None:
        pad = xbc.new_zeros((xbc.shape[0], cw - 1, xbc.shape[2]))
    else:
        pad = cache.to(xbc.dtype)
    full = torch.cat([pad, xbc], 1)
    n = full.shape[1]
    out = 0
    for i in range(cw):
        out = out + full[:, i: n - (cw - 1 - i), :] * w[i][None, None, :]
    out = F.silu((out + b).float()).to(xbc.dtype)
    new_cache = full[:, -(cw - 1):, :]
    return out, new_cache


def _segsum(a):
    """Stable 'segment sum': segsum(a)[..., i, j] = sum a[j+1..i], -inf above."""
    q = a.shape[-1]
    cs = torch.cumsum(a, -1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, float("-inf"))


def ssm_train(p, x, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence SSD forward (chunked). x: (B, L, D). L % chunk == 0."""
    b, seq, _ = x.shape
    hn, pn, n, q = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_chunk
    assert seq % q == 0, f"seq {seq} not divisible by ssm_chunk {q}"
    nc = seq // q

    z, xbc, dt = _split_proj(p, x, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., : cfg.d_inner].reshape(b, seq, hn, pn)
    bmat = xbc[..., cfg.d_inner: cfg.d_inner + n]
    cmat = xbc[..., cfg.d_inner + n:]

    a = -torch.exp(p["a_log"].float())                      # (H,)
    da = dt * a[None, None, :]                              # (B, L, H)

    # chunk: (B, NC, Q, ...)
    xs_c = xs.reshape(b, nc, q, hn, pn).float()
    b_c = bmat.reshape(b, nc, q, n).float()
    c_c = cmat.reshape(b, nc, q, n).float()
    da_c = da.reshape(b, nc, q, hn)
    dt_c = dt.reshape(b, nc, q, hn)

    da_cs = torch.cumsum(da_c, 2)                           # (B,NC,Q,H)

    # --- intra-chunk (quadratic) ------------------------------------------
    lmat = torch.exp(_segsum(da_c.permute(0, 1, 3, 2)))     # (B,NC,H,Q,Q)
    scores = torch.einsum("bcqn,bckn->bcqk", c_c, b_c)      # (B,NC,Q,Q)
    y_diag = torch.einsum(
        "bcqk,bchqk,bckh,bckhp->bcqhp", scores, lmat, dt_c, xs_c)

    # --- chunk states ---------------------------------------------------------
    decay_states = torch.exp(da_cs[:, :, -1:, :] - da_cs)   # (B,NC,Q,H)
    states = torch.einsum(
        "bckn,bckh,bckhp->bchpn", b_c, decay_states * dt_c, xs_c)

    # --- inter-chunk recurrence (serial over NC) ------------------------------
    chunk_decay = torch.exp(da_cs[:, :, -1, :])             # (B,NC,H)
    h = x.new_zeros((b, hn, pn, n), dtype=torch.float32)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(h_prevs, 1)                       # (B,NC,H,P,N)

    # --- inter-chunk output ----------------------------------------------------
    decay_out = torch.exp(da_cs)                            # (B,NC,Q,H)
    y_off = torch.einsum("bcqn,bchpn,bcqh->bcqhp", c_c, h_prevs, decay_out)

    y = (y_diag + y_off).reshape(b, seq, hn, pn)
    y = y + xs.float() * p["d_skip"].float()[None, None, :, None]
    y = y.reshape(b, seq, cfg.d_inner).to(x.dtype)

    # gated RMSNorm + out projection
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"], cfg.norm_eps)
    out = torch.einsum("bli,id->bld", y, p["out_proj"])
    return shard_act(out, "batch", "seq", "act_embed")


def ssm_state_spec(cfg: ModelConfig, batch: int) -> dict:
    """The layer state as meta tensors (shape and dtype, no storage)."""
    hn, pn, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    return {
        "h": torch.empty((batch, hn, pn, n), dtype=torch.float32,
                         device="meta"),
        "conv": torch.empty((batch, cfg.ssm_conv - 1, cfg.d_inner + 2 * n),
                            dtype=cfg.act_dtype, device="meta"),
    }


def ssm_decode(p, x, state, cfg: ModelConfig):
    """Single-token recurrent step. x: (B, 1, D); O(1) in context length."""
    b = x.shape[0]
    hn, pn, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state

    z, xbc, dt = _split_proj(p, x, cfg)
    xbc, conv_cache = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                   state["conv"])
    xs = xbc[:, 0, : cfg.d_inner].reshape(b, hn, pn).float()
    bvec = xbc[:, 0, cfg.d_inner: cfg.d_inner + n].float()
    cvec = xbc[:, 0, cfg.d_inner + n:].float()
    dt1 = dt[:, 0, :]                                       # (B, H)

    a = -torch.exp(p["a_log"].float())
    dec = torch.exp(dt1 * a[None, :])                       # (B, H)
    h_new = state["h"] * dec[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt1, xs, bvec)
    y = torch.einsum("bhpn,bn->bhp", h_new, cvec)
    y = y + xs * p["d_skip"].float()[None, :, None]
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.float()).to(x.dtype), p["norm"], cfg.norm_eps)
    out = torch.einsum("bli,id->bld", y, p["out_proj"])
    return out, {"h": h_new, "conv": conv_cache}
