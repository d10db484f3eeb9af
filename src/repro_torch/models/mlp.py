"""MLP blocks of the LM scaffold (the port of ``repro.models.mlp``): SwiGLU
dense FFN and token-choice top-k MoE.

MoE uses the reference's sort-based grouped dispatch:

  1. router scores -> top-k (expert, weight) per token (ties to the lower
     expert index, as ``lax.top_k``),
  2. stable-sort assignments by expert, position-in-expert by offset
     subtraction,
  3. gather tokens into (E, C, D) groups, batched-einsum the expert FFNs,
  4. weighted combine back.

Step 4 is the reference's scatter-add (``.at[idx].add``) made
deterministic: each token gathers its k slot results and sums them in the
reference's order (expert index ascending), so two runs on the card give
the same bits.  The all-to-all dispatch (``moe_apply_a2a``) needs a device
mesh and is not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, ParamSpec

__all__ = ["mlp_spec", "mlp_apply", "moe_spec", "moe_apply", "moe_dispatch",
           "p_shared_apply"]


# ---------------------------------------------------------------------------
# Dense SwiGLU
# ---------------------------------------------------------------------------


def mlp_spec(cfg: ModelConfig, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": ParamSpec((d, f), ("embed", "mlp")),
        "wu": ParamSpec((d, f), ("embed", "mlp")),
        "wd": ParamSpec((f, d), ("mlp", "embed")),
    }


def _silu_gate(g: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return F.silu(g.float()).to(u.dtype) * u


def mlp_apply(p, x):
    g = torch.einsum("bsd,df->bsf", x, p["wg"])
    u = torch.einsum("bsd,df->bsf", x, p["wu"])
    return torch.einsum("bsf,fd->bsd", _silu_gate(g, u), p["wd"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_spec(cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_expert or cfg.d_ff, cfg.n_experts
    spec = {
        "router": ParamSpec((d, e), ("embed", "expert"), scale=0.1),
        "wg": ParamSpec((e, d, f), ("expert", "embed", "expert_mlp")),
        "wu": ParamSpec((e, d, f), ("expert", "embed", "expert_mlp")),
        "wd": ParamSpec((e, f, d), ("expert", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        shared_f = cfg.n_shared_experts * f
        spec["shared"] = mlp_spec(cfg, shared_f)
    return spec


def _top_k(scores: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, equal values in
    index order (a stable descending sort)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits: torch.Tensor, k: int, score_fn: str):
    """(T, E) logits -> (topw, topi) with normalised weights + aux loss."""
    lf = logits.float()
    if score_fn == "sigmoid":                 # DeepSeek-V3
        scores = torch.sigmoid(lf)
    else:
        scores = torch.softmax(lf, dim=-1)
    topw, topi = _top_k(scores, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balance loss: E * sum_e f_e * P_e
    e = logits.shape[-1]
    probs = torch.softmax(lf, dim=-1)
    dispatch = F.one_hot(topi[:, 0], e).float()
    f_e = dispatch.mean(0)
    p_e = probs.mean(0)
    aux = e * torch.sum(f_e * p_e)
    return topw, topi, aux


def moe_dispatch(topi: torch.Tensor, topw: torch.Tensor, e: int,
                 capacity: int) -> dict:
    """The reference's integer routing of (T, k) assignments into (E, C)
    slots: ``order`` (stable sort by expert), ``pos_in_e``, ``keep``,
    ``idx`` (token per slot, sentinel T) and ``wgt``.

    Where an expert gets more than ``capacity`` assignments, the dropped
    ones clip onto its last slot, and the reference's scatter, applied in
    order, leaves the last of them there: slot C-1 holds the sentinel.
    The port writes only the slots that end up kept, so no index repeats.
    """
    t, k = topi.shape
    dev = topi.device
    flat_e = topi.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=e)
    starts = torch.cumsum(counts, 0) - counts
    pos_in_e = (torch.arange(t * k, dtype=torch.int32, device=dev)
                - starts[sorted_e].to(torch.int32))
    keep = pos_in_e < capacity
    token_of = (order // k).to(torch.int32)
    # The last slot keeps its own assignment only if nothing clipped on it.
    written = keep & ((pos_in_e < capacity - 1)
                      | (counts[sorted_e] <= capacity))
    slot = (sorted_e * capacity + pos_in_e.long())[written]
    idx = torch.full((e * capacity,), t, dtype=torch.int32, device=dev)
    idx[slot] = token_of[written]
    wgt = torch.zeros((e * capacity,), dtype=torch.float32, device=dev)
    wgt[slot] = topw.reshape(-1)[order][written]
    # Where each (token, top-k slot) landed, -1 where it was dropped.
    where = torch.full((t * k,), -1, dtype=torch.long, device=dev)
    where[order[written]] = slot
    return {"order": order, "pos_in_e": pos_in_e, "keep": keep,
            "idx": idx.reshape(e, capacity),
            "wgt": wgt.reshape(e, capacity), "slot": where.reshape(t, k)}


def moe_apply(p, x, cfg: ModelConfig, *, capacity_factor: float = 1.25,
              score_fn: str = "softmax", dropless: bool = False):
    """x: (B, S, D) -> (out, aux_loss).

    ``dropless=True`` sets capacity = t (no token can be dropped) — the
    serving configuration: prefill and stepwise decode must agree exactly,
    which capacity competition would break.
    """
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    x2 = x.reshape(t, d)

    logits = torch.einsum("td,de->te", x2, p["router"])
    topw, topi, aux = _route(logits, k, score_fn)

    capacity = t if dropless else max(int(t * k / e * capacity_factor), k)
    r = moe_dispatch(topi, topw, e, capacity)

    x_pad = torch.cat([x2, x2.new_zeros((1, d))], 0)
    xe = x_pad[r["idx"].long()]                         # (E, C, D)

    g = torch.einsum("ecd,edf->ecf", xe, p["wg"])
    u = torch.einsum("ecd,edf->ecf", xe, p["wu"])
    ye = torch.einsum("ecf,efd->ecd", _silu_gate(g, u), p["wd"])
    ye = ye * r["wgt"][..., None].to(ye.dtype)

    # Combine: each token sums its slots in the order the reference's
    # scatter-add visits them (expert ascending), in the activation dtype.
    slot = r["slot"]
    by_e = torch.argsort(topi, dim=-1, stable=True)
    slot = torch.gather(slot, 1, by_e)
    rows = ye.reshape(e * capacity, d)[slot.clamp(min=0)]   # (T, k, D)
    rows = torch.where((slot >= 0)[..., None], rows, 0)
    out = x2.new_zeros((t, d))
    for j in range(k):
        out = out + rows[:, j]

    if cfg.n_shared_experts:
        out = out + p_shared_apply(p["shared"], x2)

    return out.reshape(b, s, d), aux * cfg.router_aux_weight


def p_shared_apply(p, x2):
    g = torch.einsum("td,df->tf", x2, p["wg"])
    u = torch.einsum("td,df->tf", x2, p["wu"])
    return torch.einsum("tf,fd->td", _silu_gate(g, u), p["wd"])
