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
the same bits.

``moe_apply_a2a`` is the reference's all-to-all expert parallelism over
the active mesh (``repro_torch.meshctx``), written as the explicit SPMD
steps its ``shard_map`` stands for: each rank routes its own (batch,
sequence) block, exchanges expert groups over the mesh's 'model' ranks,
runs its local experts and exchanges back.  The activation sites of the
reference's ``shard_act`` are kept: a no-op without a mesh or on plain
tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import compat
from repro_torch.meshctx import (current_mesh, current_rules, mesh_axes,
                                 shard_act, spec_placements)
from repro_torch.models.common import ModelConfig, ParamSpec

__all__ = ["mlp_spec", "mlp_apply", "moe_spec", "moe_apply", "moe_dispatch",
           "moe_apply_a2a", "p_shared_apply"]


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
    h = shard_act(_silu_gate(g, u), "batch", "seq", "mlp")
    return torch.einsum("bsf,fd->bsd", h, p["wd"])


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
    xe = shard_act(xe, "expert", "expert_cap", None)

    ye = _experts(xe, p["wg"], p["wu"], p["wd"])
    ye = ye * r["wgt"][..., None].to(ye.dtype)
    ye = shard_act(ye, "expert", "expert_cap", None)
    out = _combine(ye, r["slot"], topi, x2)

    if cfg.n_shared_experts:
        out = out + p_shared_apply(p["shared"], x2)

    out = out.reshape(b, s, d)
    return shard_act(out, "batch", "seq", "act_embed"), \
        aux * cfg.router_aux_weight


def _experts(xe, wg, wu, wd):
    """The expert FFNs over (E, C, D) token groups."""
    g = torch.einsum("ecd,edf->ecf", xe, wg)
    u = torch.einsum("ecd,edf->ecf", xe, wu)
    return torch.einsum("ecf,efd->ecd", _silu_gate(g, u), wd)


def _combine(ye, slot, topi, x2):
    """Each token sums its weighted slot results ``ye`` (E, C, D) in the
    order the reference's scatter-add visits them (expert ascending), in
    the activation dtype; a dropped assignment (slot -1) adds nothing."""
    t, k = topi.shape
    d = ye.shape[-1]
    by_e = torch.argsort(topi, dim=-1, stable=True)
    slot = torch.gather(slot, 1, by_e)
    rows = ye.reshape(-1, d)[slot.clamp(min=0)]          # (T, k, D)
    rows = torch.where((slot >= 0)[..., None], rows, 0)
    out = x2.new_zeros((t, d))
    for j in range(k):
        out = out + rows[:, j]
    return out


def p_shared_apply(p, x2):
    g = torch.einsum("td,df->tf", x2, p["wg"])
    u = torch.einsum("td,df->tf", x2, p["wu"])
    return torch.einsum("tf,fd->td", _silu_gate(g, u), p["wd"])


# ---------------------------------------------------------------------------
# All-to-all expert dispatch over a mesh (the reference's shard_map path)
# ---------------------------------------------------------------------------
#
# The reference writes the dispatch as a ``shard_map`` over the mesh: each
# shard routes its own token slice, exchanges expert groups along the model
# axis, runs its local experts, and reverses the exchange.  Here every rank
# runs those steps itself.  A plain (replicated) tensor enters through
# ``_Enter`` (the identity forward; its backward sums the ranks' gradients,
# each rank having used only its block or its share of the tokens) and the
# output leaves through ``_Gather`` (the ranks' blocks concatenated; its
# backward keeps this rank's block of the replicated gradient).  A
# ``DTensor`` is redistributed to the reference's in-specs instead and the
# output stays a ``DTensor``.


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        for grp in ctx.groups:
            dist.all_reduce(g, group=grp)
        return g, None


class _Gather(torch.autograd.Function):
    """Blocks of ``(dim, group, index)`` steps, minor first, concatenated
    in rank order; the backward keeps this rank's block."""

    @staticmethod
    def forward(ctx, y, steps):
        ctx.steps = steps
        ctx.shape = y.shape
        for dim, grp, _ in steps:
            parts = [torch.empty_like(y)
                     for _ in range(dist.get_world_size(grp))]
            dist.all_gather(parts, y.contiguous(), group=grp)
            y = torch.cat(parts, dim)
        return y

    @staticmethod
    def backward(ctx, g):
        idx = [slice(None)] * g.dim()
        for dim, _, i in ctx.steps:
            n = ctx.shape[dim]
            idx[dim] = slice(i * n, (i + 1) * n)
        return g[tuple(idx)], None


def _local_in(a, mesh, spec, groups, block):
    """This rank's block of a replicated tensor or of a DTensor laid out
    as ``spec`` (its gradient is summed over ``groups`` / kept partial)."""
    if isinstance(a, compat.DTensor):
        pl = spec_placements(mesh, spec)
        grad_pl = [q if isinstance(q, compat.Shard) else compat.Partial()
                   for q in pl]
        return a.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
    return _Enter.apply(a, groups)[block]


def moe_apply_a2a(p, x, cfg: ModelConfig, *, capacity_factor: float = 1.25,
                  score_fn: str = "softmax"):
    """MoE with explicit all-to-all expert parallelism.

    Requires an active mesh (``repro_torch.meshctx``) whose 'model' axis
    divides n_experts, and a token count divisible by (batch shards x
    model).  Falls back to ``moe_apply`` otherwise.  The capacity comes
    from a rank's local token count, so this equals ``moe_apply`` only
    where no token is dropped.  A plain tensor in gives the whole output
    on every rank; a ``DTensor`` in gives a ``DTensor`` out.
    """
    mesh = current_mesh()
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k

    def fallback():
        return moe_apply(p, x, cfg, capacity_factor=capacity_factor,
                         score_fn=score_fn)

    if mesh is None:
        return fallback()
    batch_axes = current_rules().get("batch") or ()
    if isinstance(batch_axes, str):
        batch_axes = (batch_axes,)
    _, size = mesh_axes(mesh)
    m = size.get("model", 1)
    dp = math.prod(size[a] for a in batch_axes)
    if (e % m != 0) or (t % (dp * m) != 0) or (s % m != 0):
        return fallback()
    bl, sl, el = b // dp, s // m, e // m
    capacity = max(int(bl * sl * k / e * capacity_factor), 1)

    # This rank's place: its batch block (major-to-minor over the batch
    # axes) and its model index (sequence block, expert block).
    bi = 0
    for a in batch_axes:
        bi = bi * size[a] + mesh.get_local_rank(a)
    mi = mesh.get_local_rank("model")
    axes_all = (*batch_axes, "model")
    groups = tuple(mesh.get_group(a) for a in axes_all)
    model_group = mesh.get_group("model")

    xs_spec = (batch_axes if batch_axes else None, "model", None)
    w_spec = ("model", None, None)
    x_loc = _local_in(x, mesh, xs_spec, groups,
                      (slice(bi * bl, (bi + 1) * bl),
                       slice(mi * sl, (mi + 1) * sl)))
    router = _local_in(p["router"], mesh, (None, None), groups,
                       (slice(None),)).to(x_loc.dtype)
    ws = [_local_in(p[n], mesh, w_spec, groups,
                    (slice(mi * el, (mi + 1) * el),))
          for n in ("wg", "wu", "wd")]

    x2 = x_loc.reshape(bl * sl, d)
    logits = torch.einsum("td,de->te", x2, router)
    topw, topi, aux = _route(logits, k, score_fn)
    r = moe_dispatch(topi, topw, e, capacity)
    x_pad = torch.cat([x2, x2.new_zeros((1, d))], 0)
    xe = x_pad[r["idx"].long()]                           # (e, C, d)
    # exchange: (e, C, d) -> (e/m, m*C, d), every rank's groups for the
    # local experts side by side in rank order
    xe = compat.all_to_all_single(xe, model_group)
    xe = xe.view(m, el, capacity, d).transpose(0, 1).reshape(
        el, m * capacity, d)
    ye = _experts(xe, *ws)
    # reverse exchange: (e/m, m*C, d) -> (e, C, d)
    ye = ye.view(el, m, capacity, d).transpose(0, 1).reshape(e, capacity, d)
    ye = compat.all_to_all_single(ye, model_group)
    ye = ye * r["wgt"][..., None].to(ye.dtype)
    y_loc = _combine(ye, r["slot"], topi, x2).reshape(bl, sl, d)

    # pmean over the batch axes and 'model', one mesh axis at a time
    aux = aux.reshape(1)
    for a, grp in zip(axes_all, groups):
        aux = _Gather.apply(aux, ((0, grp, mesh.get_local_rank(a)),)).mean(
            0, keepdim=True)
    aux = aux[0]

    if isinstance(x, compat.DTensor):
        y3 = compat.DTensor.from_local(
            y_loc, mesh, spec_placements(mesh, xs_spec), run_check=False)
        aux = compat.DTensor.from_local(
            aux, mesh, [compat.Replicate()] * mesh.ndim, run_check=False)
    else:
        steps = [(1, model_group, mi)] + [
            (0, mesh.get_group(a), mesh.get_local_rank(a))
            for a in reversed(batch_axes)]
        y3 = _Gather.apply(y_loc, tuple(steps))

    if cfg.n_shared_experts:
        y3 = y3 + p_shared_apply(
            p["shared"], x.reshape(t, d)).reshape(b, s, d)

    return shard_act(y3, "batch", "seq", "act_embed"), \
        aux * cfg.router_aux_weight
