"""Spatio-Temporal Correlation Filter (``repro.core.stcf``), plain PyTorch.

An event is kept iff at least ``support`` neighbouring pixels (3x3 window,
centre excluded) fired within the last ``tw`` microseconds.  For a
time-sorted chunk, neighbour ``q`` of event ``i`` counts iff

    (some earlier valid in-chunk event j sits at q with t_i - t_j <= tw)
    OR (t_i - SAE_pre[q] <= tw and SAE_pre[q] is a real timestamp)

which is ``stcf_chunked``'s closed form; ``stcf_sequential`` is the
event-by-event oracle it equals.  Differences are int32 and wrap like the
reference's.  These functions work on one surface ``(H, W)``.
"""
from __future__ import annotations

import torch

__all__ = ["NEVER", "fresh_sae", "stcf_sequential", "stcf_chunked",
           "stcf_step"]

DEFAULT_RADIUS = 1
DEFAULT_SUPPORT = 2
NEVER = -(2**30)       # "pixel never fired" (``repro.core.stcf._NEVER``)


def fresh_sae(h: int, w: int, *, device=None) -> torch.Tensor:
    """Timestamp surface; int32 microseconds, NEVER = 'pixel never fired'."""
    return torch.full((h, w), NEVER, dtype=torch.int32, device=device)


def stcf_sequential(
    sae: torch.Tensor,
    xy: torch.Tensor,
    ts: torch.Tensor,
    valid: torch.Tensor,
    *,
    radius: int = DEFAULT_RADIUS,
    support: int = DEFAULT_SUPPORT,
    tw: int = 5000,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The oracle: each event in turn counts the recent pixels of its
    window (centre excluded) and then, if valid, stamps its own pixel;
    ``(new_sae, keep)``.  A host loop over the events, each step a few ops
    on the tensor's device (the coordinates and the valid mask are read
    once)."""
    h, w = sae.shape
    d = 2 * radius + 1
    surf = torch.full((h + 2 * radius, w + 2 * radius), NEVER,
                      dtype=torch.int32, device=sae.device)
    surf[radius:radius + h, radius:radius + w] = sae
    centre = torch.zeros((d, d), dtype=torch.bool, device=sae.device)
    centre[radius, radius] = True
    t = ts.to(torch.int32)
    keeps = []
    for i, ((x, y), ok) in enumerate(zip(xy.tolist(), valid.tolist())):
        win = surf[y:y + d, x:x + d]
        recent = ((t[i] - win) <= tw) & (win > NEVER // 2) & ~centre
        keeps.append((recent.sum() >= support) & ok)
        if ok:
            surf[y + radius, x + radius] = t[i]
    keep = (torch.stack(keeps) if keeps else
            torch.zeros((0,), dtype=torch.bool, device=sae.device))
    return surf[radius:radius + h, radius:radius + w].contiguous(), keep


def stcf_chunked(
    sae: torch.Tensor,
    xy: torch.Tensor,
    ts: torch.Tensor,
    valid: torch.Tensor,
    *,
    radius: int = DEFAULT_RADIUS,
    support: int = DEFAULT_SUPPORT,
    tw: int = 5000,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunk-exact STCF for a time-sorted chunk: ``(new_sae, keep)``."""
    h, w = sae.shape
    e = xy.shape[0]
    x = xy[:, 0].to(torch.int32)
    y = xy[:, 1].to(torch.int32)
    t = ts.to(torch.int32)

    dxp = x[None, :] - x[:, None]               # (i, j): pos_j - pos_i
    dyp = y[None, :] - y[:, None]
    ar = torch.arange(e, device=xy.device)
    earlier = ar[None, :] < ar[:, None]
    recent_pair = (t[:, None] - t[None, :]) <= tw
    pair_ok = earlier & recent_pair & valid[None, :]

    count = torch.zeros((e,), dtype=torch.int32, device=xy.device)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx == 0 and dy == 0:
                continue
            qy = y + dy
            qx = x + dx
            inb = (qy >= 0) & (qy < h) & (qx >= 0) & (qx < w)
            neigh = sae[qy.clamp(0, h - 1).long(), qx.clamp(0, w - 1).long()]
            surf_recent = inb & ((t - neigh) <= tw) & (neigh > NEVER // 2)
            chunk_recent = (pair_ok & (dxp == dx) & (dyp == dy)).any(1)
            count = count + (surf_recent | chunk_recent).to(torch.int32)

    keep = (count >= support) & valid

    upd = torch.where(valid, t, torch.full_like(t, NEVER))
    flat = (y.long() * w + x.long())
    new_sae = sae.reshape(-1).scatter_reduce(
        0, flat, upd, reduce="amax", include_self=True
    ).reshape(h, w)
    return new_sae, keep


def stcf_step(
    sae: torch.Tensor,
    xy: torch.Tensor,
    ts: torch.Tensor,
    valid: torch.Tensor,
    *,
    enabled: bool = True,
    radius: int = DEFAULT_RADIUS,
    support: int = DEFAULT_SUPPORT,
    tw: int = 5000,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One chunk: denoise + SAE refresh; identity (keep = valid) if off."""
    if not enabled:
        return sae, valid
    return stcf_chunked(
        sae, xy, ts, valid, radius=radius, support=support, tw=tw
    )
