"""Threshold-Ordinal Surface updates (``repro.core.tos``), plain PyTorch.

Per kept event at ``(x, y)`` (Algorithm 1 of the paper): every pixel of the
P x P patch is decremented, values below ``th`` drop to 0, then the centre
is set to 255.  ``tos_update_batched`` is the reference's order-exact closed
form for a whole chunk:

    start(p) = 255 if p was some event's centre else TOS_before(p)
    k(p)     = number of later covering events (from the last centre write)
    TOS(p)   = start - k if >= th else 0

Surfaces are uint8 ``(H, W)``; events are int32 ``xy (E, 2)`` in
(x=col, y=row) order with a bool ``valid`` mask (padding slots must be
in-bounds dummies).
"""
from __future__ import annotations

import torch

__all__ = [
    "TOS_MAX",
    "DEFAULT_TH",
    "DEFAULT_PATCH",
    "tos_new",
    "tos_update_sequential",
    "tos_update_batched",
]

TOS_MAX = 255
DEFAULT_TH = 225
DEFAULT_PATCH = 7


def tos_new(height: int, width: int, *, device=None) -> torch.Tensor:
    """Fresh all-zero surface."""
    return torch.zeros((height, width), dtype=torch.uint8, device=device)


def _clamp_threshold(vals: torch.Tensor, th: int) -> torch.Tensor:
    """The TOS threshold rule on int32 working values."""
    return torch.where(vals >= th, vals, torch.zeros_like(vals))


def tos_update_sequential(
    tos: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    *,
    patch: int = DEFAULT_PATCH,
    th: int = DEFAULT_TH,
) -> torch.Tensor:
    """Event-by-event Algorithm 1 (the oracle; a host loop over events)."""
    h, w = tos.shape
    r = (patch - 1) // 2
    vals = tos.to(torch.int32).clone()
    for (x, y), ok in zip(xy.tolist(), valid.tolist()):
        if not ok:
            continue
        y0, y1 = max(y - r, 0), min(y + r + 1, h)
        x0, x1 = max(x - r, 0), min(x + r + 1, w)
        vals[y0:y1, x0:x1] = _clamp_threshold(vals[y0:y1, x0:x1] - 1, th)
        vals[y, x] = TOS_MAX
    return vals.to(torch.uint8)


def _suffix_cover_counts(xy: torch.Tensor, valid: torch.Tensor,
                         r: int) -> torch.Tensor:
    """k_after[i] = #{ j > i : patch(e_j) contains centre(e_i) } (valid)."""
    x = xy[:, 0].to(torch.int32)
    y = xy[:, 1].to(torch.int32)
    cover = ((x[None, :] - x[:, None]).abs() <= r) & (
        (y[None, :] - y[:, None]).abs() <= r)
    ar = torch.arange(xy.shape[0], device=xy.device)
    later = ar[None, :] > ar[:, None]
    mask = cover & later & valid[None, :] & valid[:, None]
    return mask.sum(1, dtype=torch.int32)


def _scatter_patch_counts(shape: tuple[int, int], xy: torch.Tensor,
                          valid: torch.Tensor, r: int) -> torch.Tensor:
    """k_total(p) = #{ j : patch(e_j) contains p } via a padded scatter-add."""
    h, w = shape
    wp = w + 2 * r
    acc = torch.zeros(((h + 2 * r) * wp,), dtype=torch.int32,
                      device=xy.device)
    offs = torch.arange(-r, r + 1, device=xy.device)
    py = xy[:, 1].long()[:, None, None] + offs[None, :, None] + r
    px = xy[:, 0].long()[:, None, None] + offs[None, None, :] + r
    flat = (py * wp + px).reshape(-1)
    p = 2 * r + 1
    upd = valid.to(torch.int32)[:, None, None].expand(-1, p, p).reshape(-1)
    acc.index_add_(0, flat, upd)
    return acc.reshape(h + 2 * r, wp)[r:r + h, r:r + w]


def _scatter_last_center_value(shape: tuple[int, int], xy: torch.Tensor,
                               valid: torch.Tensor,
                               values: torch.Tensor) -> torch.Tensor:
    """Last-writer-wins scatter of per-event centre values (key i*512 + v
    under a scatter-max); -1 where no valid event is centred."""
    h, w = shape
    e = xy.shape[0]
    idx = torch.arange(e, dtype=torch.int32, device=xy.device)
    key = torch.where(valid, idx * 512 + values,
                      torch.full_like(idx, -1))
    flat = xy[:, 1].long() * w + xy[:, 0].long()
    buf = torch.full((h * w,), -1, dtype=torch.int32, device=xy.device)
    buf = buf.scatter_reduce(0, flat, key, reduce="amax", include_self=True)
    buf = buf.reshape(h, w)
    return torch.where(buf >= 0, buf % 512, torch.full_like(buf, -1))


def tos_update_batched(
    tos: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    *,
    patch: int = DEFAULT_PATCH,
    th: int = DEFAULT_TH,
) -> torch.Tensor:
    """Order-exact closed-form TOS update for one chunk of events."""
    r = (patch - 1) // 2
    shape = tuple(tos.shape)

    k_total = _scatter_patch_counts(shape, xy, valid, r)
    new_bg = _clamp_threshold(tos.to(torch.int32) - k_total, th)

    k_after = _suffix_cover_counts(xy, valid, r)
    centre_vals = _clamp_threshold(TOS_MAX - k_after, th)
    centre_surf = _scatter_last_center_value(shape, xy, valid, centre_vals)

    out = torch.where(centre_surf >= 0, centre_surf, new_bg)
    return out.to(torch.uint8)
