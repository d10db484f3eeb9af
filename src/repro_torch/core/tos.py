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
in-bounds dummies).  ``tos_update_batched_onehot`` is the same closed form
with ``k`` of the background counted as a one-hot matmul, as the
reference's MXU spelling does; it is bit-equal to ``tos_update_batched``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "TOS_MAX",
    "DEFAULT_TH",
    "DEFAULT_PATCH",
    "tos_new",
    "tos_update_sequential",
    "tos_update_batched",
    "tos_update_batched_onehot",
    "tos_invariant_ok",
    "TosStream",
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
    """k_after[..., i] = #{ j > i : patch(e_j) contains centre(e_i) }
    (valid); ``xy (..., E, 2)`` may carry a leading lane axis."""
    x = xy[..., 0].to(torch.int32)
    y = xy[..., 1].to(torch.int32)
    cover = ((x[..., None, :] - x[..., :, None]).abs() <= r) & (
        (y[..., None, :] - y[..., :, None]).abs() <= r)
    ar = torch.arange(xy.shape[-2], device=xy.device)
    later = ar[None, :] > ar[:, None]
    mask = cover & later & valid[..., None, :] & valid[..., :, None]
    return mask.sum(-1, dtype=torch.int32)


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
    under a scatter-max); -1 where no valid event is centred.  ``xy
    (..., E, 2)`` may carry a leading lane axis; the result is ``(..., H,
    W)`` int32."""
    h, w = shape
    lead = tuple(xy.shape[:-2])
    idx = torch.arange(xy.shape[-2], dtype=torch.int32, device=xy.device)
    key = torch.where(valid, idx * 512 + values,
                      torch.full_like(values, -1))
    flat = xy[..., 1].long() * w + xy[..., 0].long()
    buf = torch.full((*lead, h * w), -1, dtype=torch.int32, device=xy.device)
    buf = buf.scatter_reduce(-1, flat, key, reduce="amax", include_self=True)
    buf = buf.reshape(*lead, h, w)
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
    k_total = _scatter_patch_counts(tuple(tos.shape), xy, valid, r)
    return _closed_form(tos, xy, valid, k_total, r, th)


def _closed_form(tos, xy, valid, k_total, r, th) -> torch.Tensor:
    """The closed form given the background's cover counts ``k_total``:
    the thresholded background, overlaid with the last centre writes."""
    new_bg = _clamp_threshold(tos.to(torch.int32) - k_total, th)
    k_after = _suffix_cover_counts(xy, valid, r)
    centre_vals = _clamp_threshold(TOS_MAX - k_after, th)
    centre_surf = _scatter_last_center_value(tuple(tos.shape), xy, valid,
                                             centre_vals)
    out = torch.where(centre_surf >= 0, centre_surf, new_bg)
    return out.to(torch.uint8)


def _onehot_band(coord: torch.Tensor, n: int, r: int,
                 valid: torch.Tensor) -> torch.Tensor:
    """(E, n) bool matrix: row j is true on [coord_j - r, coord_j + r]
    (clipped) when event j is valid."""
    grid = torch.arange(n, dtype=torch.int32, device=coord.device)[None, :]
    return ((grid - coord.to(torch.int32)[:, None]).abs() <= r) & \
        valid[:, None]


def tos_update_batched_onehot(
    tos: torch.Tensor,
    xy: torch.Tensor,
    valid: torch.Tensor,
    *,
    patch: int = DEFAULT_PATCH,
    th: int = DEFAULT_TH,
) -> torch.Tensor:
    """``tos_update_batched`` with the background's cover counts as a
    matmul of one-hot bands: patch membership is separable, so ``k_total =
    RowBand^T @ ColBand``, an (H, E) x (E, W) product of float32 0/1
    matrices.  Every product and partial sum is an integer below 2**24, so
    the float32 result is exact (TF32 inputs too: 0 and 1 survive the
    rounding) and the update is bit-equal to ``tos_update_batched``."""
    r = (patch - 1) // 2
    h, w = tos.shape
    row_band = _onehot_band(xy[:, 1], h, r, valid)      # (E, H)
    col_band = _onehot_band(xy[:, 0], w, r, valid)      # (E, W)
    k_total = torch.matmul(row_band.to(torch.float32).T,
                           col_band.to(torch.float32)).to(torch.int32)
    return _closed_form(tos, xy, valid, k_total, r, th)


def tos_invariant_ok(tos: torch.Tensor, th: int = DEFAULT_TH) -> torch.Tensor:
    """The TOS invariant, values in {0} U [th, 255], as a 0-d bool tensor."""
    v = tos.to(torch.int32)
    return ((v == 0) | ((v >= th) & (v <= TOS_MAX))).all()


class TosStream(NamedTuple):
    """The carry of a long stream folded chunk by chunk: one surface.

    ``update`` takes any order-exact chunk update, ``tos_update_batched``
    by default; ``functools.partial(kernels.ops.tos_update_op, mode=...)``
    runs it through K4-K7 on a CUDA surface.
    """

    surface: torch.Tensor

    @staticmethod
    def init(height: int, width: int, *, device="cuda") -> "TosStream":
        from repro_torch.core.state import resolve_device
        return TosStream(tos_new(height, width,
                                 device=resolve_device(device)))

    def update(self, xy, valid, *, patch=DEFAULT_PATCH, th=DEFAULT_TH,
               update_fn=None) -> "TosStream":
        fn = tos_update_batched if update_fn is None else update_fn
        return TosStream(fn(self.surface, xy, valid, patch=patch, th=th))
