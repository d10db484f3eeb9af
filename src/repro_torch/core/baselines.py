"""The event-camera corner detectors the paper compares against
(``repro.core.baselines``), plain PyTorch on the tensors' device.

  * eHarris (Vasco et al. 2016): a per-event Harris score of the binary
    surface of recent events around the event, O(window^2) per event.
  * evFAST (Mueggler et al. 2017): a contiguous-arc test of the newest
    timestamps on the r=3 (16 px) and r=4 (20 px) circles of the SAE.
  * evARC (Alzugaray & Chli 2018): the newest arc's angle must fall in
    [theta_min, theta_max] on both circles.

They run on the same SAE substrate as NMC-TOS: ``sae (H, W)`` int32
microseconds (``stcf.NEVER`` where a pixel never fired), events ``xy (E,
2)`` int32 in (x, y) order, ``ts (E,)``, ``valid (E,)`` bool; each returns
``(E,)`` float32 scores, ``-inf`` where invalid.

evFAST and evARC are integer geometry and one float32 division, equal to
the reference bit for bit.  eHarris correlates each event's patch with the
Sobel taps as a left fold (``harris._conv2_valid``) where the reference
calls XLA's convolution, whose rounding cannot be reproduced; the scores
agree within ``1e-5 * max|score|`` over the valid events.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import harris as harris_mod

__all__ = [
    "binary_surface",
    "eharris_scores",
    "CIRCLE3",
    "CIRCLE4",
    "fast_scores",
    "arc_scores",
]

_OUTSIDE = -(2**30)        # a ring pixel off the surface: never fired
_REAL = -(2**29)           # timestamps above this are real


def binary_surface(sae: torch.Tensor, t_now, window_us,
                   window_events: int = 0) -> torch.Tensor:
    """Binary float32 surface of the pixels that fired within
    ``window_us`` of ``t_now``."""
    recent = (t_now - sae <= window_us) & (sae > _REAL)
    return recent.to(torch.float32)


def eharris_scores(
    sae: torch.Tensor,
    xy: torch.Tensor,
    ts: torch.Tensor,
    valid: torch.Tensor,
    *,
    window_us: int = 20_000,
    patch: int = 9,
    k: float = 0.04,
) -> torch.Tensor:
    """Per-event Harris score of the binary surface patch around each event:
    one gather of every event's ``(L + 2m)^2`` patch (``L = patch``, ``m``
    the Sobel radius), then the Sobel correlations and the structure
    tensor's sums per event."""
    h, w = sae.shape
    r = patch // 2
    sob = 5
    gxk, gyk = harris_mod.sobel_kernels(sob)
    pad = r + sob // 2
    offs = torch.arange(-pad, pad + 1, dtype=torch.int32, device=sae.device)
    py = xy[:, 1].to(torch.int32)[:, None] + offs        # (E, L + 2m)
    px = xy[:, 0].to(torch.int32)[:, None] + offs
    inb = (((py >= 0) & (py < h))[:, :, None]
           & ((px >= 0) & (px < w))[:, None, :])
    ts_patch = sae[py.clamp(0, h - 1).long()[:, :, None],
                   px.clamp(0, w - 1).long()[:, None, :]]
    t = ts.to(torch.int32)[:, None, None]
    binp = ((t - ts_patch <= window_us) & (ts_patch > _REAL) & inb).to(
        torch.float32)
    gx = harris_mod._conv2_valid(binp, gxk)
    gy = harris_mod._conv2_valid(binp, gyk)
    a = (gx * gx).sum((-2, -1))
    b = (gy * gy).sum((-2, -1))
    c = (gx * gy).sum((-2, -1))
    score = (a * b - c * c) - k * (a + b) ** 2
    return torch.where(valid, score, torch.full_like(score, -torch.inf))


def _circle(radius: int) -> np.ndarray:
    """Circle offsets ``(n, 2)`` as (dx, dy), ordered by angle (the
    reference's)."""
    if radius == 3:
        pts = [
            (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
            (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
            (-1, 3),
        ]
    elif radius == 4:
        pts = [
            (0, 4), (1, 4), (2, 3), (3, 2), (4, 1), (4, 0), (4, -1), (3, -2),
            (2, -3), (1, -4), (0, -4), (-1, -4), (-2, -3), (-3, -2), (-4, -1),
            (-4, 0), (-4, 1), (-3, 2), (-2, 3), (-1, 4),
        ]
    else:
        raise ValueError(radius)
    return np.asarray(pts, dtype=np.int32)


CIRCLE3 = _circle(3)
CIRCLE4 = _circle(4)


def _ring_ts(sae: torch.Tensor, xy: torch.Tensor,
             circle: np.ndarray) -> torch.Tensor:
    """``(E, n)`` timestamps on the circle around each event; a pixel off
    the surface reads as never fired."""
    h, w = sae.shape
    d = torch.as_tensor(circle, device=sae.device)
    px = xy[:, 0].to(torch.int32)[:, None] + d[:, 0]
    py = xy[:, 1].to(torch.int32)[:, None] + d[:, 1]
    inb = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    vals = sae[py.clamp(0, h - 1).long(), px.clamp(0, w - 1).long()]
    return torch.where(inb, vals, torch.full_like(vals, _OUTSIDE))


def _newest(ring: torch.Tensor, kk: int) -> torch.Tensor:
    """The ring's pixels at or above its ``kk``-th newest timestamp (every
    tie kept)."""
    kth = torch.sort(ring, dim=1).values[:, -kk][:, None]
    return ring >= kth


def _longest_run(newest: torch.Tensor) -> torch.Tensor:
    """Longest circular run of True per row of ``(E, n)``, at most ``n``:
    over the doubled ring, each position's run is its distance from the
    last False at or before it."""
    n = newest.shape[1]
    doubled = torch.cat([newest, newest], dim=1)
    idx = torch.arange(2 * n, device=newest.device).expand_as(doubled)
    last_off = torch.cummax(torch.where(doubled, torch.full_like(idx, -1),
                                        idx), dim=1).values
    return (idx - last_off).amax(dim=1).clamp(max=n)


def _best_arc_len(newest: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """1 + run/n where the longest circular run lies in [lo, hi], else
    run/n (a graded score for the PR sweep)."""
    n = newest.shape[1]
    best = _longest_run(newest)
    frac = best.to(torch.float32) / n
    return torch.where((best >= lo) & (best <= hi), 1.0 + frac, frac)


def fast_scores(sae: torch.Tensor, xy: torch.Tensor, ts: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """evFAST: a corner iff the newest pixels form a contiguous arc of 3..6
    on the r=3 circle and 4..8 on the r=4 circle ('newest': the top-k
    timestamps of the ring, k the longest arc)."""
    s3 = _best_arc_len(_newest(_ring_ts(sae, xy, CIRCLE3), 6), 3, 6)
    s4 = _best_arc_len(_newest(_ring_ts(sae, xy, CIRCLE4), 8), 4, 8)
    score = torch.minimum(s3, s4)
    return torch.where(valid, score, torch.full_like(score, -torch.inf))


def arc_scores(
    sae: torch.Tensor,
    xy: torch.Tensor,
    ts: torch.Tensor,
    valid: torch.Tensor,
    *,
    theta_min_deg: float = 67.5,
    theta_max_deg: float = 112.5,
) -> torch.Tensor:
    """evARC: the newest arc (the ring's newer half) must span an angle in
    [theta_min, theta_max] on both circles; scored by its distance from 90
    degrees so thresholding sweeps a PR curve."""
    def angle(circle):
        n = len(circle)
        best = _longest_run(_newest(_ring_ts(sae, xy, circle), n // 2))
        return best.to(torch.float32) / n * 360.0

    def grade(a):
        inside = (a >= theta_min_deg) & (a <= theta_max_deg)
        g = 1.0 - (a - 90.0).abs() / 90.0
        return torch.where(inside, 1.0 + g, g * 0.5)

    score = torch.minimum(grade(angle(CIRCLE3)), grade(angle(CIRCLE4)))
    return torch.where(valid, score, torch.full_like(score, -torch.inf))
