"""Address-Event-Representation codec (``repro.events.aer``; paper §II-A),
numpy only.

One uint32 word per event: x in bits [13:0], y in [27:14], the polarity
(1 for ON) in bit 28; the timestamp travels separately, as int64
microseconds.  Coordinates are 14-bit (up to 16383; the IMX636 is
1280x720).
"""
from __future__ import annotations

import numpy as np

__all__ = ["pack", "unpack", "MAX_XY"]

MAX_XY = (1 << 14) - 1

_X_SHIFT = 0
_Y_SHIFT = 14
_P_SHIFT = 28


def pack(xy: np.ndarray, pol: np.ndarray) -> np.ndarray:
    """(E, 2) int coordinates + (E,) polarity in {-1, +1} -> (E,) uint32
    AER words; a coordinate above ``MAX_XY`` raises ``ValueError``."""
    x = xy[:, 0].astype(np.uint32)
    y = xy[:, 1].astype(np.uint32)
    if (x > MAX_XY).any() or (y > MAX_XY).any():
        raise ValueError("coordinate exceeds 14-bit AER field")
    p = (pol > 0).astype(np.uint32)
    return (x << _X_SHIFT) | (y << _Y_SHIFT) | (p << _P_SHIFT)


def unpack(words: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """uint32 AER words -> ((E, 2) int32 xy, (E,) int8 polarity)."""
    words = words.astype(np.uint32)
    x = (words >> _X_SHIFT) & MAX_XY
    y = (words >> _Y_SHIFT) & MAX_XY
    p = ((words >> _P_SHIFT) & 1).astype(np.int8)
    pol = np.where(p == 1, np.int8(1), np.int8(-1))
    return np.stack([x, y], 1).astype(np.int32), pol
