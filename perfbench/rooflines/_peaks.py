"""Published peaks of one NVIDIA H100 SXM (data sheet, dense, at its full
700 W power limit), frozen from ``repro_torch.benchmarks.bounds``.

A kernel's least time is the larger of the bytes it must move (each input
byte read once, each output byte written once) over ``MEM_BPS`` and its
operations over the peak rate of their type.
"""
from __future__ import annotations

import numpy as np

MEM_BPS = 3.35e12               # HBM3, bytes/s
FP32_OPS = 66.9e12              # float32 outside the tensor cores, FMA = 2
FP32_ROUNDED = FP32_OPS / 2     # separately rounded adds or multiplies
INT32_OPS = 132 * 64 * 1.98e9   # 64 INT32 lanes per SM, 132 SMs, 1.98 GHz


def bound(nbytes: float, ops: float, rate: float) -> tuple[float, str]:
    """Least seconds and what bounds them."""
    t_b, t_o = nbytes / MEM_BPS, ops / rate
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def covered(xy: np.ndarray, mask: np.ndarray, radius: int, h: int,
            w: int) -> int:
    """Distinct pixels within ``radius`` (square, clipped) of the masked
    events, summed over lanes; ``xy (B, E, 2)``, ``mask (B, E)``."""
    n = 0
    for lane_xy, lane_m in zip(xy, mask):
        hit = np.zeros((h, w), bool)
        x, y = lane_xy[lane_m, 0], lane_xy[lane_m, 1]
        for dy in range(-radius, radius + 1):
            for dx in range(-radius, radius + 1):
                hit[np.clip(y + dy, 0, h - 1), np.clip(x + dx, 0, w - 1)] = 1
        n += int(hit.sum())
    return n
