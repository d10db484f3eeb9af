"""K2, the Harris LUT refresh (``csrc/harris.cu``): one launch per pool
round in which some lanes' refresh is due, over those lanes.

Frozen from ``bounds.k2_bound``: the TOS read and R written once (bytes)
against the float32 operations of the bit-exact spelling, each separately
rounded add or multiply one instruction: ``/255`` per pixel; on the
gradient region (the frame plus the window halo) a multiply and an add per
nonzero Sobel tap of gx and gy and six for the three products; per pixel
3 x window^2 adds and the 7-operation det/trace tail.
"""
from __future__ import annotations

from perfbench.rooflines import _peaks

KERNELS = ("harris_kernel",)
CALL_KERNEL = "harris_kernel"


def _nonzero_taps(size: int) -> int:
    """Nonzero taps of one extended Sobel kernel: the binomial smoothing row
    has ``size`` nonzeros, the derivative row all but its middle one."""
    return size * (size - 1)


def call_work(b: int, h: int, w: int, sobel: int, window: int):
    rw = window // 2
    grad = b * (h + 2 * rw) * (w + 2 * rw)
    pix = b * h * w
    ops = (pix + grad * (4 * _nonzero_taps(sobel) + 6)
           + pix * (3 * window * window + 7))
    return pix * (1 + 4), ops


def bound(rounds) -> tuple[float, str, int]:
    """Least seconds for the refreshes of ``rounds`` (each with ``due``
    lanes, ``h``, ``w``, ``sobel``, ``window``)."""
    calls = [r for r in rounds if r.due > 0]
    nbytes = ops = 0
    for r in calls:
        b_, o_ = call_work(r.due, r.h, r.w, r.sobel, r.window)
        nbytes, ops = nbytes + b_, ops + o_
    t, what = _peaks.bound(nbytes, ops, _peaks.FP32_ROUNDED)
    return t, what, len(calls)

