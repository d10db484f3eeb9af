"""K1, the fused chunk step (``csrc/fused_step.cu``): one launch of its two
kernels per pool round, updating the lanes' surfaces in place.

Bytes (frozen from ``bounds.k1_work``): each event's xy, ts and valid read
and its keep and score written; the SAE read over the valid events' 3x3
neighbourhoods and written at their centres; the LUT read at the kept
centres; with write errors, every pixel's TOS byte read and written and
its int32 error bits read (and the lanes' rates).  Operations: nine SAE
tests per event, the kept patches' writes, four per pixel for the errors.
"""
from __future__ import annotations

from perfbench.rooflines import _peaks

KERNELS = ("stcf_score_kernel", "fused_tile_kernel")   # both, per call
CALL_KERNEL = "fused_tile_kernel"


def call_work(rnd) -> tuple[float, float]:
    """``(bytes, integer operations)`` of the call on one round: ``rnd``
    has ``xy (B, E, 2)``, ``valid``, ``keep (B, E)`` of the active lanes,
    ``h``, ``w``, ``patch`` and ``inject``."""
    b, e = rnd.valid.shape
    h, w = rnd.h, rnd.w
    nbytes = b * e * (8 + 4 + 1) + b * e * (1 + 4)
    nbytes += 4 * _peaks.covered(rnd.xy, rnd.valid, 1, h, w)
    nbytes += 4 * _peaks.covered(rnd.xy, rnd.valid, 0, h, w)
    nbytes += 4 * _peaks.covered(rnd.xy, rnd.keep, 0, h, w)
    if rnd.inject:
        nbytes += b * h * w * (1 + 4 + 1) + b * 4
    else:
        nbytes += 2 * _peaks.covered(rnd.xy, rnd.keep, rnd.patch // 2, h, w)
    ops = (9 * int(rnd.valid.sum()) + int(rnd.keep.sum()) * rnd.patch ** 2
           + (b * h * w * 4 if rnd.inject else 0))
    return nbytes, ops


def bound(rounds) -> tuple[float, str, int]:
    """Least seconds for the calls of ``rounds``, what bounds them, and the
    number of calls."""
    nbytes = ops = 0
    for rnd in rounds:
        b_, o_ = call_work(rnd)
        nbytes, ops = nbytes + b_, ops + o_
    t, what = _peaks.bound(nbytes, ops, _peaks.INT32_OPS)
    return t, what, len(rounds)
