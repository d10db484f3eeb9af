"""K3, the ring push (``csrc/compact.cu`` ``ring_push_kernel``): one launch
per pool round writes the round into the bucket's device ring.

Frozen from ``bounds.push_bound``: the round's rows read once (scores,
keep, three int32 and one bool per lane) and written once into the slot,
with the compact readout also ``cap`` (index, score) records per lane, and
the three cursors read and written; no arithmetic to speak of.
"""
from __future__ import annotations

from perfbench.rooflines import _peaks

KERNELS = ("ring_push_kernel",)
CALL_KERNEL = "ring_push_kernel"


def call_work(lanes: int, e: int, cap: int) -> float:
    row = lanes * (e * 5 + 13)
    return 2 * row + lanes * cap * 8 + 24


def bound(rounds) -> tuple[float, str, int]:
    """Least seconds for the pushes of ``rounds`` (each with ``phys`` lanes
    in the ring, ``e`` and the record ``cap``, 0 for a dense ring)."""
    nbytes = sum(call_work(r.phys, r.e, r.cap) for r in rounds)
    t, what = _peaks.bound(nbytes, 0, 1.0)
    return t, what, len(rounds)
