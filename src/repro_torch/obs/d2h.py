"""D2H transfer accounting helpers — the ONE place readout byte math lives.

The H2D side already has a single owner (the pinned-host stager's
slot/valid counters); this module is its D2H mirror: the runtime's fetch
paths call ``leaves_nbytes`` on exactly the leaves they hand to
``device_get`` and increment registry handles with the result, and the CI
metrics-ownership lint bans ad-hoc ``nbytes`` arithmetic in
``src/repro/serve`` / ``src/repro/launch`` so the accounting can never
fork.  ``nbytes`` is shape/dtype metadata on both device and host arrays,
so nothing here forces a device sync.
"""
from __future__ import annotations

__all__ = ["leaves_nbytes"]


def leaves_nbytes(*arrays) -> int:
    """Total payload bytes of the given arrays (device or host, or
    iterables of either; ``None`` entries are skipped).

    The fetch paths pass exactly what they hand to ``device_get``, so the
    counter reports what actually crossed (or, for the dense-equivalent
    baseline, would have crossed) the transfer — honest bytes on both
    readouts.
    """
    total = 0
    for a in arrays:
        if a is None:
            continue
        if hasattr(a, "nbytes"):
            total += int(a.nbytes)
        else:
            total += leaves_nbytes(*a)
    return total
