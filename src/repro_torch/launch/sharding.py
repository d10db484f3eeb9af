"""Host staging for the pool's uploads (``repro.launch.sharding``'s
``HostStager``; the reference's lane meshes have no counterpart on one
card).

``HostStager`` is a ring of ``depth`` pinned (page-locked) host slabs.
``put`` packs one block's arrays into the next slab, starts one
asynchronous copy to the device on the current stream, and records a CUDA
event after it; before a slab is written again the stager waits on that
event, so an upload still in flight never has its source pages
overwritten.  ``depth`` is the pump's stage-ahead window.  On a CPU device
``put`` returns plain copies and nothing is pinned.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["HostStager"]

_ALIGN = 16      # bytes; every array starts aligned in the slab


class HostStager:
    """Pinned-host staging of H2D uploads (see the module docstring).

    ``uploads`` counts the arrays staged.
    """

    def __init__(self, device=None, *, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.device = torch.device("cuda" if device is None else device)
        self.depth = int(depth)
        self._slabs: list[Optional[torch.Tensor]] = [None] * self.depth
        self._events: list[Optional[torch.cuda.Event]] = [None] * self.depth
        self._next = 0
        self.uploads = 0

    @property
    def pinned(self) -> bool:
        """True iff uploads actually stage through pinned host memory."""
        return self.device.type == "cuda"

    def put(self, *arrays: np.ndarray) -> list[torch.Tensor]:
        """The arrays on the device, in one copy from the next slab."""
        self.uploads += len(arrays)
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if not self.pinned:
            return [torch.from_numpy(a.copy()) for a in arrays]
        offs, total = [], 0
        for a in arrays:
            offs.append(total)
            total += -(-a.nbytes // _ALIGN) * _ALIGN
        i = self._next
        self._next = (i + 1) % self.depth
        if self._events[i] is not None:
            self._events[i].synchronize()    # the slab's last copy is done
        slab = self._slabs[i]
        if slab is None or slab.numel() < total:
            slab = self._slabs[i] = torch.empty(total, dtype=torch.uint8,
                                                pin_memory=True)
        host = slab.numpy()
        for a, off in zip(arrays, offs):
            host[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = slab[:total].to(self.device, non_blocking=True)
        ev = self._events[i] = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        out = []
        for a, off in zip(arrays, offs):
            t = torch.from_numpy(np.empty(0, a.dtype))
            out.append(dev[off:off + a.nbytes].view(t.dtype)
                       .reshape(a.shape))
        return out
