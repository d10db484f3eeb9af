"""Version-compatibility shims for the parts of ``torch.distributed`` the
mesh layer uses (the port of ``repro.compat``).

Every cross-version resolution lives here, so call sites use one
spelling: ``DeviceMesh`` / ``init_device_mesh``, ``DTensor`` and its
placements (public in ``torch.distributed.tensor`` on recent torch,
``torch.distributed._tensor`` before), and the differentiable
all-to-all of the functional collectives (the older
``torch.distributed.nn.functional`` spelling is deprecated).
"""
from __future__ import annotations

import torch
import torch.distributed._functional_collectives as _funcol
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

try:
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
except ImportError:                                   # torch < 2.5
    from torch.distributed._tensor import (DTensor, Replicate, Shard,
                                           distribute_tensor)
    from torch.distributed._tensor.placement_types import Partial

__all__ = ["DeviceMesh", "init_device_mesh", "DTensor", "Partial",
           "Replicate", "Shard", "distribute_tensor", "all_to_all_single"]


def _wait(t: torch.Tensor) -> torch.Tensor:
    return _funcol.wait_tensor(t) if isinstance(
        t, _funcol.AsyncCollectiveTensor) else t


def all_to_all_single(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all-to-all of equal splits along dimension 0 over
    ``group`` (a process group or ``(DeviceMesh, dim)``): block ``j`` of
    ``x`` goes to the group's rank ``j``, and the blocks received are
    concatenated in rank order.  Its backward is the same exchange."""
    return _wait(_funcol.all_to_all_single_autograd(
        x.contiguous(), None, None, group))
