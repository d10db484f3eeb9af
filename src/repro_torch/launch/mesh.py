"""Local device meshes (the port of ``repro.launch.mesh``).

Axes:
  data  — data parallel + FSDP (optimizer/param shards)
  model — tensor / expert / head parallelism

``make_local_mesh`` builds a ``DeviceMesh`` over the ranks of the default
process group.  Where there is none it starts a world of one rank from an
in-process ``HashStore`` (NCCL for tensors on the card, gloo for tensors
on the host): no environment variable and no network port.  A multi-rank
run starts its group itself (``torch.distributed.init_process_group``
with its address, world size and rank) before it builds the mesh.
"""
from __future__ import annotations

import atexit

import torch
import torch.distributed as dist

from repro_torch.compat import DeviceMesh

__all__ = ["make_local_mesh", "world_size"]


def world_size() -> int:
    """Ranks of the default process group, 1 where there is none."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _ensure_group(dev: torch.device) -> None:
    """A world of one rank where there is no group: NCCL for CUDA tensors
    and gloo for host tensors where the card and NCCL are there, gloo
    alone elsewhere (a CUDA mesh then raises).  It is shut down at exit."""
    card = torch.cuda.is_available() and dist.is_nccl_available()
    if dev.type == "cuda" and not card:
        raise RuntimeError("make_local_mesh: a CUDA mesh needs a card and "
                           "NCCL")
    if dist.is_initialized():
        return
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("cpu:gloo,cuda:nccl" if card else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1)
    atexit.register(_shutdown)


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def make_local_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """A ``("data", "model")`` mesh over the first ``data * model`` ranks,
    clamped to the world size as the reference clamps to the local
    devices.  ``device`` sets the mesh's device type (``cuda`` unless the
    caller asks for ``cpu``)."""
    dev = torch.device(device)
    _ensure_group(dev)
    n = world_size()
    data = min(data, n)
    model = max(1, min(model, n // data))
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("data", "model"))
