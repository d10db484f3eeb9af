"""Device meshes and the card's constants (the port of
``repro.launch.mesh``).

Axes:
  pod   — inter-pod data parallelism (the gradient all-reduce crosses it
          once per step)
  data  — data parallel + FSDP (optimizer/param shards)
  model — tensor / expert / head parallelism

``make_local_mesh`` builds a ``DeviceMesh`` over the ranks of the default
process group.  Where there is none it starts a world of one rank from an
in-process ``HashStore`` (NCCL for tensors on the card, gloo for tensors
on the host): no environment variable and no network port.  A multi-rank
run starts its group itself (``torch.distributed.init_process_group``
with its address, world size and rank) before it builds the mesh.

``make_production_mesh`` builds the dry-run's meshes, ``(16, 16)`` or
``(2, 16, 16)``, over a *fake* world of 256 or 512 ranks that
``fake_world`` starts in this process: the group hallucinates its
collectives and moves no data, so one process sees rank 0's program.
``fake_world`` destroys the group on exit, so no other mesh of the port
finds it.  ``HW`` holds the H100's rates that the roofline divides by.
"""
from __future__ import annotations

import atexit
import contextlib
import math

import torch
import torch.distributed as dist

from repro_torch.benchmarks import bounds
from repro_torch.compat import DeviceMesh, init_device_mesh

__all__ = ["make_production_mesh", "make_local_mesh", "fake_world",
           "production_shape", "world_size", "HW"]

_PRODUCTION = {False: ((16, 16), ("data", "model")),
               True: ((2, 16, 16), ("pod", "data", "model"))}


def production_shape(*, multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the single- or the multi-pod mesh."""
    return _PRODUCTION[bool(multi_pod)]


def _is_fake() -> bool:
    return dist.is_initialized() and dist.get_backend() == "fake"


@contextlib.contextmanager
def fake_world(n: int):
    """A fake default process group of ``n`` ranks, this process rank 0,
    for as long as the block runs (torch's ``fake`` backend and store:
    every collective returns at once and moves nothing).  Raises if a
    default group is already up."""
    if dist.is_initialized():
        raise RuntimeError("fake_world: a default process group is already "
                           "up in this process")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n))
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    """The production ``DeviceMesh``: ``(16, 16)`` over ``("data",
    "model")``, or ``(2, 16, 16)`` over ``("pod", "data", "model")``, of
    ``device``'s type, on the fake world that ``fake_world(256)`` (or
    ``fake_world(512)``) holds up."""
    shape, names = production_shape(multi_pod=multi_pod)
    n = math.prod(shape)
    if not (_is_fake() and dist.get_world_size() == n):
        raise RuntimeError(f"make_production_mesh: run it inside "
                           f"fake_world({n})")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=names)


class HW:
    """The H100 SXM's per-card constants the roofline uses, under the
    reference's names (its table holds a TPU's): dense bf16 tensor-core
    FLOP/s, HBM bytes/s, NVLink bytes/s per direction, device memory, and
    shared memory per SM.  All come from ``benchmarks.bounds``."""

    PEAK_BF16_FLOPS = bounds.TENSOR_FP16_FLOPS     # FLOP/s
    HBM_BW = bounds.MEM_BPS                        # B/s
    ICI_BW = bounds.ICI_BW                         # B/s per direction
    HBM_BYTES = bounds.HBM_BYTES
    VMEM_BYTES = bounds.VMEM_BYTES


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
    if _is_fake():
        raise RuntimeError("make_local_mesh: the default group is a fake "
                           "world (fake_world), not real ranks")
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
