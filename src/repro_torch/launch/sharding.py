"""Sharding rules for the LM scaffold and host staging for the pool's
uploads (the port of ``repro.launch.sharding``).

The LM half maps logical axis names onto mesh axes, per architecture
family, as the reference does: TP on 'model', DP (+pod) on the batch,
FSDP ('embed' over 'data') when ``fsdp``, experts on 'model' (EP) where
they divide it, and KV heads, heads or the vocabulary replicated where
they do not.  ``param_shardings`` / ``batch_shardings`` /
``cache_shardings`` turn a tree into ``Sharding`` records (mesh, spec,
DTensor placements); ``Sharding.place`` distributes a tensor by them.
The rules read a mesh's axis names and sizes through
``repro_torch.meshctx.mesh_axes``, so a ``DeviceMesh`` and a record of
production sizes (``axis_names``, a ``shape`` dict) give the same rules.

The serving pool's lane mesh is a 1-D ``('lanes',)`` mesh over the local
devices.  The pool is one process driving every local card, as the
reference's pool is, so the mesh is not a ``DeviceMesh`` (one device per
rank) but a ``LaneMesh`` record of its devices.  Lane ``i`` lives at a fixed
offset of the lane-stacked state, so membership churn moves nothing, and
the detector step has no cross-lane term, so the sharded pool needs no
collectives.  ``lane_put`` splits a lane-stacked tree into one tree per
shard; its inverse ``_lane_gather`` puts the lanes back in global order.

``HostStager`` is a ring of ``depth`` pinned (page-locked) host slabs.
``put`` packs one block's arrays into the next slab, starts one
asynchronous copy to the device on the current stream, and records a CUDA
event after it; before a slab is written again the stager waits on that
event, so an upload still in flight never has its source pages
overwritten.  ``depth`` is the pump's stage-ahead window.  On a CPU device
``put`` returns plain copies and nothing is pinned.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.compat import distribute_tensor
from repro_torch.meshctx import logical_to_spec, mesh_axes, spec_placements
from repro_torch.models.common import ModelConfig, tree_map

__all__ = ["make_rules", "param_shardings", "batch_shardings",
           "cache_shardings", "data_axes", "Sharding", "HostStager",
           "LaneMesh", "local_lane_mesh", "lane_padded_capacity",
           "lane_spec", "lane_put", "pinned_host_sharding"]

_ALIGN = 16      # bytes; every array starts aligned in the slab


class HostStager:
    """Pinned-host staging of H2D uploads (see the module docstring).

    ``uploads`` counts the arrays staged.
    """

    def __init__(self, device=None, *, depth: int = 2):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self.device = torch.device("cuda" if device is None else device)
        self._pinned = pinned_host_sharding(self.device) is not None
        self.depth = int(depth)
        self._slabs: list[Optional[torch.Tensor]] = [None] * self.depth
        self._events: list[Optional[torch.cuda.Event]] = [None] * self.depth
        self._next = 0
        self.uploads = 0

    @property
    def pinned(self) -> bool:
        """True iff uploads actually stage through pinned host memory."""
        return self._pinned

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


# ---------------------------------------------------------------------------
# The serving pool's lane mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LaneMesh:
    """A 1-D ``('lanes',)`` mesh: one shard of lanes per entry of
    ``devices`` (a device may repeat).  ``axis_names`` and ``shape`` read
    as the LM meshes' records do (``meshctx.mesh_axes``)."""

    devices: tuple

    @property
    def axis_names(self) -> tuple:
        return ("lanes",)

    @property
    def shape(self) -> dict:
        return {"lanes": len(self.devices)}


def local_lane_mesh(n_devices: Optional[int] = None, *,
                    device="cuda") -> LaneMesh:
    """The lane mesh over the local devices of ``device``'s type: every
    card (or the first ``n_devices``) for ``cuda``, one shard for ``cpu``.
    Asking for a card where there is none, or for more devices than there
    are, raises; nothing falls back to the CPU."""
    kind = torch.device(device).type
    if kind == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a lane mesh over CUDA devices asked for but "
                               "no CUDA device is available")
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        devs = [torch.device("cpu")]
    else:
        raise ValueError(f"no lane mesh over {kind!r} devices")
    if n_devices is not None:
        if not 1 <= int(n_devices) <= len(devs):
            raise ValueError(f"{n_devices} devices asked for, {len(devs)} "
                             f"local {kind} device(s)")
        devs = devs[:int(n_devices)]
    return LaneMesh(tuple(devs))


def lane_padded_capacity(capacity: int, mesh) -> int:
    """Physical lane count: ``capacity`` rounded up so the lane axis splits
    evenly across the mesh (the padding lanes ride along masked)."""
    n = mesh.shape["lanes"]
    return ((int(capacity) + n - 1) // n) * n


def lane_spec(lane_axis: int = 0) -> tuple:
    """The spec placing dimension ``lane_axis`` on the 'lanes' axis, every
    other dimension replicated (``tuple`` of the reference's
    ``PartitionSpec``)."""
    return (None,) * int(lane_axis) + ("lanes",)


def _tree_map(fn, *trees):
    """``fn`` over the leaves of equal-structured trees of named tuples,
    tuples, lists and dicts (tensors, arrays and scalars are leaves)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, (tuple, list)):
        parts = [_tree_map(fn, *z) for z in zip(*trees)]
        return type(t)(*parts) if hasattr(t, "_fields") else type(t)(parts)
    return fn(*trees)


def _ndim(leaf) -> int:
    return leaf.dim() if isinstance(leaf, torch.Tensor) else np.ndim(leaf)


def lane_put(mesh, tree, lane_axis: int = 0) -> tuple:
    """A lane-stacked tree split into one tree per shard: shard ``j`` owns
    lanes ``[j*per, (j+1)*per)`` along ``lane_axis``, its tensors copied to
    ``mesh.devices[j]`` (host arrays stay on the host, copied).  A leaf with
    ``ndim <= lane_axis`` is copied whole to every shard (the reference's
    ``P()``)."""
    n = mesh.shape["lanes"]

    def part(leaf, j, device):
        if _ndim(leaf) <= lane_axis:
            sl = ...
        else:
            size = leaf.shape[lane_axis]
            if size % n:
                raise ValueError(f"{size} lanes do not split over {n} "
                                 f"shards")
            per = size // n
            sl = (slice(None),) * lane_axis + (slice(j * per,
                                                     (j + 1) * per),)
        if isinstance(leaf, torch.Tensor):
            return leaf[sl].to(device, copy=True,
                               memory_format=torch.contiguous_format)
        if isinstance(leaf, np.ndarray):
            return np.array(leaf[sl])
        return leaf

    return tuple(_tree_map(lambda leaf: part(leaf, j, dev), tree)
                 for j, dev in enumerate(mesh.devices))


def _lane_gather(shards, lane_axis: int = 0):
    """``lane_put``'s inverse: one tree holding every shard's lanes in
    global order (tensors on the first shard's device, host arrays on the
    host); a leaf with ``ndim <= lane_axis`` is the first shard's."""
    def cat(first, *rest):
        if _ndim(first) <= lane_axis:
            return first
        if isinstance(first, torch.Tensor):
            return torch.cat([first, *(x.to(first.device) for x in rest)],
                             lane_axis)
        return np.concatenate([first, *rest], lane_axis)

    return _tree_map(cat, *shards)


def pinned_host_sharding(device) -> Optional[torch.device]:
    """Where ``HostStager`` pins its slabs for uploads to ``device``: the
    CUDA device itself (page-locked host memory the CUDA runtime maps for
    it), or ``None`` for a non-CUDA device or where CUDA is not available
    (the reference's probe answers ``None`` on the CPU too)."""
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return None
    return device


# ---------------------------------------------------------------------------
# The LM scaffold's rules
# ---------------------------------------------------------------------------


def data_axes(mesh) -> tuple:
    """The mesh axes carrying the batch: ('pod','data') or ('data',)."""
    names, _ = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


@dataclass(frozen=True)
class Sharding:
    """A tensor's layout on a mesh: its spec (one entry per dimension, as
    ``meshctx.logical_to_spec``) and the matching DTensor placements."""

    mesh: object
    spec: tuple
    placements: tuple

    def place(self, x: torch.Tensor):
        """``x`` distributed over the mesh by this layout (a ``DTensor``);
        every rank passes the same full tensor."""
        return distribute_tensor(x, self.mesh, list(self.placements))


def _sharding(mesh, spec: tuple) -> Sharding:
    return Sharding(mesh, spec, tuple(spec_placements(mesh, spec)))


def make_rules(cfg: ModelConfig, mesh, *, fsdp: bool = True,
               global_batch: Optional[int] = None,
               overrides: Optional[dict] = None) -> dict:
    """Logical-axis -> mesh-axis rules for (cfg, mesh).

    ``global_batch``: when given, the batch axes shrink to the largest prefix
    of ('pod','data') whose product divides it (batch=1 long-context decode
    replicates the batch instead of failing to shard).
    """
    _, size = mesh_axes(mesh)
    batch = data_axes(mesh)
    if global_batch is not None:
        chosen = []
        prod = 1
        for a in batch:
            if global_batch % (prod * size[a]) == 0:
                chosen.append(a)
                prod *= size[a]
        batch = tuple(chosen)
    model_size = size.get("model", 1)

    rules: dict = {
        # --- activations ---------------------------------------------------
        "batch": batch,
        "seq": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "expert": "model",       # EP
        "expert_cap": batch,     # token groups stay data-sharded
        # --- params ----------------------------------------------------------
        "embed": "data" if fsdp else None,     # FSDP shard axis
        "embed2": "model",                     # concat-input projections (TP)
        "layers": None,
        "head_dim": None,
        "q_lora": None,
        "kv_lora": None,
        # SSM
        "inner": "model",
        "inner_all": "model",
        "ssm_heads": None,
    }

    # Experts take the model axis (EP); the expert FF dim then stays local.
    # If experts don't divide the axis, fall back to TP inside experts.
    rules["expert_mlp"] = None
    if cfg.n_experts and cfg.n_experts % model_size != 0:
        rules["expert"] = None
        rules["expert_mlp"] = "model"
    # MQA / small-KV: replicating KV heads beats padding the axis.
    if 0 < cfg.n_kv < model_size:
        rules["kv_heads"] = None
    # Heads not divisible by the model axis (e.g. qwen2-0.5b's 14 heads):
    # replicate them and keep TP on the MLP only.
    if cfg.n_heads and cfg.n_heads % model_size != 0:
        rules["heads"] = None
    if cfg.vocab % model_size != 0:
        rules["vocab"] = None

    if overrides:
        rules.update(overrides)
    return rules


def param_shardings(mesh, axes_tree, rules: dict):
    """Tree of logical-axes tuples -> tree of ``Sharding``s."""
    return tree_map(lambda axes: _sharding(mesh, logical_to_spec(axes, rules)),
                    axes_tree)


def batch_shardings(mesh, batch_tree, rules: dict):
    """Input batches: leading dim on the batch axes, rest replicated."""
    batch = rules.get("batch")

    def one(leaf):
        nd = len(leaf.shape)
        if nd == 0:
            return _sharding(mesh, ())
        return _sharding(mesh, logical_to_spec(("batch",) + (None,) * (nd - 1),
                                               {"batch": batch}))

    return tree_map(one, batch_tree)


def cache_shardings(mesh, cache_tree, rules: dict, cfg: ModelConfig):
    """Decode caches: (layers/sites, batch, ...) -> batch on axis 1; the
    kv-head axis (if present and sharded) follows the rules.  ``enc_out``
    (whisper's encoder output) is the one un-stacked leaf: batch-first."""
    r = {"batch": rules.get("batch"), "kv": rules.get("kv_heads")}

    def one(path, leaf):
        nd = len(leaf.shape)
        if "enc_out" in "/".join(path):
            axes = ("batch",) + (None,) * (nd - 1)
        elif nd >= 4 and cfg.n_kv and leaf.shape[-2] == cfg.n_kv:
            axes = (None, "batch") + (None,) * (nd - 4) + ("kv", None)
        elif nd >= 2:
            axes = (None, "batch") + (None,) * (nd - 2)
        else:
            axes = ()
        return _sharding(mesh, logical_to_spec(axes, r))

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, (*path, str(k))) for k, v in tree.items()}
        return one(path, tree)

    return walk(cache_tree, ())
