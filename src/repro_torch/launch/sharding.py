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
The lane-mesh helpers of the reference's pool have no counterpart yet.

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
           "cache_shardings", "data_axes", "Sharding", "HostStager"]

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
