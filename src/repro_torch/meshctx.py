"""Ambient-mesh activation sharding (the port of ``repro.meshctx``).

Model code calls ``shard_act(x, 'batch', 'seq', None)`` with *logical*
axis names.  While a mesh and rules are active (set by the launcher with
``use_mesh_rules``), a ``DTensor`` is redistributed to the placements the
rules map those names to; a plain tensor, or any tensor without a mesh,
passes through unchanged.  So the same model code runs on one card and
on a mesh of ranks.

A spec is a tuple with one entry per tensor dimension: ``None``
(replicated), one mesh-axis name, or a tuple of names (that dimension
split over several mesh axes, the first the major one).  It equals
``tuple(jax.sharding.PartitionSpec(...))`` entry for entry, including
JAX's normalisation of a 1-tuple to its name and of ``()`` to ``None``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.compat import DTensor, Replicate, Shard

__all__ = ["use_mesh_rules", "shard_act", "current_mesh", "current_rules",
           "logical_to_spec", "spec_placements", "mesh_axes"]

_state = threading.local()


def current_mesh():
    return getattr(_state, "mesh", None)


def current_rules() -> dict:
    return getattr(_state, "rules", {})


@contextlib.contextmanager
def use_mesh_rules(mesh, rules: dict):
    """Activate (mesh, logical->mesh-axis rules) on this thread."""
    prev = (current_mesh(), current_rules())
    _state.mesh = mesh
    _state.rules = dict(rules)
    try:
        yield
    finally:
        _state.mesh, _state.rules = prev


def _entry(a):
    if isinstance(a, (tuple, list)):
        a = tuple(a)
        if len(a) == 0:
            return None
        if len(a) == 1:
            return a[0]
    return a


def logical_to_spec(axes, rules: dict) -> tuple:
    """Map logical axis names to a spec through the rules table.

    A rule value may be a mesh axis name, a tuple of mesh axes, or None.
    Unknown logical names map to None (replicated).
    """
    return tuple(_entry(rules.get(a)) if a is not None else None
                 for a in axes)


def mesh_axes(mesh) -> tuple[tuple, dict]:
    """(axis names, {name: size}) of a ``DeviceMesh`` or of a record with
    ``axis_names`` and a ``shape`` dict (how the rules are checked at
    production sizes without that many ranks)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), dict(zip(names, tuple(mesh.shape)))
    return tuple(mesh.axis_names), dict(mesh.shape)


def spec_placements(mesh, spec: tuple) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on every
    mesh dimension that tensor dimension ``d`` names, ``Replicate()``
    elsewhere.  One mesh axis named twice raises ``ValueError``, as JAX's
    ``NamedSharding`` does.  DTensor splits a dimension over several mesh
    dimensions in mesh order, major first, so a tensor dimension's axes
    must be named in that order (JAX's major-to-minor); another order
    raises ``ValueError``."""
    names, _ = mesh_axes(mesh)
    out: list = [Replicate()] * len(names)
    seen: set = set()
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        dims = []
        for a in group:
            if a in seen:
                raise ValueError(
                    f"mesh axis {a!r} is named twice in spec {spec}")
            if a not in names:
                raise ValueError(f"spec {spec} names {a!r}, which is not "
                                 f"an axis of the mesh {names}")
            seen.add(a)
            dims.append(names.index(a))
        if dims != sorted(dims):
            raise ValueError(
                f"spec {spec} splits dimension {d} over {group}, not in the "
                f"mesh's order {names}")
        for m in dims:
            out[m] = Shard(d)
    return out


def shard_act(x: torch.Tensor, *axes) -> torch.Tensor:
    """Constrain activation sharding by logical axis names: a ``DTensor``
    is redistributed to the active rules' placements; a plain tensor, or
    any tensor without an active mesh, is returned as it is.  Never
    changes a value."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_spec(axes, current_rules())
    return x.redistribute(mesh, spec_placements(mesh, spec))
