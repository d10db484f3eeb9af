"""K3, stream compaction of result rows, and the ring push built on it:
CUDA launchers and plain versions.

For each of L rows of E events, record ``j`` is ``(event index, score)`` of
the row's j-th kept event in stream order, for ``j < cap``; unused records
read ``idx=0, val=-inf``, and ``count`` is the total kept, so
``count > cap`` flags a row whose records overflowed (the pool then reads
its dense row instead).

``compact_cuda`` launches ``compact_kernel`` of ``csrc/compact.cu`` (the
port of the TPU kernel ``repro.kernels.compact.compact_slots_call``).
``compact_ref`` is the batched plain version of the reference oracle
``kernels/ref.compact_ref``: a cumsum of ``keep`` scattered into
``cap + 1`` slots, the last a trash slot for records past ``cap``.

Shapes: scores ``(L, E)`` float32, keep ``(L, E)`` bool; returns idx
``(L, cap)`` int32, val ``(L, cap)`` float32, count ``(L,)`` int32.

``ring_push_cuda`` pushes one round into a pool's result ring in place
with one launch of ``ring_push_kernel``: the round's lane rows go into
slot ``head`` of every leaf, a compact ring (one with ``c_idx``) also gets
the rows' records, ranked by the same device code as ``compact_kernel``,
and the kernel advances the cursors.  ``ring_push_ref`` is the plain
version: the slot writes as ``index_copy_`` and the cursor arithmetic as
tensor ops, the records from ``compact_ref``.  The ring is a
``core.state.RingState`` / ``CompactRingState`` whose ``head``, ``count``
and ``dropped`` are views of one int32 block of four (``state.ring_init``);
the fourth is the kernel's ticket, 0 between pushes.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["compact_ref", "compact_cuda", "ring_push_ref", "ring_push_cuda",
           "MAX_EVENTS"]

MAX_EVENTS = 8192     # the largest chunk K1 takes, hence the longest row

_RING_LEAVES = ("scores", "keep", "n_kept", "vdd_idx", "n_valid", "mask")


def compact_ref(scores: torch.Tensor, keep: torch.Tensor, *, cap: int):
    """Plain version: cumsum-scatter with a trash slot at ``cap``."""
    l, e = scores.shape
    k = keep.to(torch.int32)
    pos = torch.cumsum(k, -1, dtype=torch.int32) - 1
    tgt = torch.where((k > 0) & (pos < cap), pos, cap).long()
    ev = torch.arange(e, dtype=torch.int32, device=scores.device)
    idx = torch.zeros((l, cap + 1), dtype=torch.int32, device=scores.device)
    idx.scatter_(1, tgt, ev.expand(l, e))
    val = torch.full((l, cap + 1), -torch.inf, dtype=torch.float32,
                     device=scores.device)
    val.scatter_(1, tgt, scores.to(torch.float32))
    return idx[:, :cap], val[:, :cap], k.sum(-1, dtype=torch.int32)


class _Ring(ctypes.Structure):
    """``struct Ring`` of ``csrc/compact.cu``."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (*_RING_LEAVES, "cursors",
                                                "c_idx", "c_val")]
                + [(n, ctypes.c_int) for n in ("rounds", "lanes", "events",
                                               "cap")])


_FNS: dict = {}
_ARGTYPES = {
    "compact": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p],
    "ring_push": [ctypes.c_void_p] * 8,
}


def _fn(name: str):
    """``<name>_launch`` of the built library, its argtypes set once."""
    fn = _FNS.get(name)
    if fn is None:
        fn = getattr(_build.load("compact"), f"{name}_launch")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _launch(name: str, index: int, *args) -> None:
    """Call ``<name>_launch`` on device ``index``'s current stream; switch
    devices only if ``index`` is not the current one."""
    if index != torch.cuda.current_device():
        with torch.cuda.device(index):
            return _launch(name, index, *args)
    err = _fn(name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}_launch failed: CUDA error {err}")


def compact_cuda(scores: torch.Tensor, keep: torch.Tensor, *, cap: int):
    """Launch K3 on the tensors' CUDA device and current stream."""
    if scores.device.type != "cuda" or keep.device != scores.device:
        raise ValueError(f"compact_cuda needs CUDA tensors on one device, "
                         f"got {scores.device} and {keep.device}")
    if scores.dtype != torch.float32 or keep.dtype != torch.bool:
        raise TypeError("scores must be float32 and keep bool")
    if scores.dim() != 2 or keep.shape != scores.shape:
        raise ValueError(f"scores and keep must be one (L, E) shape, got "
                         f"{tuple(scores.shape)} and {tuple(keep.shape)}")
    if not (scores.is_contiguous() and keep.is_contiguous()):
        raise ValueError("scores and keep must be contiguous")
    l, e = scores.shape
    if l < 1 or not 1 <= e <= MAX_EVENTS:
        raise ValueError(f"need L >= 1 rows of 1..{MAX_EVENTS} events, got "
                         f"({l}, {e})")
    if not 1 <= cap <= e:
        raise ValueError(f"cap must be in [1, {e}], got {cap}")
    idx = torch.empty((l, cap), dtype=torch.int32, device=scores.device)
    val = torch.empty((l, cap), dtype=torch.float32, device=scores.device)
    count = torch.empty((l,), dtype=torch.int32, device=scores.device)
    _launch("compact", scores.device.index, scores.data_ptr(),
            keep.data_ptr(), idx.data_ptr(), val.data_ptr(),
            count.data_ptr(), l, e, cap)
    return idx, val, count


def ring_push_ref(ring, scores, keep, n_kept, vdd_idx, n_valid, mask, *,
                  compact_fn=compact_ref):
    """Plain version of the ring push: write the round's rows at slot
    ``ring.head`` of every leaf (a compact ring's records from
    ``compact_fn(scores, keep, cap=...)``), then advance the device
    cursors.  In place; returns ``ring``."""
    rounds = ring.scores.shape[0]
    pairs = [(ring.scores, scores), (ring.keep, keep), (ring.n_kept, n_kept),
             (ring.vdd_idx, vdd_idx), (ring.n_valid, n_valid),
             (ring.mask, mask)]
    c_idx = getattr(ring, "c_idx", None)
    if c_idx is not None:
        idx, val, _ = compact_fn(scores, keep, cap=c_idx.shape[2])
        pairs += [(c_idx, idx), (ring.c_val, val)]
    slot = ring.head.long().reshape(1)
    for buf, row in pairs:
        buf.index_copy_(0, slot, row.unsqueeze(0))
    ring.dropped.add_((ring.count == rounds).to(torch.int32))
    ring.count.add_(1).clamp_(max=rounds)
    ring.head.add_(1).remainder_(rounds)
    return ring


class _Plan:
    """A ring checked once: its kernel descriptor and what each push's
    rows must be.  Kept on the ring's ``head`` tensor; it holds the ring's
    other leaves, so the ids it was made for cannot be reused while it
    lives."""

    def __init__(self, ring):
        r, lanes, e = ring.scores.shape
        c_idx = getattr(ring, "c_idx", None)
        cap = 0 if c_idx is None else c_idx.shape[2]
        index = ring.scores.get_device()
        want = {"scores": (torch.float32, (r, lanes, e)),
                "keep": (torch.bool, (r, lanes, e)),
                **{n: (torch.int32, (r, lanes))
                   for n in ("n_kept", "vdd_idx", "n_valid")},
                "mask": (torch.bool, (r, lanes)),
                **{n: (torch.int32, ()) for n in ("head", "count",
                                                   "dropped")}}
        if c_idx is not None:
            want.update(c_idx=(torch.int32, (r, lanes, cap)),
                        c_val=(torch.float32, (r, lanes, cap)))
        for name, (dtype, shape) in want.items():
            t = getattr(ring, name)
            if (t.dtype != dtype or tuple(t.shape) != shape
                    or t.get_device() != index or not t.is_contiguous()):
                raise ValueError(
                    f"ring.{name} must be a contiguous {dtype} tensor of "
                    f"shape {shape} on the ring's device, got {t.dtype} "
                    f"{tuple(t.shape)} on {t.device}")
        if not (e >= 1 and (c_idx is None or 1 <= cap <= e)):
            raise ValueError(f"ring of {e} events with cap {cap}")
        head = ring.head.data_ptr()
        block = ring.head.untyped_storage().nbytes() - \
            ring.head.storage_offset() * 4
        if (ring.count.data_ptr(), ring.dropped.data_ptr()) != (
                head + 4, head + 8) or block < 16:
            raise ValueError("the ring's head, count and dropped must be "
                             "one int32 block of four (state.ring_init)")
        self.ids = tuple(map(id, ring))
        self.leaves = tuple(t for t in ring if t is not ring.head)
        self.index = index
        self.rows = tuple((name, want[name][0], want[name][1][1:])
                          for name in _RING_LEAVES)
        self.desc = _Ring(*(getattr(ring, n).data_ptr()
                            for n in _RING_LEAVES), head,
                          None if c_idx is None else c_idx.data_ptr(),
                          None if c_idx is None else ring.c_val.data_ptr(),
                          r, lanes, e, cap)
        self.desc_ptr = ctypes.addressof(self.desc)


def _plan(ring) -> _Plan:
    """The ring's ``_Plan``, made on its first push."""
    plan = getattr(ring.head, "_push_plan", None)
    if plan is None or plan.ids != tuple(map(id, ring)):
        plan = ring.head._push_plan = _Plan(ring)
    return plan


def _check_rows(plan: _Plan, rows) -> None:
    """O(1) checks of a round's rows against the ring's plan."""
    for t, (name, dtype, shape) in zip(rows, plan.rows):
        if (t.dtype != dtype or t.shape != shape
                or t.get_device() != plan.index or not t.is_contiguous()):
            raise ValueError(
                f"{name} must be a contiguous {dtype} tensor of shape "
                f"{shape} on the ring's device, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")


def ring_push_cuda(ring, scores, keep, n_kept, vdd_idx, n_valid, mask):
    """Push one round's rows ``scores``/``keep`` ``(L, E)``, ``n_kept``,
    ``vdd_idx``, ``n_valid`` ``(L,)`` int32 and ``mask`` ``(L,)`` bool
    into the CUDA ring ``ring`` in place, with one launch on the current
    stream; returns ``ring``."""
    plan = _plan(ring)
    if plan.index < 0:
        raise ValueError(f"ring_push_cuda needs a CUDA ring, got one on "
                         f"{ring.scores.device}")
    rows = (scores, keep, n_kept, vdd_idx, n_valid, mask)
    _check_rows(plan, rows)
    _launch("ring_push", plan.index, plan.desc_ptr,
            *(t.data_ptr() for t in rows))
    return ring
