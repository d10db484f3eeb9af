"""K3, stream compaction of result rows: CUDA launcher and plain version.

For each of L rows of E events, record ``j`` is ``(event index, score)`` of
the row's j-th kept event in stream order, for ``j < cap``; unused records
read ``idx=0, val=-inf``, and ``count`` is the total kept, so
``count > cap`` flags a row whose records overflowed (the pool then reads
its dense row instead).

``compact_cuda`` launches ``csrc/compact.cu`` (the port of the TPU kernel
``repro.kernels.compact.compact_slots_call``).  ``compact_ref`` is the
batched plain version of the reference oracle ``kernels/ref.compact_ref``:
a cumsum of ``keep`` scattered into ``cap + 1`` slots, the last a trash
slot for records past ``cap``.

Shapes: scores ``(L, E)`` float32, keep ``(L, E)`` bool; returns idx
``(L, cap)`` int32, val ``(L, cap)`` float32, count ``(L,)`` int32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

__all__ = ["compact_ref", "compact_cuda", "MAX_EVENTS"]

MAX_EVENTS = 8192     # the largest chunk K1 takes, hence the longest row


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


def _lib():
    fn = _build.load("compact").compact_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


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
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        err = _lib()(scores.data_ptr(), keep.data_ptr(), idx.data_ptr(),
                     val.data_ptr(), count.data_ptr(), l, e, cap, stream)
    if err != 0:
        raise RuntimeError(f"compact_launch failed: CUDA error {err}")
    return idx, val, count
