"""The dispatching wrappers the detector step calls.

``fused_step_op`` / ``fused_step_op_`` (K1, functional / in place),
``harris_response_op`` (K2), ``compact_slots_op`` and ``ring_push_op``
(K3), ``tos_update_op`` (K4-K7), ``ber_draw_op`` (the write-error draw),
``dvfs_pick_op`` and ``step_books_op`` (the step's online DVFS pick and
its books) take the tensor's device as the choice of spelling: a CPU tensor
gets the plain PyTorch version, a CUDA tensor gets the hand-written kernel
— or an error; there is no fallback from a CUDA tensor to a plain version.
Surfaces may be one ``(H, W)`` lane or a ``(B, H, W)`` batch.

Each wrapper counts its kernel launches in ``LAUNCHES`` (plain calls on the
CPU are not counted), so a run can show that its main path went through the
kernels; ``"compact"`` counts K3's ring pushes, dense and compact, and its
standalone compactions.  ``CALLS`` counts K1's, the draw's, the pick's and
the books' wrapper calls on either device (on CUDA each equals its launch
count), so K1 calls per chunk, a structural count of the cost model, and
draws per chunk read the same on the CPU.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import tos as tos_mod
from repro_torch.kernels import (ber_draw, compact, fused_step, harris_conv,
                                 step_lanes, tos_update)

__all__ = ["fused_step_op", "fused_step_op_", "harris_response_op",
           "compact_slots_op", "ring_push_op", "tos_update_op",
           "ber_draw_op", "dvfs_pick_op", "step_books_op", "centre_surface",
           "TOS_MODES", "LAUNCHES", "CALLS", "reset_launch_counts"]

# tos_update_op's modes, each with its kernel in ``kernels.tos_update``.
TOS_MODES = {"nmc": "nmc_stream", "batched": "batched_fused",
             "nmc_binned": "nmc_stream_binned",
             "batched_binned": "batched_fused_binned"}

LAUNCHES = {"fused_step": 0, "harris": 0, "compact": 0, "ber_draw": 0,
            "dvfs_pick": 0, "step_books": 0,
            **{mode: 0 for mode in TOS_MODES}}
CALLS = {"fused_step": 0, "ber_draw": 0, "dvfs_pick": 0, "step_books": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, CALLS):
        for name in counts:
            counts[name] = 0


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _fused_step(inplace, tos, sae, lut, xy, ts, valid, ber, bits, mask,
                kw):
    single = tos.dim() == 2
    if single:
        tos, sae, lut, xy, ts, valid = (
            t[None] for t in (tos, sae, lut, xy, ts, valid))
        if bits is not None:
            bits, ber = bits[None], ber.reshape(1)
        if mask is not None:
            mask = mask.reshape(1)
    if bits is not None and ber is None:
        raise ValueError("BER bits given without the ber rate")
    CALLS["fused_step"] += 1
    if _device_type(tos) == "cpu":
        fn = (fused_step.fused_step_ref_ if inplace
              else fused_step.fused_step_ref)
        out = fn(tos, sae, lut, xy, ts, valid, ber, bits, mask=mask, **kw)
    else:
        fn = (fused_step.fused_step_cuda_ if inplace
              else fused_step.fused_step_cuda)
        out = fn(tos, sae, lut, xy, ts, valid, ber, bits, mask=mask, **kw)
        LAUNCHES["fused_step"] += 1
    return tuple(t[0] for t in out) if single else out


def fused_step_op(tos, sae, lut, xy, ts, valid, ber=None, bits=None, *,
                  mask=None, patch: int = 7, th: int = 225, support: int = 2,
                  tw: int = 5000, stcf_enabled: bool = True):
    """One fused chunk step (K1): ``(new_tos, new_sae, keep, raw_scores)``;
    the inputs are left as they were.

    BER write errors are applied iff ``bits`` is given (with ``ber``, the
    per-lane float32 rate).  ``raw_scores`` is ``where(keep, lut[y, x],
    -inf)``; the caller applies the ``lut_ready`` gate.  Lanes where the
    bool ``mask`` is false keep their surfaces.
    """
    return _fused_step(False, tos, sae, lut, xy, ts, valid, ber, bits, mask,
                       dict(patch=patch, th=th, support=support, tw=tw,
                            stcf_enabled=stcf_enabled))


def fused_step_op_(tos, sae, lut, xy, ts, valid, ber=None, bits=None, *,
                   mask=None, patch: int = 7, th: int = 225,
                   support: int = 2, tw: int = 5000,
                   stcf_enabled: bool = True):
    """``fused_step_op`` updating ``tos`` and ``sae`` in place (the caller
    owns them); returns ``(tos, sae, keep, raw_scores)`` with the tensors it
    was given."""
    return _fused_step(True, tos, sae, lut, xy, ts, valid, ber, bits, mask,
                       dict(patch=patch, th=th, support=support, tw=tw,
                            stcf_enabled=stcf_enabled))


def harris_response_op(tos: torch.Tensor, *, sobel_size: int = 5,
                       window_size: int = 5, k: float = 0.04):
    """Harris response (K2) of ``(H, W)`` or ``(B, H, W)`` uint8 surfaces."""
    kw = dict(sobel_size=sobel_size, window_size=window_size, k=k)
    if _device_type(tos) == "cpu":
        return harris_conv.harris_ref(tos, **kw)
    single = tos.dim() == 2
    out = harris_conv.harris_cuda(tos[None] if single else tos, **kw)
    LAUNCHES["harris"] += 1
    return out[0] if single else out


def compact_slots_op(scores: torch.Tensor, keep: torch.Tensor, *, cap: int):
    """Pack result rows into kept-event records (K3).

    ``scores`` / ``keep`` carry any leading shape over a trailing event
    axis ``(..., E)``; returns ``(idx (..., cap) int32, val (..., cap)
    float32, count (...) int32)``: record ``j`` of a row is its j-th kept
    event in stream order, and ``count`` is the total kept (``count > cap``
    flags overflow; the records stop at ``cap``).
    """
    lead, e = tuple(scores.shape[:-1]), scores.shape[-1]
    flat_s = scores.reshape(math.prod(lead), e)
    flat_k = keep.reshape(math.prod(lead), e)
    if _device_type(scores) == "cpu":
        idx, val, cnt = compact.compact_ref(flat_s, flat_k, cap=cap)
    else:
        idx, val, cnt = compact.compact_cuda(
            flat_s.to(torch.float32).contiguous(),
            flat_k.to(torch.bool).contiguous(), cap=cap)
        LAUNCHES["compact"] += 1
    return (idx.reshape(*lead, cap), val.reshape(*lead, cap),
            cnt.reshape(lead))


def ring_push_op(ring, scores, keep, n_kept, vdd_idx, n_valid, mask):
    """Push one round's lane rows into a pool's result ring in place (K3's
    ring push; a compact ring also gets the rows' records) and advance its
    cursors; returns ``ring``.  ``scores`` / ``keep`` are ``(L, E)``,
    ``n_kept``, ``vdd_idx``, ``n_valid`` ``(L,)`` int32, ``mask`` ``(L,)``
    bool.  On CUDA this is one launch."""
    if _device_type(ring.scores) == "cpu":
        return compact.ring_push_ref(ring, scores, keep, n_kept, vdd_idx,
                                     n_valid, mask)
    compact.ring_push_cuda(ring, scores, keep, n_kept, vdd_idx, n_valid,
                           mask)
    LAUNCHES["compact"] += 1
    return ring


def centre_surface(shape, xy, valid, *, patch: int, th: int):
    """The batched modes' centre values, last writer wins, -1 where no
    valid event is centred: the reference wrapper's closed form, computed
    outside the kernel over the lane axis."""
    k_after = tos_mod._suffix_cover_counts(xy, valid, (patch - 1) // 2)
    vals = tos_mod._clamp_threshold(tos_mod.TOS_MAX - k_after, th)
    return tos_mod._scatter_last_center_value(shape, xy, valid, vals)


def tos_update_op(tos: torch.Tensor, xy: torch.Tensor, valid: torch.Tensor,
                  *, patch: int = tos_mod.DEFAULT_PATCH,
                  th: int = tos_mod.DEFAULT_TH, mode: str = "batched"):
    """Chunked TOS update of ``(H, W)`` or ``(B, H, W)`` uint8 surfaces by
    events ``xy (..., E, 2)`` int32 with ``valid (..., E)`` bool, all lanes
    in one launch: ``mode`` ``"nmc"`` (K4), ``"batched"`` (K5),
    ``"nmc_binned"`` (K6) or ``"batched_binned"`` (K7; both binned modes
    lossless, ``cap = E``).  Every mode equals the event-by-event update."""
    if mode not in TOS_MODES:
        raise ValueError(f"unknown mode {mode!r}")
    single = tos.dim() == 2
    if single:
        tos, xy, valid = tos[None], xy[None], valid[None]
    extra = ()
    if mode.startswith("batched"):
        extra = (centre_surface(tuple(tos.shape[1:]), xy, valid,
                                 patch=patch, th=th),)
    name = TOS_MODES[mode]
    if _device_type(tos) == "cpu":
        out = getattr(tos_update, f"{name}_ref")(tos, xy, valid, *extra,
                                                 patch=patch, th=th)
    else:
        out = getattr(tos_update, f"{name}_cuda")(
            tos, xy.to(torch.int32).contiguous(), valid.contiguous(), *extra,
            patch=patch, th=th)
        LAUNCHES[mode] += 1
    return out[0] if single else out


def ber_draw_op(key: torch.Tensor, shape: tuple, ber: torch.Tensor):
    """One key split and write-error draw for every lane: ``(new_key,
    bits)`` from ``key (B, 2)`` int64 and the float32 rate ``ber (B,)``;
    bits ``(B, *shape)`` int32.  On CUDA this is one launch."""
    CALLS["ber_draw"] += 1
    if _device_type(key) == "cpu":
        return ber_draw.ber_draw_ref(key, shape, ber)
    out = ber_draw.ber_draw_cuda(key.contiguous(), tuple(shape),
                                 ber.to(torch.float32).contiguous())
    LAUNCHES["ber_draw"] += 1
    return out


def dvfs_pick_op(rate, ts, valid, *, cfg, cap=None, mask=None):
    """Every lane's online DVFS pick for one chunk: ``(rate, vdd_idx, ber,
    energy_coef, latency_coef)`` from the ``dvfs.RateState`` ``rate``, the
    chunk's ``ts (B, E)`` int32 and ``valid (B, E)`` bool and the
    ``DvfsConfig`` ``cfg``; the point is clamped at ``cap`` (None, an int,
    or a ``(B,)`` int32 row) and lanes where the bool ``mask`` is false keep
    their estimator.  On CUDA this is one launch."""
    CALLS["dvfs_pick"] += 1
    if _device_type(ts) == "cpu":
        return step_lanes.dvfs_pick_ref(rate, ts, valid, cfg=cfg, cap=cap,
                                        mask=mask)
    out = step_lanes.dvfs_pick_cuda(rate, ts.contiguous(),
                                    valid.contiguous(), cfg=cfg, cap=cap,
                                    mask=mask)
    LAUNCHES["dvfs_pick"] += 1
    return out


def step_books_op(keep, kept_total, energy_pj, latency_ns, energy_coef,
                  latency_coef, mask=None):
    """The step's books after the chunk block: ``(n_kept, kept_total,
    energy_pj, latency_ns)``, every lane's kept count from ``keep (B, E)``
    and, for the lanes where the bool ``mask`` is true (all without one),
    the kept total and the float32 books advanced by it at the ``(B,)``
    coefficients; the other lanes keep theirs.  On CUDA this is one
    launch."""
    CALLS["step_books"] += 1
    if _device_type(keep) == "cpu":
        return step_lanes.step_books_ref(keep, kept_total, energy_pj,
                                         latency_ns, energy_coef,
                                         latency_coef, mask)
    out = step_lanes.step_books_cuda(keep.contiguous(), kept_total,
                                     energy_pj, latency_ns, energy_coef,
                                     latency_coef, mask)
    LAUNCHES["step_books"] += 1
    return out
