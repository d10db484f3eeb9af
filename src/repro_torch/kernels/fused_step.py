"""K1, the fused chunk step: CUDA launcher and its plain PyTorch version.

One call folds one chunk of events into B lanes at once:

  STCF keep and SAE scatter-max -> TOS patch update of the kept events
  -> BER write errors (when ``bits`` is given) -> per-event LUT score
     ``where(keep, lut[y, x], -inf)`` (the ``lut_ready`` gate stays outside)

``fused_step_cuda_`` launches ``csrc/fused_step.cu`` (the port of the TPU
kernel ``repro.kernels.fused_step.fused_chunk_step_call``; the source
describes its two passes): it updates ``tos`` and ``sae`` in place, and an
optional ``(B,)`` bool ``mask`` leaves the inactive lanes' surfaces
untouched (no patch, no SAE scatter, no BER).  ``fused_step_ref_`` is the
same in-place function composed from the plain core ops, lane by lane.
``fused_step_cuda`` / ``fused_step_ref`` are the functional spellings:
they step clones and leave their inputs as they were.  Keep and scores are
computed for every lane, masked or not.

Shapes (B lanes, H x W surface, E events per chunk): tos ``(B,H,W)`` uint8,
sae ``(B,H,W)`` int32, lut ``(B,H,W)`` float32, xy ``(B,E,2)`` int32,
ts ``(B,E)`` int32 (chunk-relative), valid ``(B,E)`` bool, ber ``(B,)``
float32, bits ``(B,H,W)`` int32, mask ``(B,)`` bool.  Every spelling
returns ``(tos, sae, keep, scores)``; the in-place ones return the tensors
they were given as ``tos`` and ``sae``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ber as ber_mod
from repro_torch.core import harris as harris_mod
from repro_torch.core import stcf as stcf_mod
from repro_torch.core import tos as tos_mod
from repro_torch.kernels import _build

__all__ = ["fused_step_ref", "fused_step_ref_", "fused_step_cuda",
           "fused_step_cuda_", "MAX_EVENTS"]

MAX_EVENTS = 8192   # the tile pass stages a lane's events in shared memory


def fused_step_ref_(tos, sae, lut, xy, ts, valid, ber=None, bits=None, *,
                    mask=None, patch, th, support, tw, stcf_enabled,
                    update=tos_mod.tos_update_batched):
    """Plain version, in place: ``stcf_step`` -> ``update`` (the TOS
    update, ``tos_update_batched`` unless given) -> ``apply_write_errors``
    -> LUT read, per lane; the active lanes' new surfaces are copied into
    ``tos`` and ``sae``."""
    keeps, scores = [], []
    for b in range(tos.shape[0]):
        sae_b, keep = stcf_mod.stcf_step(
            sae[b], xy[b], ts[b], valid[b], enabled=stcf_enabled,
            support=support, tw=tw,
        )
        keeps.append(keep)
        scores.append(harris_mod.score_events(lut[b], xy[b], keep))
        if mask is not None and not bool(mask[b]):
            continue
        tos_b = update(tos[b], xy[b], keep, patch=patch, th=th)
        if bits is not None:
            tos_b = ber_mod.apply_write_errors(tos_b, bits[b], ber[b])
        tos[b].copy_(tos_b)
        sae[b].copy_(sae_b)
    return tos, sae, torch.stack(keeps), torch.stack(scores)


def fused_step_ref(tos, sae, *args, **kw):
    """Plain version on clones of ``tos`` and ``sae``."""
    return fused_step_ref_(tos.clone(), sae.clone(), *args, **kw)


def _lib():
    lib = _build.load("fused_step")
    fn = lib.fused_step_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_step_cuda_(tos, sae, lut, xy, ts, valid, ber=None, bits=None, *,
                     mask=None, patch, th, support, tw, stcf_enabled):
    """Launch K1 on the tensors' CUDA device and current stream, updating
    ``tos`` and ``sae`` in place."""
    device = tos.device
    if device.type != "cuda":
        raise ValueError(f"fused_step_cuda_ needs CUDA tensors, got {device}")
    b, h, w = tos.shape
    e = xy.shape[1]
    if not 1 <= e <= MAX_EVENTS:
        raise ValueError(f"chunk of {e} events; K1 takes 1..{MAX_EVENTS}")
    if patch % 2 != 1 or not 1 <= patch <= 31:
        raise ValueError(f"patch must be odd in [1, 31], got {patch}")
    if h >= 2**15 or w >= 2**15:
        raise ValueError(f"surface {h}x{w} too large for packed coordinates")
    _build.check_tensor(tos, "tos", torch.uint8, (b, h, w), device)
    _build.check_tensor(sae, "sae", torch.int32, (b, h, w), device)
    _build.check_tensor(lut, "lut", torch.float32, (b, h, w), device)
    _build.check_tensor(xy, "xy", torch.int32, (b, e, 2), device)
    _build.check_tensor(ts, "ts", torch.int32, (b, e), device)
    _build.check_tensor(valid, "valid", torch.bool, (b, e), device)
    if bits is not None:
        _build.check_tensor(bits, "bits", torch.int32, (b, h, w), device)
        _build.check_tensor(ber, "ber", torch.float32, (b,), device)
    if mask is not None:
        _build.check_tensor(mask, "mask", torch.bool, (b,), device)

    if xy.data_ptr() % 8:
        xy = xy.clone()   # the kernel reads (x, y) as one 8-byte word
    keep = torch.empty((b, e), dtype=torch.bool, device=device)
    scores = torch.empty((b, e), dtype=torch.float32, device=device)
    # One packed 8-byte record per event, from the first pass to the second.
    rec = torch.empty((b, e + e % 2, 2), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib()(
            tos.data_ptr(), sae.data_ptr(), lut.data_ptr(), xy.data_ptr(),
            ts.data_ptr(), valid.data_ptr(),
            None if bits is None else bits.data_ptr(),
            None if bits is None else ber.data_ptr(),
            None if mask is None else mask.data_ptr(),
            keep.data_ptr(), scores.data_ptr(), rec.data_ptr(),
            b, h, w, e, patch, th, support, tw, int(stcf_enabled), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_step_launch failed: CUDA error {err}")
    return tos, sae, keep, scores


def fused_step_cuda(tos, sae, *args, **kw):
    """K1 on clones of ``tos`` and ``sae``: new surfaces, inputs unchanged."""
    return fused_step_cuda_(tos.clone(), sae.clone(), *args, **kw)
