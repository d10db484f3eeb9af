"""K1, the fused chunk step: CUDA launcher and its plain PyTorch version.

One call folds one chunk of events into B lanes at once:

  STCF keep and SAE scatter-max -> TOS patch update of the kept events
  -> BER write errors (when ``bits`` is given) -> per-event LUT score
     ``where(keep, lut[y, x], -inf)`` (the ``lut_ready`` gate stays outside)

``fused_step_cuda`` launches ``csrc/fused_step.cu`` (the port of the TPU
kernel ``repro.kernels.fused_step.fused_chunk_step_call``; the source says
how it is built from event-parallel closed forms).  ``fused_step_ref`` is
the same function composed from the plain core ops, lane by lane.  Outputs
are new tensors; the inputs are left as they were.

Shapes (B lanes, H x W surface, E events per chunk): tos ``(B,H,W)`` uint8,
sae ``(B,H,W)`` int32, lut ``(B,H,W)`` float32, xy ``(B,E,2)`` int32,
ts ``(B,E)`` int32 (chunk-relative), valid ``(B,E)`` bool, ber ``(B,)``
float32, bits ``(B,H,W)`` int32.  Returns ``(tos, sae, keep, scores)``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ber as ber_mod
from repro_torch.core import harris as harris_mod
from repro_torch.core import stcf as stcf_mod
from repro_torch.core import tos as tos_mod
from repro_torch.kernels import _build

__all__ = ["fused_step_ref", "fused_step_cuda", "MAX_EVENTS"]

MAX_EVENTS = 8192   # the TOS pass stages a lane's events in shared memory


def fused_step_ref(tos, sae, lut, xy, ts, valid, ber=None, bits=None, *,
                   patch, th, support, tw, stcf_enabled):
    """Plain version: ``stcf_step`` -> ``tos_update_batched`` ->
    ``apply_write_errors`` -> LUT read, per lane."""
    outs = []
    for b in range(tos.shape[0]):
        sae_b, keep = stcf_mod.stcf_step(
            sae[b], xy[b], ts[b], valid[b], enabled=stcf_enabled,
            support=support, tw=tw,
        )
        tos_b = tos_mod.tos_update_batched(tos[b], xy[b], keep,
                                           patch=patch, th=th)
        if bits is not None:
            tos_b = ber_mod.apply_write_errors(tos_b, bits[b], ber[b])
        scores = harris_mod.score_events(lut[b], xy[b], keep)
        outs.append((tos_b, sae_b, keep, scores))
    return tuple(torch.stack(parts) for parts in zip(*outs))


def _lib():
    lib = _build.load("fused_step")
    fn = lib.fused_step_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def fused_step_cuda(tos, sae, lut, xy, ts, valid, ber=None, bits=None, *,
                    patch, th, support, tw, stcf_enabled):
    """Launch K1 on the tensors' CUDA device and current stream."""
    device = tos.device
    if device.type != "cuda":
        raise ValueError(f"fused_step_cuda needs CUDA tensors, got {device}")
    b, h, w = tos.shape
    e = xy.shape[1]
    if not 1 <= e <= MAX_EVENTS:
        raise ValueError(f"chunk of {e} events; K1 takes 1..{MAX_EVENTS}")
    if patch % 2 != 1 or not 1 <= patch <= 31:
        raise ValueError(f"patch must be odd in [1, 31], got {patch}")
    if h >= 2**15 or w >= 2**16:
        raise ValueError(f"surface {h}x{w} too large for packed coordinates")
    _check(tos, "tos", torch.uint8, (b, h, w), device)
    _check(sae, "sae", torch.int32, (b, h, w), device)
    _check(lut, "lut", torch.float32, (b, h, w), device)
    _check(xy, "xy", torch.int32, (b, e, 2), device)
    _check(ts, "ts", torch.int32, (b, e), device)
    _check(valid, "valid", torch.bool, (b, e), device)
    if bits is not None:
        _check(bits, "bits", torch.int32, (b, h, w), device)
        _check(ber, "ber", torch.float32, (b,), device)

    tos_out = torch.empty_like(tos)
    sae_out = torch.empty_like(sae)
    keep = torch.empty((b, e), dtype=torch.bool, device=device)
    scores = torch.empty((b, e), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib()(
            tos.data_ptr(), tos_out.data_ptr(), sae.data_ptr(),
            sae_out.data_ptr(), lut.data_ptr(), xy.data_ptr(),
            ts.data_ptr(), valid.data_ptr(),
            None if bits is None else bits.data_ptr(),
            None if bits is None else ber.data_ptr(),
            keep.data_ptr(), scores.data_ptr(),
            b, h, w, e, patch, th, support, tw, int(stcf_enabled), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_step_launch failed: CUDA error {err}")
    return tos_out, sae_out, keep, scores
