"""The dispatching wrappers the detector step calls.

``fused_step_op`` (K1) and ``harris_response_op`` (K2) take the tensor's
device as the choice of spelling: a CPU tensor gets the plain PyTorch
version, a CUDA tensor gets the hand-written kernel — or an error; there is
no fallback from a CUDA tensor to a plain version.  Surfaces may be one
``(H, W)`` lane or a ``(B, H, W)`` batch.

Each wrapper counts its kernel launches in ``LAUNCHES`` (plain calls on the
CPU are not counted), so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import fused_step, harris_conv

__all__ = ["fused_step_op", "harris_response_op", "LAUNCHES",
           "reset_launch_counts"]

LAUNCHES = {"fused_step": 0, "harris": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _device_type(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def fused_step_op(tos, sae, lut, xy, ts, valid, ber=None, bits=None, *,
                  patch: int = 7, th: int = 225, support: int = 2,
                  tw: int = 5000, stcf_enabled: bool = True):
    """One fused chunk step (K1): ``(new_tos, new_sae, keep, raw_scores)``.

    BER write errors are applied iff ``bits`` is given (with ``ber``, the
    per-lane float32 rate).  ``raw_scores`` is ``where(keep, lut[y, x],
    -inf)``; the caller applies the ``lut_ready`` gate.
    """
    single = tos.dim() == 2
    if single:
        tos, sae, lut, xy, ts, valid = (
            t[None] for t in (tos, sae, lut, xy, ts, valid))
        if bits is not None:
            bits, ber = bits[None], ber.reshape(1)
    if bits is not None and ber is None:
        raise ValueError("BER bits given without the ber rate")
    kw = dict(patch=patch, th=th, support=support, tw=tw,
              stcf_enabled=stcf_enabled)
    if _device_type(tos) == "cpu":
        out = fused_step.fused_step_ref(tos, sae, lut, xy, ts, valid, ber,
                                        bits, **kw)
    else:
        out = fused_step.fused_step_cuda(tos, sae, lut, xy, ts, valid, ber,
                                         bits, **kw)
        LAUNCHES["fused_step"] += 1
    return tuple(t[0] for t in out) if single else out


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
