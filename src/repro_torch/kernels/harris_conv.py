"""K2, the Harris response: CUDA launcher and its plain PyTorch version.

``harris_cuda`` launches ``csrc/harris.cu`` (the port of the TPU kernel
``repro.kernels.harris_conv.harris_call``) over ``(B, H, W)`` uint8
surfaces.  ``harris_ref`` is the plain version, ``core.harris
.harris_response``; both round every product and sum separately in the
reference's tap order, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core import harris as harris_mod
from repro_torch.kernels import _build

__all__ = ["harris_ref", "harris_cuda", "MAX_SIZE"]

MAX_SIZE = 7          # largest Sobel / window size the kernel takes

harris_ref = harris_mod.harris_response


def _lib():
    fn = _build.load("harris").harris_launch
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p] * 2 + [ctypes.c_float] * 3
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def harris_cuda(tos: torch.Tensor, *, sobel_size: int = 5,
                window_size: int = 5, k: float = 0.04) -> torch.Tensor:
    """Launch K2 on the tensor's CUDA device and current stream."""
    if tos.device.type != "cuda":
        raise ValueError(f"harris_cuda needs a CUDA tensor, got {tos.device}")
    if tos.dtype != torch.uint8 or tos.dim() != 3 or not tos.is_contiguous():
        raise ValueError("tos must be a contiguous (B, H, W) uint8 tensor")
    for name, size in (("sobel_size", sobel_size),
                       ("window_size", window_size)):
        if size % 2 != 1 or not 1 <= size <= MAX_SIZE:
            raise ValueError(f"{name} must be odd in [1, {MAX_SIZE}]")
    c = harris_mod.harris_constants(sobel_size, window_size, k)
    gx = np.ascontiguousarray(c["gx"], np.float32)
    gy = np.ascontiguousarray(c["gy"], np.float32)
    b, h, w = tos.shape
    out = torch.empty((b, h, w), dtype=torch.float32, device=tos.device)
    with torch.cuda.device(tos.device):
        stream = torch.cuda.current_stream(tos.device).cuda_stream
        err = _lib()(
            tos.data_ptr(), out.data_ptr(), b, h, w, sobel_size, window_size,
            gx.ctypes.data, gy.ctypes.data, c["wtap"], c["inv255"], c["k"],
            stream,
        )
    if err != 0:
        raise RuntimeError(f"harris_launch failed: CUDA error {err}")
    return out
