"""The write-error draw: CUDA launcher and its plain PyTorch version.

One call splits every lane's threefry key once and draws the lane's
per-pixel 5-bit xor masks from the sub key, as the detector step does once
a chunk when it injects write errors.

``ber_draw_ref`` is the plain version: ``prng.split`` then
``ber.write_error_bits`` of the sub key, bit-exact to ``jax.random.split``
and ``jax.random.bernoulli`` over ``(H, W, 5)``.  ``ber_draw_cuda``
launches ``csrc/ber_draw.cu``, which computes the same words in one pass
(the source gives its design and bound).  It replaces no TPU kernel: the
JAX package leaves the draw to XLA.

Shapes (B lanes, an H x W surface): key ``(B, 2)`` int64 holding the two
uint32 words, ber ``(B,)`` float32; both spellings return ``(new_key,
bits)``, new_key ``(B, 2)`` int64 and bits ``(B, H, W)`` int32 in
[0, 31], and leave ``key`` as it was.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import ber as ber_mod
from repro_torch.core import prng
from repro_torch.kernels import _build

__all__ = ["ber_draw_ref", "ber_draw_cuda", "MAX_LANES"]

MAX_LANES = 65535     # the kernel's grid puts the lanes on its y axis


def ber_draw_ref(key: torch.Tensor, shape: tuple, ber: torch.Tensor):
    """Plain version: ``prng.split`` and ``ber.write_error_bits``."""
    key, sub = prng.split(key)
    return key, ber_mod.write_error_bits(sub, tuple(shape), ber)


def _lib():
    lib = _build.load("ber_draw")
    fn = lib.ber_draw_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def ber_draw_cuda(key: torch.Tensor, shape: tuple, ber: torch.Tensor):
    """Launch the draw on the tensors' CUDA device and current stream."""
    device = key.device
    if device.type != "cuda":
        raise ValueError(f"ber_draw_cuda needs CUDA tensors, got {device}")
    b = key.shape[0]
    h, w = shape
    if not 1 <= b <= MAX_LANES:
        raise ValueError(f"{b} lanes; the draw takes 1..{MAX_LANES}")
    if h < 1 or w < 1 or h * w > 2**31 - 256:
        raise ValueError(f"surface {h}x{w} out of the draw's range")
    _build.check_tensor(key, "key", torch.int64, (b, 2), device)
    _build.check_tensor(ber, "ber", torch.float32, (b,), device)
    new_key = torch.empty((b, 2), dtype=torch.int64, device=device)
    bits = torch.empty((b, h, w), dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _lib()(key.data_ptr(), ber.data_ptr(), new_key.data_ptr(),
                     bits.data_ptr(), b, h * w, stream)
    if err != 0:
        raise RuntimeError(f"ber_draw_launch failed: CUDA error {err}")
    return new_key, bits
