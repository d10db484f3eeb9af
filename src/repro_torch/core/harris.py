"""Frame-by-frame Harris response over the TOS (``repro.core.harris``).

``harris_response`` is the plain PyTorch spelling: ``tos / 255`` as a
multiply by the float32 reciprocal of 255, a zero pad by the full halo, and
every 2-D correlation as a row-major left fold over the nonzero taps,
``out = out + tap * slice`` with a separate multiply and add.  The CUDA
kernel (``kernels/harris_conv.py``) rounds the same way, so the two agree
bit for bit.  The reference lets XLA contract the fold into fused
multiply-adds instead, so port and reference differ by a few float32 ulps
(held to ``1e-5 * max|R|``).

Not ``F.conv2d``: cuDNN runs float32 convolutions in TF32 by default.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["sobel_kernels", "harris_response", "corner_lut", "score_events",
           "harris_constants"]

DEFAULT_K = 0.04
DEFAULT_SOBEL = 5
DEFAULT_WINDOW = 5


def _pascal_row(n: int) -> np.ndarray:
    row = np.array([1.0])
    for _ in range(n - 1):
        row = np.convolve(row, [1.0, 1.0])
    return row


def sobel_kernels(size: int = DEFAULT_SOBEL) -> tuple[np.ndarray, np.ndarray]:
    """Separable extended Sobel: smooth (Pascal) x derivative (diff of Pascal)."""
    smooth = _pascal_row(size)
    deriv = np.convolve(_pascal_row(size - 1), [1.0, -1.0])
    gx = np.outer(smooth, deriv)
    gy = np.outer(deriv, smooth)
    gx = gx / np.abs(gx).sum()
    gy = gy / np.abs(gy).sum()
    return gx.astype(np.float32), gy.astype(np.float32)


def harris_constants(sobel_size: int, window_size: int, k: float) -> dict:
    """The float32 constants both spellings use: Sobel taps, the box tap
    ``1/window^2``, ``1/255`` and ``k``."""
    gx, gy = sobel_kernels(sobel_size)
    win = np.ones((window_size, window_size), np.float32) / float(
        window_size**2)
    return {
        "gx": gx, "gy": gy,
        "wtap": float(win[0, 0]),
        "inv255": float(np.float32(1.0) / np.float32(255.0)),
        "k": float(np.float32(k)),
    }


def _conv2_valid(img: torch.Tensor, ker: np.ndarray) -> torch.Tensor:
    """Valid 2-D correlation over the last two axes as a left fold."""
    kh, kw = ker.shape
    h = img.shape[-2] - kh + 1
    w = img.shape[-1] - kw + 1
    out = torch.zeros((*img.shape[:-2], h, w), dtype=torch.float32,
                      device=img.device)
    for i in range(kh):
        for j in range(kw):
            tap = float(ker[i, j])
            if tap == 0.0:
                continue
            out = out + tap * img[..., i:i + h, j:j + w]
    return out


def harris_response(
    tos: torch.Tensor,
    *,
    sobel_size: int = DEFAULT_SOBEL,
    window_size: int = DEFAULT_WINDOW,
    k: float = DEFAULT_K,
) -> torch.Tensor:
    """Harris corner response (float32), same shape as ``tos (..., H, W)``."""
    c = harris_constants(sobel_size, window_size, k)
    halo = sobel_size // 2 + window_size // 2
    img = tos.to(torch.float32) * c["inv255"]
    img = F.pad(img, (halo, halo, halo, halo))
    gx = _conv2_valid(img, c["gx"])
    gy = _conv2_valid(img, c["gy"])
    win = np.full((window_size, window_size), c["wtap"], np.float32)
    a = _conv2_valid(gx * gx, win)
    b = _conv2_valid(gy * gy, win)
    cc = _conv2_valid(gx * gy, win)
    det = a * b - cc * cc
    tr = a + b
    return det - c["k"] * tr * tr


def corner_lut(
    tos: torch.Tensor,
    *,
    sobel_size: int = DEFAULT_SOBEL,
    window_size: int = DEFAULT_WINDOW,
    k: float = DEFAULT_K,
) -> torch.Tensor:
    """The paper's name for the response: the frame-by-frame Harris
    response of the TOS is the corner LUT."""
    return harris_response(tos, sobel_size=sobel_size,
                           window_size=window_size, k=k)


def score_events(lut: torch.Tensor, xy: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Read the LUT ``(H, W)`` at each event's pixel; -inf where invalid."""
    scores = lut[xy[:, 1].long(), xy[:, 0].long()]
    return torch.where(valid, scores, torch.full_like(scores, -torch.inf))
