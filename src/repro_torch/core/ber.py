"""Low-voltage write errors of the NMC macro (``repro.core.ber``).

Storage code: c in [0, 31]; c == 0 encodes TOS value 0, c >= 1 encodes
224 + c.  Each stored bit of a nonzero pixel flips with probability ``ber``
on write-back; value-0 pixels skip write-back.

``write_error_bits`` draws the per-pixel 5-bit xor masks with the JAX-exact
threefry (``core.prng``), so a port run corrupts the same bits as the
reference for the same key; ``apply_write_errors`` applies them.
``inject_write_errors`` (a static rate) and ``corrupt_surface`` (the rate
of an operating voltage, ``hwmodel.ber_at``) are spellings of
``inject_write_errors_at``, so all three draw the same bits.  Both take
an optional leading lane axis: ``key (..., 2)``, ``ber (...)``,
``tos (..., H, W)``.
"""
from __future__ import annotations

import torch

from repro_torch.core import prng

__all__ = [
    "encode5",
    "decode5",
    "write_error_bits",
    "apply_write_errors",
    "inject_write_errors",
    "inject_write_errors_at",
    "corrupt_surface",
]

BASE = 224  # code 1 encodes BASE + 1 = 225 = the default threshold


def encode5(tos: torch.Tensor) -> torch.Tensor:
    """uint8 TOS -> 5-bit storage code (values below 225 collapse to 0)."""
    v = tos.to(torch.int32)
    return torch.where(v > BASE, v - BASE, torch.zeros_like(v)).to(
        torch.uint8)


def decode5(code: torch.Tensor) -> torch.Tensor:
    c = code.to(torch.int32)
    return torch.where(c > 0, c + BASE, torch.zeros_like(c)).to(torch.uint8)


def write_error_bits(key: torch.Tensor, shape: tuple,
                     ber: torch.Tensor) -> torch.Tensor:
    """Per-pixel int32 xor masks in [0, 31]: bit b of pixel p is set with
    probability ``ber`` (``jax.random.bernoulli`` over ``(*shape, 5)``)."""
    flips = prng.bernoulli_bits(key, ber, (*shape, 5))
    weights = 1 << torch.arange(5, dtype=torch.int32, device=flips.device)
    return (flips.to(torch.int32) * weights).sum(-1, dtype=torch.int32)


def apply_write_errors(tos: torch.Tensor, bits: torch.Tensor,
                       ber: torch.Tensor) -> torch.Tensor:
    """Encode, xor, decode; value-0 pixels skip write-back and ``ber == 0``
    is an exact identity select.  ``ber`` has the surface's lane shape."""
    code = encode5(tos).to(torch.int32)
    corrupted = torch.bitwise_xor(code, bits)
    out = torch.where(code > 0, corrupted, code)
    out = decode5(out.to(torch.uint8))
    on = (ber > 0).reshape(*ber.shape, 1, 1)
    return torch.where(on, out, tos)


def inject_write_errors_at(key: torch.Tensor, tos: torch.Tensor,
                           ber: torch.Tensor) -> torch.Tensor:
    """``write_error_bits`` + ``apply_write_errors`` for one write pass."""
    return apply_write_errors(
        tos, write_error_bits(key, tuple(tos.shape[-2:]), ber), ber)


def inject_write_errors(key: torch.Tensor, tos: torch.Tensor,
                        ber: float) -> torch.Tensor:
    """``inject_write_errors_at`` at a static float rate; a rate of 0 or
    less returns ``tos`` itself."""
    if ber <= 0.0:
        return tos
    return inject_write_errors_at(key, tos, _rate(ber, tos))


def corrupt_surface(key: torch.Tensor, tos: torch.Tensor,
                    vdd: float) -> torch.Tensor:
    """``inject_write_errors_at`` at the BER of operating voltage ``vdd``."""
    from repro_torch.core import hwmodel
    return inject_write_errors_at(key, tos, _rate(hwmodel.ber_at(vdd), tos))


def _rate(ber: float, tos: torch.Tensor) -> torch.Tensor:
    return torch.tensor(ber, dtype=torch.float32, device=tos.device)
