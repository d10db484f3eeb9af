"""JAX-compatible threefry2x32 in plain PyTorch.

The detector's only random stream is the BER write-error draw
(``ber.write_error_bits``).  The port carries JAX's raw ``uint32[2]`` key in
its state and reproduces ``jax.random`` bit for bit, so a port run and a
``repro`` run on the same seed corrupt the same TOS bits:

  * ``prng_key(seed)``            == ``jax.random.PRNGKey(seed)`` (x64 off)
  * ``split(key)``                == ``jax.random.split(key)`` under the
                                     default ``jax_threefry_partitionable``
  * ``bernoulli_bits(key, p, s)`` == ``jax.random.bernoulli(key, p, s)``
  * ``uniform``, ``gumbel``, ``categorical`` == ``jax.random``'s float32
    draws (``mode="low"``, jax's default), for the LM serve step's sampler

uint32 arithmetic is emulated in int64 tensors with a 32-bit mask (PyTorch
has no unsigned 32-bit arithmetic on every device).  Keys are int64 tensors
of shape ``(..., 2)`` holding the two uint32 words; every function
broadcasts over the leading key axes, so a lane-batched state draws all of
its lanes in one pass.
"""
from __future__ import annotations

import math

import torch

__all__ = ["prng_key", "split", "random_bits", "bernoulli_bits",
           "uniform", "gumbel", "categorical", "threefry2x32"]

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 block (20 rounds) on uint32 words held in int64.

    Same round and key-injection schedule as ``jax._src.prng``'s unrolled
    lowering; all four inputs broadcast together.
    """
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def prng_key(seed: int, *, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: ``[0, seed mod
    2^32]`` for a seed in the int32 range."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed {seed} is outside the int32 range")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64, device=device)


def _counts(shape: tuple, device) -> tuple[torch.Tensor, torch.Tensor]:
    """``prng.iota_2x32_shape``: the flat index as (hi, lo) uint32 words."""
    n = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    return (n >> 32).reshape(shape), (n & _MASK).reshape(shape)


def _hash(key: torch.Tensor, shape: tuple):
    """Threefry of the iota counts of ``shape`` under each leading key."""
    hi, lo = _counts(shape, key.device)
    lead = key.shape[:-1]
    expand = (1,) * len(shape)
    k1 = key[..., 0].reshape(*lead, *expand)
    k2 = key[..., 1].reshape(*lead, *expand)
    return threefry2x32(k1, k2, hi, lo)


def split(key: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``key, sub = jax.random.split(key)`` (partitionable fold-like split).

    ``key`` is ``(..., 2)``; both results have the same shape.
    """
    b1, b2 = _hash(key, (2,))
    new = torch.stack([b1, b2], dim=-1)          # (..., 2, 2)
    return new[..., 0, :], new[..., 1, :]


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32-bit ``jax.random.bits`` of ``shape`` per key: ``(..., *shape)``."""
    b1, b2 = _hash(key, tuple(shape))
    return b1 ^ b2


def bernoulli_bits(key: torch.Tensor, p: torch.Tensor,
                   shape: tuple) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode ``"low"``, float32).

    JAX draws ``u = float32(bits >> 9 | 0x3F800000) - 1``, which is exactly
    ``(bits >> 9) * 2^-23``, and returns ``u < p``.  ``p`` is a float32
    tensor with the key's leading shape.
    """
    bits = random_bits(key, shape)
    u = (bits >> 9).to(torch.float32) * (2.0 ** -23)
    p = p.to(torch.float32).reshape(*p.shape, *((1,) * len(shape)))
    return u < p


_TINY32 = float(torch.finfo(torch.float32).tiny)


def uniform(key: torch.Tensor, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``: the top
    23 bits as the mantissa of a float in [1, 2), minus 1, scaled, and
    clamped below at ``minval``; float32 throughout."""
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    u = (random_bits(key, shape) >> 9).to(torch.float32) * (2.0 ** -23)
    return torch.maximum(lo, u * (hi - lo) + lo)


def gumbel(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` in mode ``"low"``:
    ``-log(-log(uniform(key, minval=tiny, maxval=1)))``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY32, 1.0)))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32 logits
    by the Gumbel-max trick: ``argmax(gumbel + logits)`` over the last
    axis, the first index on ties."""
    noise = gumbel(key, tuple(logits.shape))
    return torch.argmax(noise + logits, dim=-1)
