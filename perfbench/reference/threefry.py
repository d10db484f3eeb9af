"""Threefry-2x32 (Salmon et al., SC 2011; 20 rounds), frozen for the
benchmark's reference.

The detector draws its write errors from JAX's counter-based stream: a key
is two uint32 words; ``split`` hashes the counters (0, 0) and (0, 1) into
the next key and a subkey; a draw of ``n`` words hashes the counters
(0, i) for i < n under the subkey and xors the two output words.  A
Bernoulli(p) sample takes the top 23 bits ``m`` of such a word and is true
iff ``m * 2**-23 < p`` with ``p`` a float32.

Two spellings: numpy ``uint32`` (wraps by itself) for the key chain on the
host, and torch ``int64`` with a 32-bit mask for the counters a chunk
needs, on any device.
"""
from __future__ import annotations

import numpy as np
import torch

ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
M32 = 0xFFFFFFFF


def hash_np(k0, k1, c0, c1):
    """Threefry-2x32 of counters ``(c0, c1)`` under key ``(k0, k1)``; numpy
    uint32 arrays that broadcast together."""
    k0, k1, c0, c1 = (np.asarray(a, np.uint32) for a in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(PARITY))
    x0, x1 = c0 + ks[0], c1 + ks[1]
    for block in range(5):
        for r in ROT[block % 2]:
            x0 = x0 + x1
            x1 = ((x1 << np.uint32(r)) | (x1 >> np.uint32(32 - r))) ^ x0
        x0 = x0 + ks[(block + 1) % 3]
        x1 = x1 + ks[(block + 2) % 3] + np.uint32(block + 1)
    return x0, x1


def key_chain(seeds, n_chunks: int) -> np.ndarray:
    """``(lanes, n_chunks, 2)`` uint32 subkeys: a lane's key starts as
    ``(0, seed)`` and each chunk splits it into the next key and that
    chunk's subkey."""
    seeds = np.asarray(seeds, np.int64)
    k0 = np.zeros(seeds.shape, np.uint32)
    k1 = (seeds & M32).astype(np.uint32)
    zero = np.zeros_like(k0)
    subs = np.zeros((len(seeds), n_chunks, 2), np.uint32)
    with np.errstate(over="ignore"):
        for c in range(n_chunks):
            n0, n1 = hash_np(k0, k1, zero, zero)
            s0, s1 = hash_np(k0, k1, zero, zero + np.uint32(1))
            subs[:, c, 0], subs[:, c, 1] = s0, s1
            k0, k1 = n0, n1
    return subs


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & M32


def words_torch(k0, k1, counter):
    """The xor of the two output words for counters ``(0, counter)``:
    int64 tensors holding uint32 values, broadcasting together."""
    k0, k1, counter = torch.broadcast_tensors(k0, k1, counter)
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = k0.clone()
    x1 = (counter + ks[1]) & M32
    for block in range(5):
        for r in ROT[block % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(block + 1) % 3]) & M32
        x1 = (x1 + ks[(block + 2) % 3] + block + 1) & M32
    return x0 ^ x1


