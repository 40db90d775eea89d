"""Threefry-2x32 and the uniform draw of ``jax.random`` on numpy uint32
(the algorithm of jax/_src/prng.py), so the port draws the same bits from a
seed as the reference without importing it.

``uniform(fold_in(prng_key(seed), salt), n)`` equals
``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), salt),
(n,))`` under ``jax_threefry_partitionable=True`` (the default of the jax
the reference is tested with): bits for element i come from hashing the
counter pair (0, i); a float32 draw xors the two output words, a float64
draw (jax's default float type under x64) joins them into 64 bits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Key = Tuple[np.uint32, np.uint32]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: Key, x0: np.ndarray, x1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The 20-round Threefry-2x32 hash of counter words (x0, x1) under key."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed that fits 32 bits."""
    return np.uint32(0), np.uint32(seed & 0xFFFFFFFF)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    y0, y1 = threefry2x32(key, np.zeros(1, np.uint32), np.full(1, data & 0xFFFFFFFF, np.uint32))
    return y0[0], y1[0]


def random_bits(key: Key, n: int, width: int = 32) -> np.ndarray:
    """``width`` (32 or 64) random bits for each of n elements, in the
    partitionable layout."""
    hi = np.zeros(n, np.uint32)
    lo = np.arange(n, dtype=np.uint64).astype(np.uint32)
    b0, b1 = threefry2x32(key, hi, lo)
    if width == 64:
        return (b0.astype(np.uint64) << np.uint64(32)) | b1.astype(np.uint64)
    return b0 ^ b1


def uniform(key: Key, n: int, dtype=np.float32) -> np.ndarray:
    """Draws in [0, 1) of dtype (float32 or float64): the top mantissa bits
    as a number in [1, 2), less 1."""
    if np.dtype(dtype) == np.float64:
        bits = (random_bits(key, n, 64) >> np.uint64(12)) | np.uint64(0x3FF0000000000000)
        return np.maximum(0.0, bits.view(np.float64) - 1.0)
    bits = (random_bits(key, n) >> np.uint32(9)) | np.uint32(0x3F800000)
    return np.maximum(np.float32(0.0), bits.view(np.float32) - np.float32(1.0))
