"""JAX-compatible threefry2x32 keys on the host, in numpy.

Every record seed of a round comes from a ``fold_in`` chain
(round key -> client key -> server step key -> perturbation key), so the
port must derive exactly the reference's key bits. A key is raw (2,)
uint32 data, as ``jax.random.PRNGKey`` returns it with the default
``threefry2x32`` implementation. Keys stay on the host: they are a few
bytes, and the seeds taken from them reach the kernels as arguments.

Mirrors ``jax/_src/prng.py``: ``threefry_seed``, ``threefry_fold_in``
(= threefry2x32(key, [0, data])) and the partitionable ``threefry_split``
(counter pair (0, i) for key i).
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << _U32(r)) | (x >> _U32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) over uint32 arrays."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def PRNGKey(seed: int) -> np.ndarray:
    """Raw key data of ``jax.random.PRNGKey(seed)``: [seed >> 32, seed]."""
    seed = int(seed)
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return np.array([(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF], _U32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a scalar ``data``."""
    a, b = threefry2x32(key, np.zeros(1, _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.concatenate([a, b])


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) keys."""
    a, b = threefry2x32(key, np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([a, b], axis=1)
