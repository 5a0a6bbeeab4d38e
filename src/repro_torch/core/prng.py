"""JAX-compatible threefry2x32 keys on the host, in numpy.

Every record seed of a round comes from a ``fold_in`` chain
(round key -> client key -> server step key -> perturbation key), so the
port must derive exactly the reference's key bits. A key is raw (2,)
uint32 data, as ``jax.random.PRNGKey`` returns it with the default
``threefry2x32`` implementation. Keys stay on the host: they are a few
bytes, and the seeds taken from them reach the kernels as arguments.

Mirrors ``jax/_src/prng.py``: ``threefry_seed``, ``threefry_fold_in``
(= threefry2x32(key, [0, data])) and the partitionable ``threefry_split``
(counter pair (0, i) for key i). Serving's temperature sampling draws
from ``random_bits``, ``uniform`` and ``gumbel``, the partitionable
``jax.random`` draws of the same names: the uniforms bit for bit, the
gumbel's two logs numpy's.
"""
from __future__ import annotations

import numpy as np

_U32 = np.uint32
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 block cipher (20 rounds) over uint32 arrays (in
    place on two new arrays: the inputs are not written)."""
    k0, k1 = _U32(key[0]), _U32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = np.asarray(x0, _U32) + ks[0]
    x1 = np.asarray(x1, _U32) + ks[1]
    t = np.empty_like(x1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 += x1
            np.left_shift(x1, _U32(r), out=t)       # x1 = rotl(x1, r) ^ x0
            x1 >>= _U32(32 - r)
            x1 |= t
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3]
        x1 += _U32(i + 1)
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


def random_bits(key, shape, bit_width: int = 32) -> np.ndarray:
    """``jax.random.bits``' words under the partitionable threefry: the
    linear index e of each element as the counter pair (e >> 32, e), the
    two outputs xor-ed, cut to ``bit_width`` (8, 16 or 32) low bits."""
    n = int(np.prod(shape, dtype=np.int64))
    e = np.arange(n, dtype=np.uint64)
    b1, b2 = threefry2x32(key, (e >> np.uint64(32)).astype(_U32),
                          e.astype(_U32))
    bits = b1 ^ b2
    if bit_width < 32:
        bits = bits & _U32((1 << bit_width) - 1)
    return bits.reshape(shape)


# (bits, mantissa bits) of the float types a draw is made in
_FLOATS = {"float32": (32, 23), "bfloat16": (16, 7)}


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bfloat16 (ties to even), as f32."""
    b = np.asarray(x, np.float32).view(_U32)
    b = (b + _U32(0x7FFF) + ((b >> _U32(16)) & _U32(1))) & _U32(0xFFFF0000)
    return b.view(np.float32)


def uniform(key, shape, dtype: str = "float32", minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)`` as f32
    numpy values (a bfloat16 draw rounded to bfloat16 after each
    operation): the mantissa bits under an exponent of 1, minus 1, scaled
    and shifted, and no less than minval."""
    nbits, nmant = _FLOATS[dtype]
    rnd = _round_bf16 if dtype == "bfloat16" else (lambda v: v)
    rng_bits = 8 if nmant < 8 else nbits
    bits = random_bits(key, shape, rng_bits)
    if dtype == "bfloat16":
        one = (bits >> _U32(rng_bits - nmant)) | _U32(0x3F80)
        floats = (one << _U32(16)).view(np.float32) - np.float32(1.0)
    else:
        one = (bits >> _U32(rng_bits - nmant)) | _U32(0x3F800000)
        floats = one.view(np.float32) - np.float32(1.0)
    lo = rnd(np.float32(minval))
    span = rnd(rnd(np.float32(maxval)) - lo)
    return np.maximum(lo, rnd(rnd(floats * span) + lo))


def gumbel(key, shape, dtype: str = "float32") -> np.ndarray:
    """``jax.random.gumbel(key, shape, dtype)`` (mode 'low'): −log(−log u)
    of a uniform on [tiny, 1), as f32 numpy values."""
    tiny = np.float32(2.0 ** -126)       # finfo.tiny of f32 and of bfloat16
    rnd = _round_bf16 if dtype == "bfloat16" else (lambda v: v)
    u = uniform(key, shape, dtype, minval=tiny, maxval=1.0)
    with np.errstate(divide="ignore"):
        return rnd(-rnd(np.log(rnd(-rnd(np.log(u))))))
