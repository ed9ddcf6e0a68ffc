"""JAX's default random numbers on the host, in numpy.

The front end's FM-RANSAC draws its 8-point subsets from
``jax.random.uniform(fold_in(PRNGKey(0), frame), (128, 8))`` in the JAX
package. This module computes the same numbers bit for bit, so the port
culls the same tracks: the threefry-2x32 hash (20 rounds, key schedule
with the 0x1BD11BDA parity word), keys as two uint32 words, random bits by
the partitionable scheme (the hash of a 64-bit counter split in two
words, one output word each), and floats from the top mantissa bits with
the exponent of 1.0, minus one.
"""

import numpy as np

_ROT = (np.array([13, 15, 26, 6], np.uint32), np.array([17, 29, 16, 24], np.uint32))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(x, d):
    return (x << np.uint32(d)) | (x >> np.uint32(32 - d))


def threefry_2x32(k1, k2, x0, x1):
    """The threefry-2x32 hash of the counter words (x0, x1) under the key
    (k1, k2); uint32 arrays of one shape."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, int(r)) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed as (high, low) words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([seed >> 32, seed & 0xFFFFFFFF], np.uint32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in(key, data)`` for a uint32 ``data``."""
    d = prng_key(int(data) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        y0, y1 = threefry_2x32(key[0], key[1], d[:1], d[1:])
    return np.concatenate([y0, y1])


def random_bits64(key, shape) -> np.ndarray:
    """``threefry_random_bits(key, 64, shape)``: word pairs from the
    hash of the element's flat index."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    return bits.reshape(shape)


def uniform(key, shape) -> np.ndarray:
    """``jax.random.uniform(key, shape)`` in float64 (JAX with x64 on):
    [0, 1)."""
    bits = random_bits64(key, tuple(shape))
    one = np.array(1.0, np.float64).view(np.uint64)
    floats = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    return np.maximum(floats, 0.0)


def ransac_uniforms(frame_idx: int, shape=(128, 8)) -> np.ndarray:
    """The uniforms of the FM-RANSAC draws of frame ``frame_idx``:
    ``uniform(fold_in(PRNGKey(0), frame_idx), shape)``."""
    return uniform(fold_in(prng_key(0), frame_idx), shape)
