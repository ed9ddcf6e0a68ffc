# Frozen copy of ic_gvins_tpu_torch/common/prng.py at commit ab7fbd6, for the benchmark's plain
# reference; its relative imports resolve within this tree, and nothing else
# changed unless a note below says so. It imports nothing of the program.
"""JAX's default random numbers on the host, in numpy.

The front end's FM-RANSAC draws its 8-point subsets from
``jax.random.uniform(fold_in(PRNGKey(0), frame), (128, 8))`` in the JAX
package. This module computes the same numbers bit for bit, so the port
culls the same tracks: the threefry-2x32 hash (20 rounds, key schedule
with the 0x1BD11BDA parity word), keys as two uint32 words, random bits by
the partitionable scheme (the hash of a 64-bit counter split in two
words, one output word each), and floats from the top mantissa bits with
the exponent of 1.0, minus one. With x64 off JAX draws float32 uniforms
from one 32-bit word per element (the two output words xor-ed). Keys split
as the hash of their index (``split``). A uniform on [minval, maxval)
scales and shifts in one fused multiply-add, as XLA compiles it on the
CPU. Normals are sqrt(2) erfinv of a uniform on (-1, 1), with XLA's erfinv
polynomials (M. Giles, "Approximating the erfinv function"); they agree
with JAX's to a few units in the last place, since XLA's ``log1p`` and
numpy's round differently.
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


def _hash_index(key, shape):
    """The two hash words of every element's flat index (a 64-bit counter
    split in two words), the partitionable scheme's random bits."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(np.uint32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    with np.errstate(over="ignore"):
        return threefry_2x32(key[0], key[1], hi, lo)


def random_bits64(key, shape) -> np.ndarray:
    """``threefry_random_bits(key, 64, shape)``: the element's two hash
    words as one."""
    b1, b2 = _hash_index(key, shape)
    return ((b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)).reshape(shape)


def random_bits32(key, shape) -> np.ndarray:
    """``threefry_random_bits(key, 32, shape)``: the xor of the element's
    two hash words."""
    b1, b2 = _hash_index(key, shape)
    return (b1 ^ b2).reshape(shape)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: [num, 2] keys, key i the hash of the
    counter i."""
    b1, b2 = _hash_index(key, (int(num),))
    return np.stack([b1, b2], axis=1)


def uniform(key, shape, dtype=np.float64, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: float64
    as JAX draws it with x64 on, float32 as with x64 off (or a float32
    ``dtype``)."""
    dt = np.dtype(dtype)
    if dt == np.float32:
        bits = random_bits32(key, tuple(shape))
        one = np.array(1.0, np.float32).view(np.uint32)
        floats = ((bits >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
    else:
        bits = random_bits64(key, tuple(shape))
        one = np.array(1.0, np.float64).view(np.uint64)
        floats = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    lo, hi = dt.type(minval), dt.type(maxval)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


def _fma(a, b, c):
    """a * b + c rounded once, as XLA fuses it on the CPU: float64 by
    Dekker's exact product and Knuth's exact sum, float32 through float64
    (the product is exact there)."""
    if a.dtype == np.float32:
        return (a.astype(np.float64) * np.float64(b) + np.float64(c)).astype(np.float32)
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a * b
    split = lambda x: (lambda t: (t - (t - x), x - (t - (t - x))))(134217729.0 * x)  # noqa: E731
    (ah, al), (bh, bl) = split(a), split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl  # a * b == p + e exactly
    s = p + c
    v = s - p
    t = (p - (s - v)) + (c - v)  # p + c == s + t exactly
    return s + (t + e)


# XLA's erfinv: Giles' polynomials in w = -log1p(-x^2), for float64 in
# three branches (w < 6.25, w < 16, else), for float32 in two (w < 5)
_ERFINV64 = (
    (-3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
     1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
     6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
     2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
     1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
     4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
     0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
     0.24015818242558961693, 1.6536545626831027356),
    (2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
     1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
     2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
     6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
     0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
     -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
     3.0838856104922207635),
    (-2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
     -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
     2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
     -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
     7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
     1.0103004648645343977, 4.8499064014085844221),
)
_ERFINV32 = (
    (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
     -0.00125372503, -0.00417768164, 0.246640727, 1.50140941),
    (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
     -0.0076224613, 0.00943887047, 1.00167406, 2.83297682),
)


def _erfinv(x) -> np.ndarray:
    """The inverse error function as XLA computes it, in the dtype of
    ``x`` (float64 or float32); +-inf at +-1."""
    x = np.asarray(x)
    f = x.dtype.type
    with np.errstate(divide="ignore"):
        w = -np.log1p(-x * x)
    if x.dtype == np.float32:
        lt = w < f(5.0)
        w = np.where(lt, w - f(2.5), np.sqrt(w) - f(3.0))
        a, b = _ERFINV32
        p = np.where(lt, f(a[0]), f(b[0]))
        for i in range(1, len(a)):
            p = np.where(lt, f(a[i]), f(b[i])) + p * w
    else:
        lo, mid, hi = _ERFINV64
        lt6, lt16 = w < 6.25, w < 16.0
        w = np.where(lt6, w - 3.125, np.sqrt(w) - np.where(lt16, 3.25, 5.0))

        def coef(i):
            c = np.full(x.shape, lo[i])
            if i < len(mid):
                c = np.where(lt6, c, mid[i])
            if i < len(hi):
                c = np.where(lt16, c, hi[i])
            return c

        p = coef(0)
        for i in range(1, len(hi)):
            p = coef(i) + p * w
        for i in range(len(hi), len(mid)):
            p = np.where(lt16, coef(i) + p * w, p)
        for i in range(len(mid), len(lo)):
            p = np.where(lt6, coef(i) + p * w, p)
    with np.errstate(over="ignore"):
        return np.where(np.abs(x) == 1, x * np.finfo(x.dtype).max, p * x)


def normal(key, shape, dtype=np.float64) -> np.ndarray:
    """``jax.random.normal(key, shape, dtype)``: sqrt(2) erfinv of a
    uniform on (-1, 1), as JAX draws it (to a few units in the last
    place, see ``_erfinv``)."""
    dt = np.dtype(dtype)
    lo = np.nextafter(dt.type(-1.0), dt.type(0.0))
    u = uniform(key, shape, dt, lo, 1.0)
    return dt.type(np.sqrt(2.0)) * _erfinv(u)


def ransac_uniforms(frame_idx: int, shape=(128, 8), dtype=np.float64) -> np.ndarray:
    """The uniforms of the FM-RANSAC draws of frame ``frame_idx``:
    ``uniform(fold_in(PRNGKey(0), frame_idx), shape)`` in ``dtype``."""
    return uniform(fold_in(prng_key(0), frame_idx), shape, dtype)
