"""The reference's random numbers on the host: ``jax.random``'s threefry
keys, splits and float64 normals, in numpy.

The reference draws each step's base samples with ``jax.random.PRNGKey``,
``split`` and ``normal`` (``pint_tpu/amortized/train.py``, ``posterior.py``)
under ``jax_threefry_partitionable`` (the default of the JAX release the
reference runs on).  This module repeats them in numpy, so that a seed gives
the reference's stream bitwise on either machine:

* :func:`threefry2x32`: the Threefry-2x32 hash, 20 rounds in five groups
  of four, its key schedule and rotations (``jax/_src/prng.py``'s
  ``_threefry2x32_lowering``);
* :func:`prng_key`: a 64-bit seed split into its high and low words;
* :func:`split`: the fold-like split, the hash of the 64-bit counters 0 ..
  num - 1 (``_threefry_split_foldlike``);
* :func:`random_bits`: 64-bit words, the two hash outputs of each
  element's 64-bit counter as high and low words
  (``_threefry_random_bits_partitionable``);
* :func:`uniform`: the top 52 bits as a mantissa in [1, 2), minus 1, scaled
  and clamped below (``jax/_src/random.py``'s ``_uniform``);
* :func:`normal`: ``sqrt(2) erfinv(u)`` of a uniform in (-1, 1)
  (``_normal_real``), with :func:`erfinv` the float64 polynomial XLA
  lowers ``erf_inv`` to (Giles, "Approximating the erfinv function", the
  three branches at w = -log1p(-x^2) < 6.25, < 16 and beyond) and
  :func:`log1p` XLA's (Cephes' rational function below sqrt(2) - 1, the
  logarithm of 1 + x above), in their order of operations.  XLA's CPU
  code contracts each polynomial's multiply-add into a fused one;
  :func:`fma` repeats that with an error-free product and sum.
  ``torch.special.erfinv`` is another approximation and rounds apart.

Keys, bits and uniforms are the reference's bitwise; normals on 200000
draws were bitwise but for 4, one ulp apart (a fused multiply-add rounded
twice by the emulation, or numpy's logarithm).

The stream is made on the host whatever the training device: a (64, 89)
draw a step is small, and the bits must not depend on the machine.
"""

from __future__ import annotations

import numpy as np

__all__ = ["threefry2x32", "prng_key", "split", "random_bits", "uniform",
           "normal", "erfinv", "log1p", "fma"]

_U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x0, x1):
    """The Threefry-2x32 hash of the counter pairs ``(x0, x1)`` (uint32
    arrays of one shape) under the key ``(k1, k2)``; returns the two
    uint32 output words."""
    k1, k2 = _U32(k1), _U32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [np.asarray(x0, dtype=_U32) + ks[0],
             np.asarray(x1, dtype=_U32) + ks[1]]
        for i in range(5):
            for r in _ROT[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: (2,) uint32, the high and low words of
    the 64-bit seed."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], dtype=_U32)


def _counters(n: int):
    idx = np.arange(n, dtype=np.uint64)
    return ((idx >> np.uint64(32)).astype(_U32),
            (idx & np.uint64(0xFFFFFFFF)).astype(_U32))


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    c1, c2 = _counters(num)
    b1, b2 = threefry2x32(key[0], key[1], c1, c2)
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape) -> np.ndarray:
    """64-bit random words of ``shape`` (``jax.random.bits`` at uint64)."""
    c1, c2 = _counters(int(np.prod(shape, dtype=np.int64)))
    b1, b2 = threefry2x32(key[0], key[1], c1, c2)
    bits = (b1.astype(np.uint64) << np.uint64(32)) | b2.astype(np.uint64)
    return bits.reshape(shape)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0):
    """``jax.random.uniform(key, shape, float64, minval, maxval)``."""
    bits = random_bits(key, shape)
    one = np.array(1.0).view(np.uint64)
    floats = ((bits >> np.uint64(12)) | one).view(np.float64) - 1.0
    lo, hi = np.float64(minval), np.float64(maxval)
    return np.maximum(lo, fma(floats, hi - lo, lo))


# Giles' coefficients, highest power first, as XLA's float64 erf_inv
_W_LT_6_25 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_W_LT_16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_W_GE_16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def fma(a, b, c):
    """``a b + c`` rounded once (nearly always: the product split exactly
    by Dekker's algorithm, the sum by Knuth's, their errors added last)."""
    with np.errstate(invalid="ignore", over="ignore"):
        return _fma(a, b, c)


def _fma(a, b, c):
    p = a * b
    t = 134217729.0 * a
    ah = t - (t - a)
    al = a - ah
    t = 134217729.0 * b
    bh = t - (t - b)
    bl = b - bh
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + e)


# Cephes' log1p numerator and denominator, highest power first
_LOG1P_P = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
            6.5787325942061044846969e0, 2.9911919328553073277375e1,
            6.0949667980987787057556e1, 5.7112963590585538103336e1,
            2.0039553499201281259648e1)
_LOG1P_Q = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
            2.2176239823732856465394e2, 3.0909872225312059774938e2,
            2.1642788614495947685003e2, 6.0118660497603843919306e1)


def _horner(x, coefs):
    p = np.zeros_like(x)
    for c in coefs:
        p = fma(p, x, c)
    return p


def log1p(x) -> np.ndarray:
    """XLA's float64 ``log1p``: for |x| < sqrt(2) - 1, ``x + (-x^2 / 2 +
    x^3 P(x) / Q(x))``; else ``log(1 + x)``."""
    x = np.asarray(x, dtype=np.float64)
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_P) / _horner(x, _LOG1P_Q))
    small = x + fma(np.full_like(x, -0.5), x2, small)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(np.abs(x) < 0.41421356237309504880, small,
                        np.log(x + 1.0))


def erfinv(x) -> np.ndarray:
    """float64 inverse error function, XLA's polynomial in its order:
    ``w = -log1p(-x x)``, the branch's shifted ``w``, Horner from the
    highest coefficient, ``p x``; +-inf at +-1."""
    x = np.asarray(x, dtype=np.float64)
    w = -log1p(-x * x)
    lt6, lt16 = w < 6.25, w < 16.0
    wt = np.where(lt6, w - 3.125,
                  np.sqrt(w) - np.where(lt16, 3.25, 5.0))

    def coef(i):
        c = np.full_like(x, _W_LT_6_25[i])
        if i < 19:
            c = np.where(lt6, c, _W_LT_16[i])
        if i < 17:
            c = np.where(lt16, c, _W_GE_16[i])
        return c

    p = coef(0)
    for i in range(1, 17):
        p = fma(p, wt, coef(i))
    for i in range(17, 19):
        p = np.where(lt16, fma(p, wt, coef(i)), p)
    for i in range(19, 23):
        p = np.where(lt6, fma(p, wt, coef(i)), p)
    with np.errstate(over="ignore", invalid="ignore"):
        return np.where(np.abs(x) == 1.0, x * np.inf, p * x)


def normal(key, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float64)``."""
    lo = np.nextafter(-1.0, 0.0)
    return np.sqrt(2.0) * erfinv(uniform(key, shape, lo, 1.0))
