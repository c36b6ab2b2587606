"""The JAX package's random stream, on the host (jax.random with the
threefry2x32 implementation and ``jax_threefry_partitionable`` on, the
default of the JAX version the package runs on).

The turbulence stirring (sph/hydro_turb.py) carries a JAX PRNG key: a
restart from the JAX package's dump, and a step held against the JAX
package's, need the same key chain and the same normal draws. The chain
is integer work and is reproduced exactly in numpy ``uint32`` (wrapping
additions, rotations, xors): ``prng_key``, ``split`` (the "foldlike"
split: the hash of the flat indices of the requested shape) and
``random_bits`` (the hash of the flat indices, the two output words
xored). ``uniform`` is jax.random's mantissa construction and ``normal``
is sqrt(2) erf_inv(uniform(nextafter(-1, 0), 1)) with XLA's float32
erf_inv (Giles' two 9-term polynomials); its log1p is float64's rounded
to float32, where XLA carries its own float32 approximation, so a draw
may differ from the JAX package's by a few ulp.

Nothing here reads the card: the turbulence step draws on the host and
sends the draw up with one copy, which makes the draw the same on every
device.
"""

from typing import Tuple

import numpy as np

__all__ = ["prng_key", "threefry_2x32", "split", "random_bits", "uniform", "erf_inv",
           "normal"]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``'s raw key: the seed's high and low 32
    bits (a seed of the 32-bit integer range: a zero high word and the
    seed's two's-complement low word)."""
    seed = int(seed)
    hi = (seed >> 32) & 0xFFFFFFFF if not -2**31 <= seed < 2**31 else 0
    return np.asarray([hi, seed & 0xFFFFFFFF], np.uint32)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry_2x32(k1, k2, x1: np.ndarray, x2: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key (k1, k2), elementwise: jax's ``threefry2x32_p``."""
    k1, k2 = np.uint32(k1), np.uint32(k2)
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [np.asarray(x1, np.uint32) + ks[0], np.asarray(x2, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _hash_iota(key: np.ndarray, shape) -> Tuple[np.ndarray, np.ndarray]:
    """The hash of the flat indices of ``shape`` (jax's iota_2x32_shape:
    the high and low words of each index)."""
    count = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)
    hi = (count >> np.uint64(32)).astype(np.uint32)
    lo = (count & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    b1, b2 = threefry_2x32(key[0], key[1], hi, lo)
    return b1.reshape(shape), b2.reshape(shape)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)``: (num, 2) uint32 keys."""
    b1, b2 = _hash_iota(np.asarray(key, np.uint32), (num,))
    return np.stack([b1, b2], axis=-1)


def random_bits(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.bits(key, shape, uint32)``."""
    b1, b2 = _hash_iota(np.asarray(key, np.uint32), tuple(shape))
    return b1 ^ b2


def _fma(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as XLA's CPU code contracts it: the
    product of two float32 values is exact in float64, and so is the sum
    wherever c's bits reach no lower than the product's (the normal's
    interval and the erf_inv polynomial's terms)."""
    f64 = lambda v: np.asarray(v, np.float64)
    return (f64(a) * f64(b) + f64(c)).astype(np.float32)


def uniform(key: np.ndarray, shape, minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform`` in float32: 23 random mantissa bits under
    the exponent of 1.0, minus 1, scaled into [minval, maxval) and
    clamped below at minval."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = (random_bits(key, shape) >> np.uint32(9)) | np.uint32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma(floats, hi - lo, lo))


# XLA's float32 erf_inv (Giles, "Approximating the erfinv function"): the
# coefficients for w = -log1p(-x^2) < 5 and for larger w, highest first
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """Inverse error function of float32 ``x`` in [-1, 1] (XLA's form;
    +-1 maps to +-inf)."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(np.float64(-x * x)).astype(np.float32)
        lt = w < np.float32(5.0)
        w = np.where(lt, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.where(lt, np.float32(_ERFINV_LT5[0]), np.float32(_ERFINV_GE5[0]))
        for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
            p = _fma(p, w, np.where(lt, np.float32(a), np.float32(b)))
        out = p * x
        return np.where(np.abs(x) == np.float32(1.0), x * np.float32(np.inf), out)


def normal(key: np.ndarray, shape) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = uniform(key, shape, lo, 1.0)
    return np.float32(np.sqrt(2.0)) * erf_inv(u)
