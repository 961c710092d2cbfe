"""Counter-based draws, bit-exact to ``jax.random`` (jax 0.9 with
``jax_default_prng_impl=threefry2x32`` and
``jax_threefry_partitionable=True``).

Draws are O(B) scalars per batch, so they are made on the host in numpy
``uint32`` arithmetic (which wraps like XLA's) and only their results go to
the device.  The flagship chain's draws (``models/chains.py:_crop_params``,
``_flip_and_params``) are made by the native pass ``ops/native_draws.py``
(``native/ipp_draws.cpp``) where its library built; this module is its
numpy twin, which the tests hold it to bit for bit, and the chain's path
without the library.  A key is a ``uint32`` array of shape ``[..., 2]``;
every function here is vectorised over the leading key axes, so one call
draws for a whole batch of per-item keys.

``uniform`` reproduces one rounding detail of JAX on the CPU: its
``floats * (maxval - minval) + minval`` runs under ``jit`` and XLA contracts
it into a fused multiply-add, so the value is rounded ONCE.  A float32
multiply followed by an add differs on a few percent of keys; ``_fma_f32``
computes the singly-rounded value exactly.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x, d: int):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of counter pairs ``(x1, x2)`` under
    key ``(k1, k2)``; all four broadcast.  Returns the two output words."""
    k1, k2, x1, x2 = np.broadcast_arrays(
        *(np.asarray(v, _U32) for v in (k1, k2, x1, x2)))
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x0, x1 = x1 + ks[0], x2 + ks[1]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x0 = x0 + x1
                x1 = x0 ^ _rotl(x1, r)
            x0 = x0 + ks[(i + 1) % 3]
            x1 = x1 + ks[(i + 2) % 3] + _U32(i + 1)
    return x0, x1


def PRNGKey(seed):
    """``jax.random.PRNGKey`` for integer seeds in [0, 2**64): key words
    (seed >> 32, seed & 0xFFFFFFFF).  ``seed`` may be an array of seeds."""
    seed = np.asarray(seed)
    if not np.issubdtype(seed.dtype, np.integer):
        raise TypeError(f"seed must be an integer, got dtype {seed.dtype}")
    if np.any(seed < 0):
        raise ValueError("seed must be non-negative")
    s = seed.astype(np.uint64)
    return np.stack([(s >> np.uint64(32)).astype(_U32),
                     (s & np.uint64(0xFFFFFFFF)).astype(_U32)], axis=-1)


def split(key, num: int = 2):
    """``jax.random.split``: [..., 2] → [..., num, 2]."""
    key = np.asarray(key, _U32)
    counts = np.arange(num, dtype=_U32)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], 0, counts)
    return np.stack([b1, b2], axis=-1)


def fold_in(key, data):
    """``jax.random.fold_in``: a new key [..., 2] from ``key`` [..., 2] and
    the uint32 ``data`` (a number, or an array that broadcasts against the
    leading key axes): the hash of the counter pair (0, data) under
    ``key``, which is ``threefry_2x32(key, threefry_seed(data))``."""
    key = np.asarray(key, _U32)
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], 0,
                          np.asarray(data).astype(_U32))
    return np.stack([b1, b2], axis=-1)


def bernoulli(key, p):
    """The chain stages' Bernoulli draw ``jax.random.uniform(key, ()) < p``
    in float32: bool [...] for keys [..., 2]."""
    return uniform(key) < np.float32(p)


def random_bits(key, shape=()):
    """32 random bits per element: [..., 2] → [..., *shape] uint32."""
    key = np.asarray(key, _U32)
    shape = tuple(shape)
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError("at most 2**32 draws per key")
    counts = np.arange(n, dtype=_U32).reshape(shape)
    expand = (...,) + (None,) * len(shape)
    b1, b2 = threefry2x32(key[..., 0][expand], key[..., 1][expand], 0, counts)
    return b1 ^ b2


def _clip_i32(v):
    info = np.iinfo(np.int32)
    return np.clip(np.asarray(v, np.int64), info.min, info.max)


def randint(key, shape, minval, maxval):
    """``jax.random.randint`` with int32 output; ``minval``/``maxval`` may be
    arrays that broadcast against ``key.shape[:-1] + shape``."""
    key = np.asarray(key, _U32)
    shape = tuple(shape)
    lo = _clip_i32(minval)
    hi = _clip_i32(maxval)
    keys = split(key)
    higher = random_bits(keys[..., 0, :], shape).astype(np.uint64)
    lower = random_bits(keys[..., 1, :], shape).astype(np.uint64)
    # span = uint32(maxval - minval), wrapped like int32 arithmetic; 1 when
    # the range is empty so that minval comes back
    span = (hi - lo) & 0xFFFFFFFF
    span = np.where(hi <= lo, 1, span).astype(np.uint64)
    # 2**32 % span through (2**16 % span)**2 % span, as jax does; the uint32
    # product of the two remainders wraps
    mult = ((np.uint64(1 << 16) % span) ** 2 & np.uint64(0xFFFFFFFF)) % span
    offset = ((higher % span) * mult & np.uint64(0xFFFFFFFF)) + lower % span
    offset = (offset & np.uint64(0xFFFFFFFF)) % span
    return ((lo + offset.astype(np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def _fma_f32(a, b, c):
    """float32 ``a*b + c`` rounded once, as a fused multiply-add rounds it.

    The float64 product of two float32 values is exact; TwoSum gives the
    exact error of the float64 sum, and rounding that sum to odd before the
    final cast to float32 removes the double-rounding hazard (float64 has
    more than 24 + 2 significand bits)."""
    p = np.asarray(a, np.float32).astype(np.float64) * np.asarray(
        b, np.float32).astype(np.float64)
    c = np.asarray(c, np.float32).astype(np.float64)
    s = p + c
    bv = s - p
    err = (p - (s - bv)) + (c - bv)
    even = (np.asarray(s).view(np.uint64) & np.uint64(1)) == 0
    toward = np.where(err > 0, np.inf, -np.inf)
    s = np.where((err != 0) & even, np.nextafter(s, toward), s)
    return s.astype(np.float32)


def uniform(key, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform`` in float32 on [minval, maxval)."""
    bits = random_bits(key, shape)
    mant = (bits >> _U32(9)) | _U32(0x3F800000)
    floats = mant.view(np.float32) - np.float32(1.0)
    lo = np.asarray(minval, np.float32)
    hi = np.asarray(maxval, np.float32)
    return np.maximum(lo, _fma_f32(floats, hi - lo, lo))
