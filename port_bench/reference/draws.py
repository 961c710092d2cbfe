"""Counter-based draws of ``jax.random`` (threefry2x32, partitionable
mode) in numpy ``uint32`` arithmetic, frozen here for the benchmark's
plain reference.

The system under test draws its per-item crop offsets, angles, flips and
enhance factors from the same functions of the item seeds; the reference
works them out again from the seeds with this copy, which imports nothing
of the system.  ``uniform`` rounds ``floats * (maxval - minval) + minval``
once, as the fused multiply-add of a jitted JAX draw does.
"""

from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def _rotl(x, d: int):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 (20 rounds) of counters (x1, x2) under key (k1, k2)."""
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


def prng_key(seed):
    """``jax.random.PRNGKey`` of integer seeds in [0, 2**64): [..., 2]."""
    s = np.asarray(seed).astype(np.uint64)
    return np.stack([(s >> np.uint64(32)).astype(_U32),
                     (s & np.uint64(0xFFFFFFFF)).astype(_U32)], axis=-1)


def split(key, num: int = 2):
    """``jax.random.split``: [..., 2] -> [..., num, 2]."""
    key = np.asarray(key, _U32)
    b1, b2 = threefry2x32(key[..., 0, None], key[..., 1, None], 0,
                          np.arange(num, dtype=_U32))
    return np.stack([b1, b2], axis=-1)


def random_bits(key, shape=()):
    """32 random bits an element: [..., 2] -> [..., *shape] uint32."""
    key = np.asarray(key, _U32)
    shape = tuple(shape)
    counts = np.arange(math.prod(shape), dtype=_U32).reshape(shape)
    expand = (...,) + (None,) * len(shape)
    b1, b2 = threefry2x32(key[..., 0][expand], key[..., 1][expand], 0,
                          counts)
    return b1 ^ b2


def randint(key, shape, minval, maxval):
    """``jax.random.randint`` with int32 output, array bounds broadcast."""
    key = np.asarray(key, _U32)
    shape = tuple(shape)
    lim = np.iinfo(np.int32)
    lo = np.clip(np.asarray(minval, np.int64), lim.min, lim.max)
    hi = np.clip(np.asarray(maxval, np.int64), lim.min, lim.max)
    keys = split(key)
    higher = random_bits(keys[..., 0, :], shape).astype(np.uint64)
    lower = random_bits(keys[..., 1, :], shape).astype(np.uint64)
    span = np.where(hi <= lo, 1, (hi - lo) & 0xFFFFFFFF).astype(np.uint64)
    mult = ((np.uint64(1 << 16) % span) ** 2 & np.uint64(0xFFFFFFFF)) % span
    offset = ((higher % span) * mult & np.uint64(0xFFFFFFFF)) + lower % span
    offset = (offset & np.uint64(0xFFFFFFFF)) % span
    return ((lo + offset.astype(np.int64) + (1 << 31)) % (1 << 32)
            - (1 << 31)).astype(np.int32)


def _fma_f32(a, b, c):
    """float32 ``a*b + c`` rounded once (round to odd in float64 first)."""
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
