"""The port's threefry draws against jax.random, and the chain's per-item
draws against the JAX package's (exact: same keys, same bits, same floats)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from image_processor_pipeline_tpu.models import chains as jchains
from image_processor_pipeline_tpu_torch import random as trandom
from image_processor_pipeline_tpu_torch.models import chains as tchains

SEEDS = np.arange(10_000, dtype=np.uint32)


@pytest.fixture(scope="module")
def jkeys():
    return np.asarray(jax.vmap(jax.random.PRNGKey)(SEEDS))


def test_prng_key_matches_jax(jkeys):
    np.testing.assert_array_equal(trandom.PRNGKey(SEEDS), jkeys)


def test_prng_key_64bit_seed_words():
    key = trandom.PRNGKey(np.uint64(0x1234_5678_9ABC_DEF0))
    np.testing.assert_array_equal(key, [0x1234_5678, 0x9ABC_DEF0])
    with pytest.raises(ValueError):
        trandom.PRNGKey(-1)
    with pytest.raises(TypeError):
        trandom.PRNGKey(1.5)


@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_matches_jax(jkeys, num):
    want = np.asarray(jax.vmap(lambda k: jax.random.split(k, num))(jkeys))
    np.testing.assert_array_equal(trandom.split(jkeys, num), want)


@pytest.mark.parametrize("bounds", ["fixed", "array", "empty", "negative"])
def test_randint_matches_jax(jkeys, bounds):
    rng = np.random.default_rng(7)
    if bounds == "fixed":
        lo = np.zeros(len(SEEDS), np.int32)
        hi = np.full(len(SEEDS), 4, np.int32)
    elif bounds == "array":
        lo = rng.integers(0, 200, len(SEEDS)).astype(np.int32)
        hi = lo + rng.integers(1, 700, len(SEEDS)).astype(np.int32)
    elif bounds == "empty":
        lo = rng.integers(0, 200, len(SEEDS)).astype(np.int32)
        hi = lo - rng.integers(0, 3, len(SEEDS)).astype(np.int32)
    else:
        lo = rng.integers(-2**31, 0, len(SEEDS)).astype(np.int32)
        hi = rng.integers(-5, 2**31 - 1, len(SEEDS)).astype(np.int32)
    want = np.asarray(jax.vmap(
        lambda k, a, b: jax.random.randint(k, (), a, b))(jkeys, lo, hi))
    np.testing.assert_array_equal(trandom.randint(jkeys, (), lo, hi), want)


@pytest.mark.parametrize("lo,hi", [(1.0, 359.0), (0.7, 1.3), (0.75, 1.25)])
def test_uniform_matches_jax_bit_for_bit(jkeys, lo, hi):
    """jax.random.uniform rounds floats*(hi-lo)+lo once (XLA contracts it
    into an FMA); the port's draw equals it bit for bit."""
    want = np.asarray(jax.vmap(
        lambda k: jax.random.uniform(k, (3,), minval=lo, maxval=hi))(jkeys))
    got = trandom.uniform(jkeys, (3,), lo, hi)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_uniform_single_rounding_is_needed(jkeys):
    """A float32 multiply then add misses jax's value on some keys — the
    trap the single-rounding emulation exists for."""
    bits = trandom.random_bits(jkeys, (3,))
    floats = ((bits >> 9) | 0x3F800000).view(np.float32) - np.float32(1)
    lo, hi = np.float32(0.7), np.float32(1.3)
    naive = floats * (hi - lo) + lo
    want = trandom.uniform(jkeys, (3,), 0.7, 1.3)
    assert (naive != want).sum() > 100


@pytest.mark.parametrize("H,W,crop", [(96, 96, 64), (640, 640, 512)])
def test_crop_params_match_jax(H, W, crop):
    rng = np.random.default_rng(H)
    n = 2000
    seeds = np.arange(n, dtype=np.uint32) * 7 + 3
    xywhn = np.concatenate([rng.uniform(0.05, 0.95, (n, 2)),
                            rng.uniform(0.01, 0.6, (n, 2))],
                           axis=1).astype(np.float32)
    want = jax.vmap(lambda b, s: jchains._crop_params((H, W), b, s, crop))(
        jnp.asarray(xywhn), jnp.asarray(seeds))
    got = tchains._crop_params((H, W), xywhn, seeds, crop)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_flip_and_params_match_jax():
    seeds = np.arange(2000, dtype=np.uint32) * 13 + 1
    want_f, want_p = jax.vmap(jchains._flip_and_params)(jnp.asarray(seeds))
    got_f, got_p = tchains._flip_and_params(seeds)
    np.testing.assert_array_equal(got_f, np.asarray(want_f))
    np.testing.assert_array_equal(got_p.view(np.uint32),
                                  np.asarray(want_p).view(np.uint32))


@pytest.mark.parametrize("n,lo,hi", [(10, 1.0, 359.0), (4, 1.0, 359.0),
                                     (7, -45.0, 45.0)])
def test_uniform_vector_per_key_matches_jax(jkeys, n, lo, hi):
    """uniform(key, (n,), lo, hi) for each key, as the rotations step draws
    its angles: bit for bit against the jitted jax.random.uniform."""
    want = np.asarray(jax.jit(jax.vmap(lambda k: jax.random.uniform(
        k, (n,), minval=lo, maxval=hi)))(jkeys))
    got = trandom.uniform(jkeys, (n,), lo, hi)
    assert got.shape == (len(SEEDS), n) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_randint_with_per_item_bounds_after_split_matches_jax(jkeys):
    """The square crop's placement draws: split, then randint with each
    item's own inclusive bounds, empty ranges guarded to their lower
    bound."""
    rng = np.random.default_rng(11)
    lo = rng.integers(0, 300, len(SEEDS)).astype(np.int32)
    hi = lo + rng.integers(-40, 200, len(SEEDS)).astype(np.int32)

    def draw(key, a, b):
        kx, ky = jax.random.split(key)
        return (jax.random.randint(kx, (), a, jnp.maximum(b, a) + 1),
                jax.random.randint(ky, (), a, jnp.maximum(b, a) + 1))

    wx, wy = jax.jit(jax.vmap(draw))(jkeys, lo, hi)
    keys = trandom.split(jkeys)
    top = np.maximum(hi, lo) + 1
    np.testing.assert_array_equal(
        trandom.randint(keys[:, 0], (), lo, top), np.asarray(wx))
    np.testing.assert_array_equal(
        trandom.randint(keys[:, 1], (), lo, top), np.asarray(wy))


# -- the fused chain's per-stage keys and Bernoulli draws ---------------------

@pytest.mark.parametrize("data", [0, 1, 6, 2**31, 2**32 - 1])
def test_fold_in_matches_jax(jkeys, data):
    """fold_in(key, i), the key of stage i of a fused chain, for a batch of
    keys at once: bit for bit against the jitted jax.random.fold_in."""
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.fold_in(k, np.uint32(data))))(jkeys))
    got = trandom.fold_in(jkeys, data)
    assert got.shape == jkeys.shape and got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_fold_in_takes_one_datum_a_key(jkeys):
    data = np.random.default_rng(3).integers(0, 2**32, len(SEEDS),
                                             dtype=np.uint64)
    want = np.asarray(jax.jit(jax.vmap(jax.random.fold_in))(
        jkeys, data.astype(np.uint32)))
    np.testing.assert_array_equal(trandom.fold_in(jkeys, data), want)
    # a chain of fold_ins from PRNGKey(seed), as FusedChain derives them
    want = np.asarray(jax.jit(jax.vmap(lambda s: jax.random.fold_in(
        jax.random.fold_in(jax.random.PRNGKey(s), 2), 5)))(SEEDS))
    got = trandom.fold_in(trandom.fold_in(trandom.PRNGKey(SEEDS), 2), 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("num", [5, 7])
def test_split_shapes_of_the_enhance_draws(jkeys, num):
    """split(key, 7) (fused.py's Enhance stage) and split(key, 5) (the
    enhance step), jitted as the engines run them."""
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.split(k, num)))(jkeys))
    got = trandom.split(jkeys, num)
    assert got.shape == (len(SEEDS), num, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 0.999, 1.0])
def test_bernoulli_is_uniform_below_p_in_float32(jkeys, p):
    want = np.asarray(jax.jit(jax.vmap(
        lambda k: jax.random.uniform(k, ()) < p))(jkeys))
    got = trandom.bernoulli(jkeys, p)
    assert got.dtype == np.bool_ and got.shape == (len(SEEDS),)
    np.testing.assert_array_equal(got, want)
    if 0 < p < 1:
        assert abs(got.mean() - p) < 0.02
