"""The port's connected-component cleanup (ops/ccl.py) against the JAX
package's on the CPU: the same numpy masks through both, labels, sweep
counts, sizes, cleaned images and extents equal exactly (tolerance 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu.ops import ccl as jccl
from image_processor_pipeline_tpu_torch.ops import ccl as tccl


def _t(a):
    return torch.as_tensor(np.array(a))


def spiral(n=96):
    """Single 1-px-wide spiral component of geodesic length ~n²/2 (the mask
    of tests/test_ops_compose_ccl.py::test_spiral_correct_and_fast)."""
    m = np.zeros((n, n), bool)
    top, bottom, left, right = 0, n - 1, 0, n - 1
    while top <= bottom and left <= right:
        m[top, left:right + 1] = True
        m[top:bottom + 1, right] = True
        m[bottom, left:right + 1] = True
        m[top:bottom + 1, left] = True
        top += 3
        bottom -= 3
        left += 3
        right -= 3
    return m


def jax_labels(fg, **kw):
    return jax.vmap(lambda f: jccl.label_components(
        f, return_iters=True, **kw))(jnp.asarray(fg))


@pytest.mark.parametrize("seed,density", [(0, 0.45), (1, 0.55), (2, 0.7),
                                          (3, 0.2)])
@pytest.mark.parametrize("check_every", [1, 4])
def test_labels_and_sweep_counts_match_jax(seed, density, check_every,
                                           monkeypatch):
    """Whether the host looks at the "changed" flag after every sweep or
    every fourth, labels and per-item sweep counts are JAX's."""
    monkeypatch.setattr(tccl, "CHECK_EVERY", check_every)
    rng = np.random.default_rng(seed)
    fg = rng.random((5, 40, 56)) < density
    fg[0] = False                         # an empty mask: one sweep
    fg[1] = True                          # one component
    want, want_iters = jax_labels(fg)
    got, iters = tccl.label_components(_t(fg), return_iters=True)
    assert got.dtype == torch.int32 and iters.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(iters.numpy(), np.asarray(want_iters))
    assert iters[0] == 1 and (got[0] == tccl._INF).all()
    assert (got[1] == 0).all()


def test_spiral_converges_fast():
    """Pointer jumping keeps the sweeps logarithmic: the twin of
    tests/test_ops_compose_ccl.py's spiral test, with JAX's own count."""
    cv2 = pytest.importorskip("cv2")
    fg = spiral(96)
    lbl, iters = tccl.label_components(_t(fg), return_iters=True)
    want, want_iters = jccl.label_components(jnp.asarray(fg),
                                             return_iters=True)
    np.testing.assert_array_equal(lbl.numpy(), np.asarray(want))
    assert int(iters) == int(want_iters) <= 64
    _, ref = cv2.connectedComponents(fg.astype(np.uint8), connectivity=8)
    ours, theirs = lbl.numpy()[fg], ref[fg]
    pairs = {tuple(p) for p in np.stack([ours, theirs], 1)}
    assert len(pairs) == len(set(ours.tolist())) == len(set(theirs.tolist()))


@pytest.mark.parametrize("max_iters", [1, 2, 5])
def test_max_iters_cuts_the_sweeps_as_in_jax(max_iters):
    fg = spiral(48)[None]
    want, want_iters = jax_labels(fg, max_iters=max_iters)
    got, iters = tccl.label_components(_t(fg), max_iters=max_iters,
                                       return_iters=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert iters.tolist() == np.asarray(want_iters).tolist() == [max_iters]


def test_component_sizes_match_jax():
    rng = np.random.default_rng(4)
    fg = rng.random((3, 24, 32)) < 0.5
    labels = tccl.label_components(_t(fg))
    want = jax.vmap(lambda l: jccl.component_sizes(l, 24, 32))(
        jnp.asarray(labels.numpy()))
    got = tccl.component_sizes(labels, 24, 32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum(-1).tolist() == fg.reshape(3, -1).sum(-1).tolist()


def test_first_argmax_takes_the_first_maximum():
    values = torch.tensor([[0, 3, 1, 3, 3], [5, 5, 5, 5, 5], [0, 0, 0, 0, 0],
                           [1, 2, 3, 4, 9]], dtype=torch.int32)
    assert tccl.first_argmax(values).tolist() \
        == np.asarray(jnp.argmax(jnp.asarray(values.numpy()), -1)).tolist() \
        == [1, 0, 0, 4]


def rgba_batch(seed, B=6, H=40, W=56):
    """Noisy-alpha RGBA items with their own extents; item 1 has two
    components of one size (a tie), item 2 no opaque pixel."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (B, H, W, 4), np.uint8)
    img[..., 3] = np.where(rng.random((B, H, W)) > 0.45,
                           rng.integers(2, 256, (B, H, W)), 0)
    img[3, ..., 3] = np.where(img[3, ..., 3] > 0, 1, 0)  # alpha 1 is below
    img[3, 5:9, 5:9, 3] = 2                              # the threshold
    hs = rng.integers(12, H + 1, B).astype(np.int32)
    ws = rng.integers(12, W + 1, B).astype(np.int32)
    yy, xx = np.mgrid[0:H, 0:W]
    img *= ((yy[None] < hs[:, None, None])
            & (xx[None] < ws[:, None, None]))[..., None]
    img[1, ..., 3] = 0
    img[1, 2:6, 7:11, 3] = 200     # root index 2 * W + 7
    img[1, 3:7, 1:5, 3] = 255      # root index 3 * W + 1: the later root
    img[2, ..., 3] = 0
    return img, hs, ws


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("keep_large", [False, True])
def test_cleanup_and_fit_matches_jax(seed, keep_large):
    img, hs, ws = rgba_batch(seed)
    want = jax.vmap(lambda r, h, w: jccl.cleanup_and_fit(
        r, h, w, 12, keep_large_components=keep_large))(
        jnp.asarray(img), hs, ws)
    got = tccl.cleanup_and_fit(_t(img), _t(hs), _t(ws), 12,
                               keep_large_components=keep_large)
    for g, w in zip(got, want):
        assert str(g.dtype) == f"torch.{np.asarray(w).dtype}"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    out, bh, bw = (g.numpy() for g in got)
    # the tie: the component with the smaller root index stays, alone
    # unless both are large enough to be kept
    assert (bh[1], bw[1]) == ((5, 10) if keep_large else (4, 4))
    if not keep_large:
        assert (out[1, :4, :4, 3] == 200).all()
    # the empty item: extents (0, 0), nothing left
    assert (bh[2], bw[2]) == (0, 0) and not out[2].any()
    # alpha 1 is background: only the 4 x 4 block of alpha 2 survives
    assert (bh[3], bw[3]) == (4, 4)


def test_keep_largest_component_matches_jax_and_keeps_rgb():
    img, hs, ws = rgba_batch(2)
    for kw in ({}, {"alpha_threshold": 100},
               {"keep_large_components": True, "min_component_size": 6}):
        want = jax.vmap(lambda r, h, w: jccl.keep_largest_component(
            r, h, w, **kw))(jnp.asarray(img), hs, ws)
        got = tccl.keep_largest_component(_t(img), _t(hs), _t(ws), **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(got.numpy()[..., :3], img[..., :3])


def test_scalar_extents_are_the_whole_batch():
    img, _, _ = rgba_batch(3, B=4)
    want = jax.vmap(lambda r: jccl.cleanup_and_fit(r, 30, 40, 5))(
        jnp.asarray(img))
    got = tccl.cleanup_and_fit(_t(img), 30, 40, 5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
