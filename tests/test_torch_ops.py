"""The port's chain ops against the JAX package's, called eagerly on the same
numpy inputs: each exact, except the shift vectors' trig (F1), which is held
to its own bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu.ops import bbox as jbbox
from image_processor_pipeline_tpu.ops import color as jcolor
from image_processor_pipeline_tpu.ops import geometry as jgeo
from image_processor_pipeline_tpu.ops import photometric as jphoto
from image_processor_pipeline_tpu_torch.ops import bbox as tbbox
from image_processor_pipeline_tpu_torch.ops import color as tcolor
from image_processor_pipeline_tpu_torch.ops import geometry as tgeo
from image_processor_pipeline_tpu_torch.ops import photometric as tphoto

ANGLES = np.asarray([0.0, 1.0, 44.99, 45.0, 45.01, 90.0, 135.0, 180.0,
                     270.0, 315.0, 358.9], np.float32)


def _t(a):
    return torch.as_tensor(np.array(a))


def test_xywhn2xyxy_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.2, 1.2, (4096, 4)).astype(np.float32)
    want = np.asarray(jbbox.xywhn2xyxy(x, jnp.float32(640), jnp.float32(480)))
    got = tbbox.xywhn2xyxy(_t(x), 640.0, 480.0).numpy()
    np.testing.assert_array_equal(got, want)


def _hsv_edge_triples():
    """Every (v, diff) pair in each hue sector and tie order."""
    v, d = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    keep = d <= v
    v, d = v[keep], d[keep]
    m = v - d
    mid = (v + m) // 2
    rows = [np.stack(c, -1) for c in (
        (v, m, m), (m, v, m), (m, m, v), (v, v, m), (v, m, v), (m, v, v),
        (v, mid, m), (m, v, mid), (mid, m, v), (v, m, mid))]
    return np.concatenate(rows).astype(np.uint8)


def test_rgb_to_hsv_u8_matches_jax():
    rng = np.random.default_rng(1)
    rgb = np.concatenate([rng.integers(0, 256, (1 << 20, 3), np.uint8),
                          _hsv_edge_triples()])[:, None, :]
    want = np.asarray(jcolor.rgb_to_hsv_u8(jnp.asarray(rgb)))
    np.testing.assert_array_equal(tcolor.rgb_to_hsv_u8(_t(rgb)).numpy(),
                                  want)


@pytest.mark.parametrize("lower,upper", [
    ((76.5, 77.5, 0.5), (100.5, 255.5, 254.5)),
    ((-0.5, 1.5, 2.5), (179.5, 300.0, 128.5)),
    ((35.0, 60.0, 60.0), (85.0, 255.0, 255.0)),
])
def test_in_range_half_way_bounds_match_jax(lower, upper):
    rng = np.random.default_rng(2)
    hsv = rng.integers(0, 256, (64, 64, 3), np.uint8)
    want = np.asarray(jcolor.in_range(jnp.asarray(hsv), lower, upper))
    got = tcolor.in_range(_t(hsv), lower, upper).numpy()
    np.testing.assert_array_equal(got, want)


def test_zone_mask_and_color_mask_alpha_match_jax():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (2, 40, 56, 3), np.uint8)
    lowers = ((35.0, 60.0, 60.0), (100.0, 40.0, 40.0), (0, 0, 0))
    uppers = ((85.0, 255.0, 255.0), (140.0, 230.0, 230.0), (20, 80.5, 99.5))
    zones = ((0, 0, 0, 0), (4, 6, 2, 3), (10, 0, 20, 0))
    for h, w in ((40, 56), (33, 50)):
        want = np.stack([np.asarray(jcolor.color_mask_alpha(
            jnp.asarray(im), h, w, lowers, uppers, zones)) for im in img])
        got = tcolor.color_mask_alpha(_t(img), h, w, lowers, uppers, zones)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tcolor.zone_mask(40, 56, h, w, 3, 4, 5, 6).numpy(),
            np.asarray(jcolor.zone_mask(40, 56, h, w, 3, 4, 5, 6)))
    np.testing.assert_array_equal(tgeo.valid_mask(7, 9, 12, 16).numpy(),
                                  np.asarray(jgeo.valid_mask(7, 9, 12, 16)))


@pytest.fixture(scope="module")
def photo_batch():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (4, 24, 40, 3), np.uint8)
    img[1] = 255                                  # saturated image
    factors = np.asarray([0.0, 0.7, 1.0, 1.3], np.float32)
    gains = rng.uniform(0.75, 1.25, (4, 3)).astype(np.float32)
    gains[0] = (-0.5, 0.0, 2.0)
    return img, factors, gains


@pytest.mark.parametrize("op", ["brightness", "contrast", "color_balance",
                                "channel_gains"])
def test_photometric_ops_match_jax(photo_batch, op):
    img, factors, gains = photo_batch
    per_item = gains if op == "channel_gains" else factors
    jfn, tfn = getattr(jphoto, op), getattr(tphoto, op)
    want = np.stack([np.asarray(jfn(jnp.asarray(im), jnp.asarray(f)))
                     for im, f in zip(img, per_item)])
    np.testing.assert_array_equal(tfn(_t(img), _t(per_item)).numpy(), want)
    # a python-float factor broadcasts over the batch
    np.testing.assert_array_equal(
        tfn(_t(img[:1]), 1.21 if op != "channel_gains"
            else (1.21, 0.8, 1.0)).numpy(),
        np.asarray(jfn(jnp.asarray(img[0]),
                       1.21 if op != "channel_gains" else
                       jnp.asarray((1.21, 0.8, 1.0))))[None])


def test_luminance_and_exact_mean_match_jax():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (5, 16, 16, 3)).astype(np.int32)
    want = np.asarray(jphoto._luminance_i32(jnp.asarray(img)))
    lum = tphoto._luminance_i32(_t(img))
    np.testing.assert_array_equal(lum.numpy(), want)
    # means exactly on .5 ties and just beside them
    lum = rng.integers(0, 256, (6, 8, 8)).astype(np.int32)
    lum[:, 0, 0] += 32 + np.arange(6) - lum.reshape(6, -1).sum(1) % 64
    lum = np.clip(lum, 0, 255)
    want = [int(jphoto.exact_mean_round_half_up(jnp.asarray(x), 64))
            for x in lum]
    got = tphoto.exact_mean_round_half_up(_t(lum), 64).tolist()
    assert got == want


def test_shift_bits_match_jax():
    for size in range(4, 2100, 7):
        assert tgeo.shift_bits_for(size) == jgeo.shift_bits_for(size)
        assert tgeo.shear13_bits_for(size) == jgeo.shear13_bits_for(size)


@pytest.mark.parametrize("axis", [0, 1])
def test_row_shift_matches_jax(axis):
    rng = np.random.default_rng(6 + axis)
    img = rng.integers(0, 256, (3, 20, 20, 3), np.uint8)
    shifts = rng.integers(-9, 10, (3, 20)).astype(np.int32)
    want = np.stack([np.asarray(jgeo._row_shift(
        jnp.asarray(im), jnp.asarray(s), axis=axis, bits=5))
        for im, s in zip(img, shifts)])
    got = tgeo._row_shift(_t(img), _t(shifts), axis=axis, bits=5)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("S", [64, 33])
def test_rotate_square_shear_given_jax_shifts(S):
    """rotate_square_shear fed JAX's own (quad, sh1, sh2) is exact."""
    rng = np.random.default_rng(S)
    img = rng.integers(0, 256, (len(ANGLES), S, S, 3), np.uint8)
    quad, sh1, sh2 = jax.vmap(lambda a: jgeo.shear_params(a, S))(
        jnp.asarray(ANGLES))
    want = np.asarray(jax.vmap(jgeo.rotate_square_shear)(
        jnp.asarray(img), jnp.asarray(ANGLES)))
    got = tgeo.rotate_square_shear_by(_t(img), _t(quad), _t(sh1), _t(sh2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_shear_params_within_f1_bound():
    """F1: float32 tan/sin differ between XLA and torch by ulps, so a shift
    may move by one where a product lands beside a .5 boundary.  Over 10^4
    angles at S=512: the quadrant agrees everywhere, at most 1e-3 of the
    angles have any shift that differs, and none differs by more than 1."""
    rng = np.random.default_rng(8)
    angles = np.concatenate([ANGLES, rng.uniform(1, 359, 10_000 - len(
        ANGLES)).astype(np.float32)])
    jq, j1, j2 = (np.asarray(a) for a in jax.vmap(
        lambda a: jgeo.shear_params(a, 512))(jnp.asarray(angles)))
    tq, t1, t2 = (a.numpy() for a in tgeo.shear_params(_t(angles), 512))
    np.testing.assert_array_equal(tq, jq)
    d1, d2 = np.abs(t1 - j1), np.abs(t2 - j2)
    assert max(d1.max(), d2.max()) <= 1
    differ = ((d1 > 0).any(1) | (d2 > 0).any(1)).mean()
    assert differ <= 1e-3, differ


# -- the engine steps' ops: bbox, geometry on padded canvases, draws ---------

def _boxes(seed, B=64, N=8):
    rng = np.random.default_rng(seed)
    xyxy = rng.uniform(-50, 700, (B, N, 4)).astype(np.float32)
    mask = rng.random((B, N)) < 0.6
    mask[0] = False
    return xyxy, mask


def test_union_shift_clip_boxes_match_jax():
    xyxy, mask = _boxes(0)
    np.testing.assert_array_equal(
        tbbox.union_box(_t(xyxy), _t(mask)).numpy(),
        np.asarray(jbbox.union_box(xyxy, mask)))
    np.testing.assert_array_equal(
        tbbox.union_box(_t(xyxy)).numpy(), np.asarray(jbbox.union_box(xyxy)))
    dx = np.arange(64, dtype=np.float32) * 3
    dy = np.arange(64, dtype=np.float32) - 7
    want = jax.vmap(jbbox.shift_boxes)(xyxy, dx, dy)
    got = tbbox.shift_boxes(_t(xyxy), _t(dx), _t(dy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    side = np.linspace(40, 640, 64).astype(np.float32)
    want = jax.vmap(lambda b, s: jbbox.clip_boxes(b, (s, s + 5)))(xyxy, side)
    got = tbbox.clip_boxes(_t(xyxy), (_t(side)[:, None],
                                      _t(side)[:, None] + 5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        tbbox.clip_boxes(_t(xyxy), (480, 640)).numpy(),
        np.asarray(jbbox.clip_boxes(xyxy, (480, 640))))


@pytest.mark.parametrize("clip", [False, True])
def test_xyxy2xywhn_matches_jax(clip):
    xyxy, _ = _boxes(1)
    w = np.linspace(33, 641, 64).astype(np.float32)
    h = np.linspace(480, 31, 64).astype(np.float32)
    with jax.disable_jit():
        want = jax.vmap(lambda b, ww, hh: jbbox.xyxy2xywhn(
            b, ww, hh, clip=clip, eps=1e-3))(xyxy, w, h)
    got = tbbox.xyxy2xywhn(_t(xyxy), _t(w)[:, None], _t(h)[:, None],
                           clip=clip, eps=1e-3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _canvases(seed, B, H, W, C):
    rng = np.random.default_rng(seed)
    hs = rng.integers(1, H + 1, B).astype(np.int32)
    ws = rng.integers(1, W + 1, B).astype(np.int32)
    img = rng.integers(0, 256, (B, H, W, C), np.uint8)
    img = np.array(jax.vmap(jgeo.apply_mask)(jnp.asarray(img), hs, ws))
    return img, hs, ws


@pytest.mark.parametrize("C", [1, 3, 4])
def test_apply_mask_and_flips_match_jax(C):
    rng = np.random.default_rng(C)
    raw = rng.integers(0, 256, (7, 40, 56, C), np.uint8)
    hs = np.asarray([1, 40, 17, 39, 2, 25, 40], np.int32)
    ws = np.asarray([56, 1, 30, 55, 2, 56, 41], np.int32)
    masked = tgeo.apply_mask(_t(raw), _t(hs), _t(ws)).numpy()
    np.testing.assert_array_equal(
        masked, np.asarray(jax.vmap(jgeo.apply_mask)(raw, hs, ws)))
    np.testing.assert_array_equal(
        tgeo.apply_mask(_t(raw), 20, 30).numpy(),
        np.asarray(jgeo.apply_mask(raw, 20, 30)))
    for sym in ("o", "h", "v", "hv"):
        want = jax.vmap(lambda i, h, w: jgeo.dihedral(i, h, w, sym))(
            masked, hs, ws)
        got = tgeo.dihedral(_t(masked), _t(hs), _t(ws), sym)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), sym)
    with pytest.raises(ValueError, match="symmetry"):
        tgeo.dihedral(_t(masked), _t(hs), _t(ws), "d")


def test_roll2_matches_jnp_roll_per_item():
    img, _, _ = _canvases(3, 5, 24, 36, 3)
    dy = np.asarray([0, 5, -7, 23, 100], np.int32)
    dx = np.asarray([-1, 0, 36, 17, -90], np.int32)
    want = jax.vmap(lambda i, a, b: jnp.roll(i, (a, b), axis=(0, 1)))(
        img, dy, dx)
    np.testing.assert_array_equal(
        tgeo.roll2(_t(img), _t(dy), _t(dx)).numpy(), np.asarray(want))


@pytest.mark.parametrize("C", [1, 3, 4])
def test_crop_bbox_and_fit_crop_match_jax(C):
    """Random content with sparse alpha; item 0 empty (the uncropped
    rule), item 1 with a negative extent (the clamp)."""
    img, hs, ws = _canvases(10 + C, 8, 48, 64, C)
    rng = np.random.default_rng(C)
    keep = rng.random(img.shape[:3]) < 0.05
    img *= keep[..., None]
    img[0] = 0
    y0 = rng.integers(0, 6, 8).astype(np.int32)
    x0 = rng.integers(0, 6, 8).astype(np.int32)
    want = jax.vmap(jgeo.crop)(img, y0, x0, hs - 6, ws - 6)
    got = tgeo.crop(_t(img), _t(y0), _t(x0), _t(hs) - 6, _t(ws) - 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for fn in ("content_bbox", "fit_crop"):
        want = jax.vmap(getattr(jgeo, fn))(img, hs, ws)
        got = getattr(tgeo, fn)(_t(img), _t(hs), _t(ws))
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 or g.dtype == torch.uint8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), fn)
    empty = np.zeros((2, 48, 64, C), np.uint8)
    ext_h, ext_w = np.asarray([30, -4], np.int32), np.asarray([20, 9], np.int32)
    want = jax.vmap(jgeo.fit_crop)(empty, ext_h, ext_w)
    got = tgeo.fit_crop(_t(empty), _t(ext_h), _t(ext_w))
    assert got[1].tolist() == [30, 0] and got[2].tolist() == [20, 9]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("angle", [0.0, 90.0, 180.0, 270.0, 360.0, 45.0,
                                   30.0, 123.4, 359.0])
def test_rotate_expand_nearest_matches_jax_eager(angle):
    """Sizes exact; pixels byte for byte (torch's and XLA's float32 cos and
    sin agree bitwise on each of these angles)."""
    img, hs, ws = _canvases(int(angle), 4, 64, 64, 4)
    hs, ws = np.minimum(hs, 40), np.minimum(ws, 44)
    img = np.array(jax.vmap(jgeo.apply_mask)(jnp.asarray(img), hs, ws))
    angles = np.full(4, angle, np.float32)
    theta = jnp.deg2rad(jnp.float32(angle))
    t = torch.tensor(angle) * tgeo._DEG2RAD
    assert float(jnp.cos(theta)) == float(torch.cos(t))
    assert float(jnp.sin(theta)) == float(torch.sin(t))
    with jax.disable_jit():
        want = jax.vmap(jgeo.rotate_expand)(img, hs, ws, angles)
    got = tgeo.rotate_expand(_t(img), _t(hs), _t(ws), _t(angles))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    h2, w2 = tgeo.rotated_size(_t(hs), _t(ws), _t(angles))
    assert h2.tolist() == got[1].tolist() and w2.tolist() == got[2].tolist()
