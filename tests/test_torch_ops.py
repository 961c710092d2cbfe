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
from torch_port_data import blur_differs_under_jit, jax_box_weights

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


# -- filter bounds, masks with per-item extents -------------------------------

def test_gimp_scale_and_rescale_filter_match_jax():
    for bound in ((0, 0, 0), (360, 100, 100), (121, 30, 45.5), (7, 33.3, 1)):
        assert tcolor.gimp_to_cv_hsv(bound) == jcolor.gimp_to_cv_hsv(bound)
    for bad in ((361, 0, 0), (0, 101, 0), (0, 0, -1)):
        with pytest.raises(ValueError, match="GIMP range"):
            tcolor.gimp_to_cv_hsv(bad)
    for filt, gimp in (((10, 20, 30, 180, 255, 255), False),
                       ((100, 30, 45, 240, 100, 99.5), True),
                       ((0, 0, 0, 360, 100, 100), True)):
        assert tcolor.rescale_filter(filt, gimp) \
            == jcolor.rescale_filter(filt, gimp)
    with pytest.raises(ValueError, match="OpenCV range"):
        tcolor.rescale_filter((0, 0, 0, 181, 255, 255))
    with pytest.raises(ValueError, match=r"GIMP.*range"):
        tcolor.rescale_filter((0, 0, 0, 180, 101, 50), True)


@pytest.mark.parametrize("n_filters", [1, 2, 5])
def test_color_mask_alpha_with_per_item_extents_matches_jax(n_filters):
    rng = np.random.default_rng(30 + n_filters)
    B, H, W = 6, 40, 56
    img = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    hs = rng.integers(1, H + 1, B).astype(np.int32)
    ws = rng.integers(1, W + 1, B).astype(np.int32)
    lowers = rng.uniform(0, 120, (n_filters, 3)).astype(np.float32)
    uppers = lowers + rng.uniform(20, 140, (n_filters, 3)).astype(np.float32)
    zones = rng.integers(0, 12, (n_filters, 4)).astype(np.int32)
    zones[0] = 0
    want = np.asarray(jax.vmap(lambda im, h, w: jcolor.color_mask_alpha(
        im, h, w, lowers, uppers, zones))(jnp.asarray(img), hs, ws))
    got = tcolor.color_mask_alpha(_t(img), _t(hs), _t(ws), lowers, uppers,
                                  zones).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got == 255).any()


# -- F8: contrast and its mean on padded canvases -----------------------------

def test_exact_mean_with_mask_matches_jax_on_ties():
    rng = np.random.default_rng(6)
    B, H, W = 8, 12, 20
    lum = rng.integers(0, 256, (B, H, W)).astype(np.int32)
    hs = rng.integers(1, H + 1, B).astype(np.int32)
    ws = rng.integers(1, W + 1, B).astype(np.int32)
    hs[0], ws[0] = 2, 1   # two pixels: means on .5 exactly
    lum[0, :2, 0] = (10, 11)
    mask = np.stack([np.asarray(jgeo.valid_mask(h, w, H, W))
                     for h, w in zip(hs, ws)])
    n = np.maximum(mask.reshape(B, -1).sum(1), 1)
    want = [int(jphoto.exact_mean_round_half_up(
        jnp.asarray(l), int(k), mask=jnp.asarray(m)))
        for l, k, m in zip(lum, n, mask)]
    got = tphoto.exact_mean_round_half_up(_t(lum), _t(n), _t(mask)).tolist()
    assert got == want and got[0] == 11


@pytest.mark.parametrize("seed", [0, 1])
def test_contrast_with_extents_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, H, W = 6, 32, 48
    img = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    hs = rng.integers(1, H + 1, B).astype(np.int32)
    ws = rng.integers(1, W + 1, B).astype(np.int32)
    hs[0], ws[0] = H, W
    fac = rng.uniform(0.7, 1.3, B).astype(np.float32)
    want = np.stack([np.asarray(jphoto.contrast(jnp.asarray(im), f, h, w))
                     for im, f, h, w in zip(img, fac, hs, ws)])
    got = tphoto.contrast(_t(img), _t(fac), _t(hs), _t(ws)).numpy()
    np.testing.assert_array_equal(got, want)
    # without extents the whole canvas counts, as before
    np.testing.assert_array_equal(
        tphoto.contrast(_t(img), _t(fac)).numpy(),
        np.stack([np.asarray(jphoto.contrast(jnp.asarray(im), f))
                  for im, f in zip(img, fac)]))


# -- gaussian_blur ------------------------------------------------------------

def blur_sigmas(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.uniform(0.5, 3.0, n).astype(np.float32),
        np.linspace(0.5, 3.0, 1001, dtype=np.float32),
        np.asarray([0.5, 1.0, 1.5, 2.0, 3.0], np.float32)])


def test_box_weights_equal_the_eager_jax_constants_on_200000_sigmas():
    sig = blur_sigmas(200_000)
    with jax.disable_jit():
        want = [np.asarray(v) for v in jax_box_weights(sig)]
    got = tphoto.box_weights(sig)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))
    # the tap weights of every sigma sum to 2**24 (or one less: fw halves)
    r, ww, fw = got
    total = (2 * r + 1) * ww + 2 * fw
    assert set(np.unique((1 << 24) - total)) <= {0, 1}


def test_box_weights_against_jitted_jax_is_a_documented_delta():
    """F5: under jit XLA computes sigma^2/3 as a multiply by a reciprocal
    and contracts sigma2 - (l+1)^2 into a fused multiply-add, so ww (and fw
    with it) moves by at most 2 for a few percent of sigmas; r never
    moves.  Items of a jitted JAX run whose sigma is one of these are the
    ones the engine tests name."""
    sig = blur_sigmas(200_000)
    jr, jww, jfw = (np.asarray(v) for v in jax.jit(jax_box_weights)(sig))
    r, ww, fw = tphoto.box_weights(sig)
    np.testing.assert_array_equal(r, jr)
    delta = np.abs(ww - jww.astype(np.int64))
    assert delta.max() <= 2
    assert 0.01 < (delta > 0).mean() < 0.10
    named = blur_differs_under_jit(sig)
    assert ((delta > 0) <= named).all() and named.mean() < 0.10


def test_box_radius_bound_matches_jax():
    for sigma in (0.5, 1.0, 2.9, 3.0, 5.0, 12.5):
        for passes in (1, 3, 4):
            assert tphoto.box_radius_bound(sigma, passes) \
                == jphoto.box_radius_bound(sigma, passes)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gaussian_blur_matches_jax_eager_on_padded_canvases(seed):
    rng = np.random.default_rng(seed)
    B, H, W = 6, 40, 56
    img = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    hs = rng.integers(1, H + 1, B).astype(np.int32)
    ws = rng.integers(1, W + 1, B).astype(np.int32)
    hs[0], ws[0] = 1, 1
    sig = rng.uniform(0.5, 3.0, B).astype(np.float32)
    mr = tphoto.box_radius_bound(3.0)
    with jax.disable_jit():
        want = np.stack([np.asarray(jphoto.gaussian_blur(
            jnp.asarray(im), s, max_radius=mr, h=h, w=w, sigma_max=3.0))
            for im, s, h, w in zip(img, sig, hs, ws)])
        whole = np.stack([np.asarray(jphoto.gaussian_blur(
            jnp.asarray(im), s)) for im, s in zip(img, sig)])
    got = tphoto.gaussian_blur(_t(img), sig, max_radius=mr, h=_t(hs),
                               w=_t(ws), sigma_max=3.0)
    np.testing.assert_array_equal(got.numpy(), want)
    # no extents, the default window, sigma as a CPU tensor
    np.testing.assert_array_equal(
        tphoto.gaussian_blur(_t(img), _t(sig)).numpy(), whole)


@pytest.mark.parametrize("shape", [(1, 1), (3, 70), (64, 48), (57, 96)])
@pytest.mark.parametrize("channels", [1, 3])
def test_gaussian_blur_equals_pillow(shape, channels):
    """The independent check: PIL.ImageFilter.GaussianBlur itself, byte for
    byte, on seeded images and sigmas in and beyond the enhance range."""
    from PIL import Image, ImageFilter

    rng = np.random.default_rng(shape[0] * 100 + shape[1] + channels)
    sigmas = [0.5, 1.0, 2.0, 3.0, 5.0, 8.25] + [
        float(np.float32(s)) for s in rng.uniform(0.5, 3.0, 12)]
    img = rng.integers(0, 256, (len(sigmas), *shape, channels), np.uint8)
    want = np.stack([np.asarray(Image.fromarray(
        im[..., 0] if channels == 1 else im).filter(
            ImageFilter.GaussianBlur(s))).reshape(*shape, channels)
        for im, s in zip(img, sigmas)])
    got = tphoto.gaussian_blur(_t(img), np.asarray(sigmas, np.float32))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != img).any() or shape == (1, 1)


def test_gaussian_blur_validates_its_tap_window():
    img = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="sigma_max=3.0 needs"):
        tphoto.gaussian_blur(img, 1.0, max_radius=2, sigma_max=3.0)
    with pytest.raises(ValueError, match="sigma=20.0 needs"):
        tphoto.gaussian_blur(img, np.float32([20.0]))
    with pytest.raises(ValueError):
        jphoto.gaussian_blur(jnp.zeros((8, 8, 3), jnp.uint8), 1.0,
                             max_radius=2, sigma_max=3.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_enhance_matches_jax_eager(seed):
    """The whole enhance of a batch, blur and gains per item as flagged."""
    rng = np.random.default_rng(seed)
    B, H, W = 8, 32, 48
    img = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    hs = rng.integers(4, H + 1, B).astype(np.int32)
    ws = rng.integers(4, W + 1, B).astype(np.int32)
    f = rng.uniform(0.7, 1.3, (B, 3)).astype(np.float32)
    sig = rng.uniform(0.5, 3.0, B).astype(np.float32)
    gains = rng.uniform(0.75, 1.25, (B, 3)).astype(np.float32)
    blur = np.arange(B) % 2 == 0
    rgb = np.arange(B) % 4 < 2
    mr = tphoto.box_radius_bound(3.0)
    with jax.disable_jit():
        want = np.stack([np.asarray(jphoto.enhance(
            jnp.asarray(img[i]), hs[i], ws[i], f[i, 0], f[i, 1], f[i, 2],
            sig[i], bool(blur[i]), jnp.asarray(gains[i]), bool(rgb[i]),
            blur_max_radius=mr, blur_sigma_max=3.0)) for i in range(B)])
    got = tphoto.enhance(_t(img), _t(hs), _t(ws), _t(f[:, 0]), _t(f[:, 1]),
                         _t(f[:, 2]), sig, _t(blur), _t(gains), _t(rgb),
                         blur_max_radius=mr, blur_sigma_max=3.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_border_crop_matches_jax():
    rng = np.random.default_rng(9)
    B, H, W = 6, 32, 48
    img = rng.integers(1, 256, (B, H, W, 3), np.uint8)
    hs = rng.integers(12, H + 1, B).astype(np.int32)
    ws = rng.integers(12, W + 1, B).astype(np.int32)
    yy, xx = np.mgrid[0:H, 0:W]
    img *= ((yy[None] < hs[:, None, None])
            & (xx[None] < ws[:, None, None]))[..., None]
    m = rng.integers(0, 5, (B, 4)).astype(np.int32)
    want = jax.vmap(jgeo.border_crop)(jnp.asarray(img), hs, ws, m[:, 0],
                                      m[:, 1], m[:, 2], m[:, 3])
    got = tgeo.border_crop(_t(img), _t(hs), _t(ws), *(_t(m[:, k])
                                                      for k in range(4)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the same margins for every item, as plain numbers
    got = tgeo.border_crop(_t(img), _t(hs), _t(ws), 1, 2, 3, 4)
    want = jax.vmap(lambda im, h, w: jgeo.border_crop(im, h, w, 1, 2, 3, 4))(
        jnp.asarray(img), hs, ws)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
