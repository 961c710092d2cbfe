"""The port's batched shear rotation (ops/rotate.py) against the JAX
package's, called on the same numpy inputs: against the Pallas kernel
_shear_kernel in interpret mode (the second launch site of
rotate_square_shear_batch) and against the XLA rotate_square_shear, byte
for byte; the wrapper's CPU path, checks and counters.  The CUDA kernel
itself is held against the plain twin on the card in test_torch_cuda.py."""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu.ops import geometry as jgeo
from image_processor_pipeline_tpu.ops.pallas import augment as jaug
from image_processor_pipeline_tpu.ops.pallas import rotate as jrot
from image_processor_pipeline_tpu_torch import interop, kernels
from image_processor_pipeline_tpu_torch.ops import augment as taug
from image_processor_pipeline_tpu_torch.ops import geometry as tgeo
from image_processor_pipeline_tpu_torch.ops import rotate as trot

BOUNDARY_ANGLES = (0.0, 44.99, 45.0, 45.01, 90.0, 135.0, 180.0, 270.0,
                   315.0, 358.9)


def rotate_batch(B, S, C, seed):
    """Images and angles: the ten boundary angles, then random ones."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, S, S, C), np.uint8)
    angles = np.asarray((BOUNDARY_ANGLES + tuple(rng.uniform(1, 359, B)))[:B],
                        np.float32)
    return imgs, angles


def jax_vectors(angles, S):
    """The shift vectors rotate_square_shear_batch computes (rotate.py:
    177-200, the formula of augment._shifts), as the port's tensors."""
    return interop.shifts_from_jax(*(np.asarray(a) for a in
                                     jaug._shifts(jnp.asarray(angles), S)))


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_matches_pallas_interpret_given_its_shifts(C):
    """_shear_kernel in interpret mode, the JAX package's own CPU path of
    rotate_square_shear_batch, equals the port byte for byte."""
    imgs, angles = rotate_batch(16, 64, C, seed=C)
    want = np.asarray(jrot.rotate_square_shear_batch(
        jnp.asarray(imgs), jnp.asarray(angles), interpret=True))
    kernels.reset_launch_counts()
    got = trot.rotate_square_shear_batch(torch.as_tensor(imgs),
                                         torch.as_tensor(angles),
                                         shifts=jax_vectors(angles, 64))
    assert all(n == 0 for n in kernels.launch_counts.values())
    assert got.shape == imgs.shape and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_matches_xla_rotate_square_shear(C):
    """With shift vectors of its own, every item whose vectors agree with
    JAX's (F1) equals vmap(geometry.rotate_square_shear) byte for byte; an
    item whose vectors differ is named."""
    imgs, angles = rotate_batch(16, 64, C, seed=10 + C)
    want = np.asarray(jax.vmap(jgeo.rotate_square_shear)(
        jnp.asarray(imgs), jnp.asarray(angles)))
    got = trot.rotate_square_shear_batch(torch.as_tensor(imgs),
                                         torch.as_tensor(angles)).numpy()
    same = np.ones(len(imgs), bool)
    for m, j in zip(tgeo.shear_params(torch.as_tensor(angles), 64),
                    jax_vectors(angles, 64)):
        same &= (m.numpy() == j.numpy()).reshape(len(imgs), -1).all(1)
    assert same.all(), (f"F1: the shift vectors of items "
                        f"{np.flatnonzero(~same).tolist()} differ from JAX's")
    np.testing.assert_array_equal(got[same], want[same])


def test_large_canvas_matches_xla_not_clipped():
    """At S=768 the shifts exceed _shear_kernel's fixed 9-bit range (F3);
    the port applies them in full, as the XLA rotate_square_shear does."""
    S = 768
    img = np.random.default_rng(7).integers(0, 256, (S, S, 1), np.uint8)
    want = np.asarray(jgeo.rotate_square_shear(jnp.asarray(img), 44.0))
    quad, sh1, sh2 = (np.asarray(a)[None] for a in jgeo.shear_params(44.0, S))
    assert np.abs(sh2).max() > 255   # beyond the 9-bit offset of the TPU kernel
    got = trot.shear_rotate(torch.as_tensor(img[None]),
                            *interop.shifts_from_jax(quad, sh1, sh2))
    np.testing.assert_array_equal(got.numpy()[0], want)


@pytest.mark.parametrize("S", [64, 512, 768])
def test_shear_params_equal_the_unclipped_vectors(S):
    """rotate_square_shear_batch computes its vectors without the clip
    that geometry.shear_params applies; the clip never binds, so at the
    boundary angles the port's vectors equal JAX's unclipped ones, and
    over random angles the outer shears stay inside the clip."""
    angles = np.asarray(BOUNDARY_ANGLES, np.float32)
    for m, j in zip(tgeo.shear_params(torch.as_tensor(angles), S),
                    jax_vectors(angles, S)):
        np.testing.assert_array_equal(m.numpy(), j.numpy())
    rand = torch.as_tensor(np.random.default_rng(S).uniform(1, 359, 4096),
                           dtype=torch.float32)
    _, sh1, sh2 = tgeo.shear_params(rand, S)
    o13 = 1 << (tgeo.shear13_bits_for(S) - 1)
    o2 = 1 << (tgeo.shift_bits_for(S) - 1)
    assert int(sh1.abs().max()) < o13 - 1 and int(sh2.abs().max()) < o2 - 1


def test_applied_shifts_match_the_plain_permutation():
    """Out-of-range quads and shifts are normalised to what
    rotate_square_shear_by applies, so a kernel given them agrees."""
    rng = np.random.default_rng(5)
    S = 32
    imgs = torch.as_tensor(rng.integers(0, 256, (6, S, S, 2), np.uint8))
    quad = torch.tensor([-1, 0, 1, 2, 3, 7], dtype=torch.int32)
    sh1 = torch.as_tensor(rng.integers(-40, 41, (6, S)), dtype=torch.int32)
    sh2 = torch.as_tensor(rng.integers(-40, 41, (6, S)), dtype=torch.int32)
    q, s1, s2 = tgeo.applied_shifts(quad, sh1, sh2, S)
    assert q.tolist() == [0, 0, 1, 2, 3, 0] and q.dtype == torch.int32
    assert int(s1.abs().max()) <= (1 << (tgeo.shear13_bits_for(S) - 1)) - 1
    assert torch.equal(tgeo.rotate_square_shear_by(imgs, quad, sh1, sh2),
                       tgeo.rotate_square_shear_by(imgs, q, s1, s2))
    _, t1, t2 = tgeo.shear_params(torch.tensor([30.0, 300.0]), S)
    q2, u1, u2 = tgeo.applied_shifts(torch.tensor([0, 3], dtype=torch.int32),
                                     t1, t2, S)
    assert torch.equal(u1, t1) and torch.equal(u2, t2)


def test_shifts_from_jax_types():
    quad, sh1, sh2 = interop.shifts_from_jax(
        np.asarray([1, 2], np.int64), np.zeros((2, 8), np.int64),
        np.ones((2, 8), np.int32))
    assert quad.dtype == sh1.dtype == sh2.dtype == torch.int32
    assert quad.tolist() == [1, 2] and sh2.shape == (2, 8)
    assert quad.device.type == "cpu"


@pytest.mark.parametrize("bad", ["dtype", "square", "ndim", "contiguous",
                                 "device", "shift_dtype", "shift_shape"])
def test_wrapper_rejects_bad_inputs(bad):
    imgs, angles = rotate_batch(2, 16, 3, seed=3)
    images = torch.as_tensor(imgs)
    quad, sh1, sh2 = tgeo.shear_params(torch.as_tensor(angles), 16)
    if bad == "dtype":
        images = images.int()
    elif bad == "square":
        images = images[:, :, :12].contiguous()
    elif bad == "ndim":
        images = images[..., 0]
    elif bad == "contiguous":
        images = images.transpose(1, 2)
    elif bad == "device":
        images = images.to("meta")
    elif bad == "shift_dtype":
        sh1 = sh1.long()
    else:
        sh2 = sh2[:, :8]
    with pytest.raises(ValueError):
        trot.shear_rotate(images, quad, sh1, sh2)


@pytest.mark.parametrize("S", [64, 97])
@pytest.mark.parametrize("shift", [-70, 70])
@pytest.mark.parametrize("cin", [3, 4])
def test_shear_rotate_crop_matches_pallas_interpret(cin, shift, S):
    """shear_rotate_crop's CPU path (cuda_shear's crop and rotation) equals
    lax.dynamic_slice's crop, then _shear_kernel in interpret mode, byte
    for byte, with offsets moved off the canvas (negative ones count from
    the end, then all are clamped); and equals _crop then the plain twin."""
    B, SIN = 8, S + 24
    rng = np.random.default_rng(S + cin + abs(shift))
    canvas = rng.integers(0, 256, (B, SIN, SIN, cin), np.uint8)
    y0 = (rng.integers(0, SIN - S + 1, B) + shift).astype(np.int32)
    x0 = (rng.integers(0, SIN - S + 1, B) - shift).astype(np.int32)
    angles = np.asarray(BOUNDARY_ANGLES[:B], np.float32)  # every quad
    crops = jax.vmap(lambda im, yy, xx: jax.lax.dynamic_slice(
        im, (yy, xx, 0), (S, S, 3)))(jnp.asarray(canvas), jnp.asarray(y0),
                                     jnp.asarray(x0))
    want = np.asarray(jrot.rotate_square_shear_batch(
        crops, jnp.asarray(angles), interpret=True))
    shifts = jax_vectors(angles, S)
    kernels.reset_launch_counts()
    got = trot.shear_rotate_crop(torch.as_tensor(canvas), torch.as_tensor(y0),
                                 torch.as_tensor(x0), *shifts, S)
    assert all(n == 0 for n in kernels.launch_counts.values())
    assert got.shape == (B, S, S, 3) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    plain = tgeo.rotate_square_shear_by(
        taug._crop(torch.as_tensor(canvas)[..., :3], torch.as_tensor(y0),
                   torch.as_tensor(x0), S), *shifts)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("bad", ["channels", "contiguous", "crop", "device",
                                 "offset_dtype", "offset_shape",
                                 "shift_shape"])
def test_shear_rotate_crop_rejects_bad_inputs(bad):
    rng = np.random.default_rng(4)
    canvas = torch.as_tensor(rng.integers(0, 256, (2, 40, 40, 3), np.uint8))
    y0 = x0 = torch.tensor([3, -5], dtype=torch.int32)
    quad, sh1, sh2 = tgeo.shear_params(torch.tensor([30.0, 200.0]), 32)
    crop = 32
    if bad == "channels":
        canvas = canvas[..., :2].contiguous()
    elif bad == "contiguous":
        canvas = canvas.transpose(1, 2)
    elif bad == "crop":
        crop = 41
    elif bad == "device":
        canvas = canvas.to("meta")
    elif bad == "offset_dtype":
        y0 = y0.long()
    elif bad == "offset_shape":
        x0 = x0[:1]
    else:
        sh1 = sh1[:, :16]
    with pytest.raises(ValueError):
        trot.shear_rotate_crop(canvas, y0, x0, quad, sh1, sh2, crop)


@pytest.mark.parametrize("bad", ["path", "counter"])
def test_launch_shear_rejects_before_launching(bad):
    """An unknown path, or a direct-tile counter that is not int32 on the
    kernel's device, raises before the library is touched (no nvcc here)."""
    images = torch.zeros((1, 16, 16, 1), dtype=torch.uint8)
    quad = torch.zeros(1, dtype=torch.int32)
    sh = torch.zeros((1, 16), dtype=torch.int32)
    if bad == "counter":
        kernels.direct_tiles = torch.zeros(1, dtype=torch.int64)
    try:
        with pytest.raises(ValueError):
            trot.launch_shear(images, quad, sh, sh,
                              path="gather" if bad == "path" else "tiled")
    finally:
        kernels.direct_tiles = None


SHEAR_SRC = (kernels.CSRC / "shear_rotate.cu").read_text()


def kernel_int(name):
    return int(re.search(rf"\b{name} = (\d+);", SHEAR_SRC).group(1))


def test_kernel_quarter_turn_table_is_the_d4_codes():
    """The kernel's quarter-turn table is _D4_CODES[quad * 4]."""
    table = int(re.search(r"kQuadD4 = 0x([0-9A-Fa-f]+);", SHEAR_SRC).group(1),
                16)
    assert [table >> 4 * q & 15 for q in range(4)] \
        == taug._D4_CODES[::4].tolist()


def source_map(quad, sh1, sh2, S):
    """Each output pixel's source (row, col) in the input and whether it
    has one, [B, S, S] numpy: the inverse walk of csrc/shear_walk.cuh."""
    y = np.arange(S)[None, :, None]
    x = np.arange(S)[None, None, :]
    bi = np.arange(len(quad))[:, None, None]
    s1, s2 = sh1.numpy().astype(np.int64), sh2.numpy().astype(np.int64)
    x2 = x - s1[bi, y]
    in2 = (x2 >= 0) & (x2 < S)
    yy = y - s2[bi, np.where(in2, x2, 0)]
    in1 = in2 & (yy >= 0) & (yy < S)
    xx = x2 - s1[bi, np.where(in1, yy, 0)]
    hit = in1 & (xx >= 0) & (xx < S)
    d4 = taug._D4_CODES[quad.numpy() * 4][:, None, None]
    a = np.where(d4 & 2, S - 1 - yy, yy)
    c = np.where(d4 & 1, S - 1 - xx, xx)
    return np.where(d4 & 4, c, a), np.where(d4 & 4, a, c), hit


def test_source_map_is_the_plain_rotation():
    """source_map, rotated index images and rotate_square_shear_by agree."""
    S = 48
    quad, sh1, sh2 = tgeo.shear_params(torch.tensor([20.0, 100.0, 225.0,
                                                     300.0]), S)
    row, col, hit = source_map(quad, sh1, sh2, S)
    index = torch.arange(1, S * S + 1, dtype=torch.int32).reshape(1, S, S, 1)
    got = tgeo.rotate_square_shear_by(index.expand(4, S, S, 1).contiguous(),
                                      quad, sh1, sh2)[..., 0].numpy()
    np.testing.assert_array_equal(got, np.where(hit, row * S + col + 1, 0))


@pytest.mark.parametrize("S,tile_w", [(64, 64), (97, 64), (512, 64),
                                      (768, 64), (97, 128), (512, 128)])
def test_shear_params_tiles_fit_the_window(S, tile_w):
    """For shear_params vectors at any angle, every tile's sources (64 x 64
    tiles, 64 x 128 for one channel) span at most the side the kernel
    sizes its window for, sqrt(64^2 + tile_w^2) and a margin, so the main
    paths never take the direct gather; and that side is not oversized."""
    side = math.ceil(math.hypot(64, tile_w)) + kernel_int("kWinMargin")
    n = 361 if S <= 512 else 91
    angles = np.concatenate([np.linspace(0, 360, n), BOUNDARY_ANGLES])
    shifts = tgeo.shear_params(torch.as_tensor(angles, dtype=torch.float32), S)
    worst_h = worst_w = 0
    for i in range(0, len(angles), 16):
        row, col, hit = source_map(*(t[i:i + 16] for t in shifts), S)
        for ty in range(0, S, 64):
            for tx in range(0, S, tile_w):
                t = (slice(None), slice(ty, ty + 64), slice(tx, tx + tile_w))
                any_ = hit[t].any((1, 2))
                h = np.where(hit[t], row[t], -1).max((1, 2)) \
                    - np.where(hit[t], row[t], S).min((1, 2)) + 1
                w = np.where(hit[t], col[t], -1).max((1, 2)) \
                    - np.where(hit[t], col[t], S).min((1, 2)) + 1
                worst_h = max(worst_h, int(np.where(any_, h, 0).max()))
                worst_w = max(worst_w, int(np.where(any_, w, 0).max()))
    assert worst_h <= side and worst_w <= side
    assert S < 2 * side or worst_h > side - 8
