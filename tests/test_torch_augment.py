"""The port's kernel glue, plain twins and wrappers against the JAX package:
augment_full_reference byte for byte against JAX's (eager) and against the
Pallas kernel in interpret mode; augment_fused byte for byte against JAX's
eager augment_finish_reference and, at the JAX package's own tolerance,
against its Pallas kernel in interpret mode; the wrappers' CPU paths,
checks and counters.  The kernels themselves are held against the plain
twins on the card in test_torch_cuda.py."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_processor_pipeline_tpu.ops.pallas import augment as jaug
from image_processor_pipeline_tpu_torch import interop, kernels
from image_processor_pipeline_tpu_torch.ops import augment as taug
from image_processor_pipeline_tpu_torch.ops import native_draws

LOWERS = ((35.0, 60.0, 60.0), (100.0, 40.0, 40.0))
UPPERS = ((85.0, 255.0, 255.0), (140.0, 230.0, 230.0))
ZONES = ((0, 0, 0, 0), (4, 4, 2, 2))
BOUNDARY_ANGLES = (0.0, 44.99, 45.0, 45.01, 90.0, 135.0, 180.0, 270.0,
                   315.0, 358.9)


def make_batch(B, SIN, S, seed, first_angle=0):
    """Canvases and draws with every flip code and, from ``first_angle``
    on, the boundary angles."""
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (B, SIN, SIN, 3), np.uint8)
    y0 = rng.integers(0, SIN - S + 1, B).astype(np.int32)
    x0 = rng.integers(0, SIN - S + 1, B).astype(np.int32)
    angles = np.asarray((BOUNDARY_ANGLES + tuple(rng.uniform(1, 359, B)))[
        first_angle:first_angle + B], np.float32)
    prms = rng.uniform(0.7, 1.3, (B, 8)).astype(np.float32)
    flips = (np.arange(B) % 4).astype(np.int32)
    return imgs, y0, x0, angles, prms, flips


def port_args(imgs, y0, x0, angles, prms, flips, device="cpu"):
    ty0, tx0, tang, tflips, tprms = interop.draws_from_jax(
        y0, x0, angles, flips, prms, device)
    packed = taug.pack_rgba(torch.as_tensor(imgs, device=device))
    return packed, ty0, tx0, tang, tprms, tflips


def jax_shifts(angles, S):
    return tuple(torch.as_tensor(np.array(a))
                 for a in jaug._shifts(jnp.asarray(angles), S))


@pytest.fixture(scope="module", params=[0, 2], ids=["angles0", "angles2"])
def batch8(request):
    """B=8, 96 -> 64: the two params cover all ten boundary angles."""
    B, SIN, S = 8, 96, 64
    imgs, y0, x0, angles, prms, flips = make_batch(
        B, SIN, S, seed=request.param, first_angle=request.param)
    want = np.asarray(jaug.augment_full_reference(
        jaug.pack_rgba(jnp.asarray(imgs)), y0, x0, angles, prms, flips,
        LOWERS, UPPERS, ZONES, crop=S))
    return (imgs, y0, x0, angles, prms, flips), want, S


def test_full_reference_matches_jax_given_its_shifts(batch8):
    data, want, S = batch8
    got = taug.augment_full_reference(
        *port_args(*data), LOWERS, UPPERS, ZONES, crop=S,
        shifts=jax_shifts(data[3], S))
    np.testing.assert_array_equal(got.numpy(), want)


def test_full_reference_matches_jax_with_own_shifts(batch8):
    """With shift vectors of its own, every item whose vectors agree with
    JAX's (F1) is byte-identical; an item whose vectors differ is named."""
    data, want, S = batch8
    got = taug.augment_full_reference(*port_args(*data), LOWERS, UPPERS,
                                      ZONES, crop=S).numpy()
    mine = taug._shifts(torch.as_tensor(data[3]), S)
    same = np.ones(len(want), bool)
    for m, j in zip(mine, jax_shifts(data[3], S)):
        same &= (m.numpy() == j.numpy()).reshape(len(want), -1).all(1)
    assert same.all(), (f"F1: the shift vectors of items "
                        f"{np.flatnonzero(~same).tolist()} differ from JAX's")
    np.testing.assert_array_equal(got[same], want[same])


def test_full_reference_matches_pallas_interpret():
    """The Pallas kernel as the JAX tests run it (interpret mode) equals
    the port's plain twin, byte for byte."""
    B, SIN, S = 4, 96, 64
    data = make_batch(B, SIN, S, seed=1)
    imgs, y0, x0, angles, prms, flips = data
    want = np.asarray(jaug.augment_fused_pallas_full(
        jaug.pack_rgba(jnp.asarray(imgs)), jnp.asarray(y0), jnp.asarray(x0),
        jnp.asarray(angles), jnp.asarray(prms), jnp.asarray(flips),
        LOWERS, UPPERS, ZONES, crop=S, interpret=True))
    got = taug.augment_full_reference(
        *port_args(*data), LOWERS, UPPERS, ZONES, crop=S,
        shifts=jax_shifts(angles, S))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_on_cpu_takes_plain_path(batch8):
    data, want, S = batch8
    args = port_args(*data)
    kernels.reset_launch_counts()
    got = taug.augment_fused_full(*args, LOWERS, UPPERS, ZONES, crop=S)
    assert kernels.launch_counts["augment_full"] == 0
    plain = taug.augment_full_reference(*args, LOWERS, UPPERS, ZONES, crop=S)
    assert got.shape == (8, S, S, 4) and got.dtype == torch.uint8
    assert torch.equal(got, plain)


@pytest.mark.parametrize("channels", [3, 4])
def test_wrapper_takes_u8_canvas_like_packed(batch8, channels):
    """The uint8 canvas with 3 or 4 channels gives the packed canvas's bytes
    and JAX's eager augment_full_reference's, with every flip code and the
    boundary angles (JAX's shift vectors on the plain twin, F1)."""
    data, want, S = batch8
    args = port_args(*data)
    u8 = args[0].view(torch.uint8).view(*args[0].shape, 4)
    if channels == 3:
        u8 = u8[..., :3].contiguous()
    kernels.reset_launch_counts()
    got = taug.augment_fused_full(u8, *args[1:], LOWERS, UPPERS, ZONES,
                                  crop=S)
    assert kernels.launch_counts["augment_full"] == 0
    assert torch.equal(got, taug.augment_fused_full(
        *args, LOWERS, UPPERS, ZONES, crop=S))
    plain = taug.augment_full_reference(u8, *args[1:], LOWERS, UPPERS, ZONES,
                                        crop=S, shifts=jax_shifts(data[3], S))
    np.testing.assert_array_equal(plain.numpy(), want)


def test_canvas_u8_reinterprets_packed_without_copy():
    packed, *_ = port_args(*make_batch(2, 24, 16, seed=5))
    u8 = taug.canvas_u8(packed)
    assert u8.shape == (2, 24, 24, 4) and u8.dtype == torch.uint8
    assert u8.data_ptr() == packed.data_ptr()
    np.testing.assert_array_equal(u8[..., 3].numpy(), 255)
    rgb = u8[..., :3].contiguous()
    assert taug.canvas_u8(rgb) is rgb


def test_chain_path_pinned():
    """The cluster path stages an image's crop across the shared memory of
    its cluster's CTAs, which bounds S; larger crops take two passes."""
    assert taug.CLUSTER == 16
    for S in (64, 97, 512, 926):
        assert taug.chain_path(S) == "cluster"
    for S in (927, 1024):
        assert taug.chain_path(S) == "two_pass"
    assert taug.cluster_smem_bytes(512) == 4240 + 14 * 512 + 4 * 32 * 513
    assert taug.cluster_smem_bytes(926) <= taug.SMEM_LIMIT \
        < taug.cluster_smem_bytes(927)
    assert taug.chain_path(658, 8) == "cluster"
    assert taug.chain_path(659, 8) == "two_pass"


def test_smem_layout_mirrors_the_kernel_source():
    """chain_path's arithmetic is the kernel's own (kSmemLimit, kFixedSmem,
    cluster_smem_bytes in csrc/augment_full.cu)."""
    src = (kernels.CSRC / "augment_full.cu").read_text()
    assert f"kSmemLimit = {taug.SMEM_LIMIT};" in src
    fixed = re.search(r"kFixedSmem = ([0-9+ ]+);", src).group(1)
    assert eval(fixed) == taug._FIXED_SMEM
    assert ("kFixedSmem + ((14 * S + 15) & ~15) + 4 * band * (S + 1)"
            in src)


@pytest.mark.parametrize("bad", ["dtype", "shape", "crop", "device",
                                 "contiguous", "param_dtype", "param_shape",
                                 "u8_channels", "u8_contiguous", "u8_square",
                                 "u8_rank"])
def test_wrapper_rejects_bad_inputs(bad):
    packed, y0, x0, angles, prms, flips = port_args(
        *make_batch(2, 24, 16, seed=2))
    crop = 16
    if bad == "dtype":
        packed = packed.to(torch.int64)
    elif bad == "shape":
        packed = packed[:, :, :20].contiguous()
    elif bad == "crop":
        crop = 25
    elif bad == "device":
        packed = packed.to("meta")
    elif bad == "contiguous":
        packed = packed.transpose(1, 2)
    elif bad == "param_dtype":
        angles = angles.double()
    elif bad == "param_shape":
        prms = prms[:, :6]
    else:
        u8 = packed.view(torch.uint8).view(2, 24, 24, 4)
        if bad == "u8_channels":
            packed = u8[..., :2].contiguous()
        elif bad == "u8_contiguous":
            packed = u8[..., :3]
        elif bad == "u8_square":
            packed = u8[:, :, :20].contiguous()
        else:
            packed = u8[..., 0].contiguous()
    with pytest.raises(ValueError):
        taug.augment_fused_full(packed, y0, x0, angles, prms, flips,
                                LOWERS, UPPERS, ZONES, crop=crop)


def test_crop_clamps_offsets_like_dynamic_slice():
    """Out-of-canvas crop offsets follow lax.dynamic_slice: a negative one
    counts from the end, then each is clamped into the canvas."""
    imgs, _, _, angles, prms, flips = make_batch(8, 96, 64, seed=3)
    y0 = np.asarray([-5, 3, 40, 100, -100, 0, 32, 33], np.int32)
    x0 = np.asarray([9, -1, 8, -40, 7, 200, -96, 31], np.int32)
    want = np.asarray(jaug.augment_full_reference(
        jaug.pack_rgba(jnp.asarray(imgs)), y0, x0, angles, prms, flips,
        LOWERS, UPPERS, ZONES, crop=64))
    got = taug.augment_full_reference(
        *port_args(imgs, y0, x0, angles, prms, flips), LOWERS, UPPERS, ZONES,
        crop=64, shifts=jax_shifts(angles, 64))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("channels", [3, 4])
def test_pack_rgba_matches_jax(channels):
    rng = np.random.default_rng(channels)
    imgs = rng.integers(0, 256, (2, 5, 7, channels), np.uint8)
    want = np.asarray(jaug.pack_rgba(jnp.asarray(imgs)))
    got = taug.pack_rgba(torch.as_tensor(imgs))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_d4_table_and_flip_bits_match_jax():
    np.testing.assert_array_equal(taug._D4_TABLE, jaug._D4_TABLE)


def test_filter_stack_rounds_like_cv2():
    lo, hi, zn = interop.filter_stack(
        ((76.5, 77.5, -3.0),), ((255.5, 300, 0.49),), ((1, 2, 3, 4),))
    assert lo.tolist() == [[76, 78, 0]] and hi.tolist() == [[255, 255, 0]]
    assert zn.tolist() == [[1, 2, 3, 4]] and lo.dtype == torch.int32
    with pytest.raises(ValueError):
        interop.filter_stack(((1, 2),), ((3, 4),), ((0, 0, 0, 0),))


@pytest.fixture(scope="module", params=[0, 2], ids=["angles0", "angles2"])
def crops8(request):
    """B=8 RGB crops of 64 px: every flip code, and over the two params
    all ten boundary angles."""
    imgs, _, _, angles, prms, flips = make_batch(
        8, 64, 64, seed=10 + request.param, first_angle=request.param)
    return imgs, angles, prms, flips


def fused_args(imgs, angles, prms, flips):
    _, _, tang, tflips, tprms = interop.draws_from_jax(
        np.zeros(len(imgs)), np.zeros(len(imgs)), angles, flips, prms)
    return torch.as_tensor(imgs), tang, tprms, tflips


def test_augment_fused_matches_jax_finish_reference(crops8):
    """On a CPU tensor the wrapper runs the plain twin; given JAX's shift
    vectors it equals JAX's eager augment_finish_reference byte for byte."""
    imgs, angles, prms, flips = crops8
    want = np.asarray(jaug.augment_finish_reference(
        jnp.asarray(imgs), jnp.asarray(angles), jnp.asarray(prms), LOWERS,
        UPPERS, ZONES, flips=jnp.asarray(flips)))
    images, tang, tprms, tflips = fused_args(*crops8)
    kernels.reset_launch_counts()
    got = taug.augment_fused(images, tang, tprms, LOWERS, UPPERS, ZONES,
                             flips=tflips, shifts=jax_shifts(angles, 64))
    assert all(n == 0 for n in kernels.launch_counts.values())
    assert got.shape == (8, 64, 64, 4) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_augment_fused_within_jax_tolerance_of_pallas_interpret(crops8):
    """_augment_kernel in interpret mode is within 1 of the JAX package's
    own reference with more than 99.9 % of bytes equal
    (tests/test_chains.py:73-93); the port is held to the same bound."""
    imgs, angles, prms, flips = crops8
    want = np.asarray(jaug.augment_fused_pallas(
        jnp.asarray(imgs), jnp.asarray(angles), jnp.asarray(prms), LOWERS,
        UPPERS, ZONES, interpret=True, flips=jnp.asarray(flips)))
    images, tang, tprms, tflips = fused_args(*crops8)
    got = taug.augment_fused(images, tang, tprms, LOWERS, UPPERS, ZONES,
                             flips=tflips,
                             shifts=jax_shifts(angles, 64)).numpy()
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    assert (got == want).mean() > 0.999


def test_augment_fused_equals_full_reference_of_the_crops(crops8):
    """The post-crop wrapper computes augment_full_reference's function on
    an uncropped canvas, with no flips by default."""
    images, tang, tprms, tflips = fused_args(*crops8)
    zeros = torch.zeros(8, dtype=torch.int32)
    full = taug.augment_full_reference(
        taug.pack_rgba(images), zeros, zeros, tang, tprms, tflips, LOWERS,
        UPPERS, ZONES, crop=64)
    assert torch.equal(taug.augment_fused(images, tang, tprms, LOWERS,
                                          UPPERS, ZONES, flips=tflips), full)
    assert torch.equal(
        taug.augment_fused(images, tang, tprms, LOWERS, UPPERS, ZONES),
        taug.augment_finish_reference(images, tang, tprms, LOWERS, UPPERS,
                                      ZONES))


@pytest.mark.parametrize("bad", ["dtype", "channels", "square", "contiguous",
                                 "device", "param_shape", "flip_dtype",
                                 "shift_shape"])
def test_augment_fused_rejects_bad_inputs(bad):
    imgs, _, _, angles, prms, flips = make_batch(2, 16, 16, seed=4)
    images, tang, tprms, tflips = fused_args(imgs, angles, prms, flips)
    shifts = None
    if bad == "dtype":
        images = images.int()
    elif bad == "channels":
        images = taug.pack_rgba(images)[..., None].view(torch.uint8)
    elif bad == "square":
        images = images[:, :, :12].contiguous()
    elif bad == "contiguous":
        images = images.transpose(1, 2)
    elif bad == "device":
        images = images.to("meta")
    elif bad == "param_shape":
        tprms = tprms[:, :6]
    elif bad == "flip_dtype":
        tflips = tflips.long()
    else:
        quad, sh1, sh2 = taug._shifts(tang, 16)
        shifts = (quad, sh1[:, :8], sh2)
    with pytest.raises(ValueError):
        taug.augment_fused(images, tang, tprms, LOWERS, UPPERS, ZONES,
                           flips=tflips, shifts=shifts)


# -- K1's one placement against the JAX launcher ------------------------------

def fused_test_batch(seed, flips=None):
    """tests/test_fused.py:242-310's inputs (B=8, 96 -> 64): numpy draws
    from default_rng(seed), the flips drawn or given."""
    rng = np.random.default_rng(seed)
    B, SIN, S = 8, 96, 64
    imgs = rng.integers(0, 256, (B, SIN, SIN, 3), np.uint8)
    y0 = rng.integers(0, SIN - S + 1, B).astype(np.int32)
    x0 = rng.integers(0, SIN - S + 1, B).astype(np.int32)
    angles = rng.uniform(1, 359, B).astype(np.float32)
    prms = rng.uniform(0.7, 1.3, (B, 8)).astype(np.float32)
    if flips is None:
        flips = rng.integers(0, 4, B)
    return imgs, y0, x0, angles, prms, np.asarray(flips, np.int32)


@pytest.fixture(scope="module", params=[
    (0, None), (1, [0, 1, 2, 3, 3, 2, 1, 0])], ids=["prologue", "gather"])
def placed_batch(request):
    """The inputs of tests/test_fused.py's prologue test (flips drawn) or
    gather test (flips given), and the JAX launcher's output for them in
    interpret mode, under its default placement."""
    seed, flips = request.param
    data = fused_test_batch(seed, flips)
    imgs, y0, x0, angles, prms, flips = data
    want = np.asarray(jaug.augment_fused_pallas_full(
        jaug.pack_rgba(jnp.asarray(imgs)), jnp.asarray(y0), jnp.asarray(x0),
        jnp.asarray(angles), jnp.asarray(prms), jnp.asarray(flips), LOWERS,
        UPPERS, ZONES, crop=64, interpret=True))
    return data, want


@pytest.mark.parametrize("form", ["packed", "u8"])
def test_placements_match_jax_interpret(placed_batch, form):
    """The wrapper's one placement (the crop cut by the kernel, quarter
    turn and flip in its item code) equals the JAX launcher's
    interpret-mode output and the port's plain twin, byte for byte, given
    JAX's shift vectors; packed and uint8 canvases."""
    data, want = placed_batch
    packed, y0, x0, _, prms, flips = port_args(*data)
    canvas = packed if form == "packed" \
        else torch.as_tensor(data[0]).contiguous()
    shifts = jax_shifts(data[3], 64)
    kernels.reset_launch_counts()
    got = taug.augment_fused_full(canvas, y0, x0, None, prms, flips, LOWERS,
                                  UPPERS, ZONES, crop=64, shifts=shifts)
    assert all(n == 0 for n in kernels.launch_counts.values())
    np.testing.assert_array_equal(got.numpy(), want)
    default = taug.augment_full_reference(packed, y0, x0, None, prms, flips,
                                          LOWERS, UPPERS, ZONES, crop=64,
                                          shifts=shifts)
    assert torch.equal(got, default)


def test_staged_rows_refuse_a_cpu_canvas():
    """The launch from packed rows runs on the card only: a CPU canvas is
    refused before any work, naming both devices."""
    imgs = torch.zeros((2, 96, 96, 3), dtype=torch.uint8)
    layout = native_draws.pack_layout(2, 64)
    buf = torch.zeros(layout.nbytes, dtype=torch.uint8)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="canvas on cpu, rows on cpu"):
        taug.augment_fused_full(imgs, None, None, None, None, None, LOWERS,
                                UPPERS, ZONES, crop=64, staged=(buf, layout))
    assert all(n == 0 for n in kernels.launch_counts.values())
