"""The port's device steps against the JAX package's, on the CPU.

Each step's ``device_fn`` is held against the JAX step's ``device_fn`` run
eagerly (``jax.disable_jit()``) on the same numpy inputs, byte for byte, at
64 to 96 px; the whole pipelines A (crop_square + copy) and B (rotations +
symmetry) are run through both engines over one temporary PNG dataset, the
JAX engine on its jit path (``native_compute=False``), and must give the
same file names, statuses, report entries and label lines and equal decoded
pixels.  Tolerances: none, except where a test states a bound (the
``nearest`` rotation on angles whose float32 cos or sin differ between
torch and XLA).

Two things keep the eager comparison honest.  ``jax.random.uniform``
rounds differently with jit disabled (no fused multiply-add), so the
rotation's draws are held against the jitted draw, which is what both
engines use, and the rotation itself is given JAX's angles.  The shear
method is held given the same (quad, sh1, sh2), taken from the JAX
package's ``shear_params``, as the kernel tests do.
"""

from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import image_processor_pipeline_tpu as jpkg
import image_processor_pipeline_tpu.transforms as jtransforms
import image_processor_pipeline_tpu_torch as tpkg
import image_processor_pipeline_tpu_torch.transforms as ttransforms
from image_processor_pipeline_tpu.ops import geometry as jgeo
from image_processor_pipeline_tpu.transforms import crop_square as jcrop
from image_processor_pipeline_tpu.transforms import rotations as jrot
from image_processor_pipeline_tpu.transforms import symmetry as jsym
from image_processor_pipeline_tpu_torch import interop
from image_processor_pipeline_tpu_torch.ops import geometry as tgeo
from image_processor_pipeline_tpu_torch.transforms import crop_square as tcrop
from image_processor_pipeline_tpu_torch.transforms import rotations as trot
from image_processor_pipeline_tpu_torch.transforms import symmetry as tsym
from torch_port_data import (assert_same_files, make_dataset, make_image,
                             reports)


def _t(a):
    return torch.as_tensor(np.array(a))


def masked_batch(rng, B, H, W, C, lo=24):
    """Random images with per-item extents, zero outside them."""
    hs = rng.integers(lo, H + 1, B).astype(np.int32)
    ws = rng.integers(lo, W + 1, B).astype(np.int32)
    img = rng.integers(0, 256, (B, H, W, C), np.uint8)
    yy, xx = np.mgrid[0:H, 0:W]
    img *= ((yy[None] < hs[:, None, None])
            & (xx[None] < ws[:, None, None]))[..., None]
    return img, hs, ws


def assert_same(got, want, what):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.shape == w.shape and g.dtype == w.dtype, (what, k)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {k}")


# -- crop_square ------------------------------------------------------------

def crop_batch(seed, B=16, H=64, W=96):
    rng = np.random.default_rng(seed)
    img, hs, ws = masked_batch(rng, B, H, W, 3, lo=40)
    xywhn = np.zeros((B, tcrop.MAX_BOXES, 4), np.float32)
    xywhn[..., :2] = rng.uniform(0.3, 0.7, (B, tcrop.MAX_BOXES, 2))
    xywhn[..., 2:] = rng.uniform(0.05, 0.3, (B, tcrop.MAX_BOXES, 2))
    return {
        "image": img, "size": np.stack([hs, ws], 1),
        "classes": rng.integers(0, 5, (B, tcrop.MAX_BOXES)).astype(np.int32),
        "xywhn": xywhn,
        # no box (an error item), one box, several; some placements fail
        "nbox": rng.integers(0, 4, B).astype(np.int32),
        "seed": rng.integers(0, 2**31, B).astype(np.uint32)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
def test_crop_square_device_fn_matches_jax(seed, jit):
    batch = crop_batch(seed)
    assert tcrop.MAX_BOXES == jcrop.MAX_BOXES
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    step = jcrop.SquareCropAroundBBox()
    if jit:
        want = step._jitted()(step, jbatch, ())
    else:
        with jax.disable_jit():
            want = step.device_fn(jbatch, ())
    got = tcrop.SquareCropAroundBBox().device_fn(
        dict(batch, image=_t(batch["image"])), ())
    assert_same(got, want, f"crop_square seed {seed}")
    ok = np.asarray(want["placement_ok"])
    assert ok.any() and not ok.all()  # both outcomes are covered


# -- rotations ----------------------------------------------------------------

@pytest.mark.parametrize("n,lo,hi", [(10, 1.0, 359.0), (4, 1.0, 359.0),
                                     (3, -30.0, 30.0), (1, 0.0, 90.0)])
def test_rotation_angles_are_the_jitted_jax_draws(n, lo, hi):
    """uniform(PRNGKey(seed), (n,), lo, hi) per item, bit for bit."""
    seeds = np.random.default_rng(n).integers(0, 2**31, 2000).astype(
        np.uint32)
    want = jrot.RandomRotations()._host_angles(seeds, n, lo, hi)
    got = trot.draw_angles(seeds, n, lo, hi)
    assert got.dtype == np.float32 and got.shape == (2000, n)
    np.testing.assert_array_equal(got, want)


def rotation_batch(seed, B, H, transparent=True):
    """RGBA canvases [B, H, H, 4] as decode_padded(diag=True) makes them:
    the image at the origin, its diagonal within the canvas; item 0 is
    fully transparent."""
    rng = np.random.default_rng(seed)
    side = int(H / np.sqrt(2))
    img, hs, ws = masked_batch(rng, B, H, H, 4, lo=side // 2)
    hs, ws = np.minimum(hs, side), np.minimum(ws, side)
    yy, xx = np.mgrid[0:H, 0:H]
    img *= ((yy[None] < hs[:, None, None])
            & (xx[None] < ws[:, None, None]))[..., None]
    img[..., 3] = np.where(img[..., 3] < 60, 0, 255) * (img[..., 0] > 0)
    if transparent:
        img[0, ..., 3] = 0
    return img, hs, ws, rng.integers(0, 2**31, B).astype(np.uint32)


def jax_rotations(img, hs, ws, seeds, n, method):
    with jax.disable_jit():
        return jax.vmap(lambda i, h, w, s: jrot._rotate_one(
            i, h, w, s, n, 1.0, 359.0, method))(
            jnp.asarray(img), hs, ws, seeds)


@pytest.mark.parametrize("seed,H", [(0, 64), (1, 96), (2, 128)])
def test_rotate_shear_matches_jax_eager(seed, H):
    """Byte for byte given JAX's angles and its shift vectors, the fully
    transparent item included (its extent is the whole canvas)."""
    B, N = 4, 3
    img, hs, ws, seeds = rotation_batch(seed, B, H)
    want = jax_rotations(img, hs, ws, seeds, N, "shear")
    angles = np.asarray(want["angles"])
    shifts = interop.shifts_from_jax(*jax.vmap(
        lambda a: jgeo.shear_params(a, H))(angles.reshape(-1)))
    got = trot._rotate(_t(img), _t(hs), _t(ws), _t(angles), "shear",
                       shifts=shifts)
    assert_same(got, want, f"shear H={H}")
    assert got["heights"][0].tolist() == [H] * N  # the empty-bbox rule
    # the port's own vectors (torch's tan and sin) give the same here
    own = trot._rotate(_t(img), _t(hs), _t(ws), _t(angles), "shear")
    assert_same(own, want, f"shear H={H}, own vectors")


def trig_agrees(angles):
    """Angles whose float32 cos and sin are bitwise equal in torch and
    XLA."""
    theta = jnp.deg2rad(jnp.asarray(angles, jnp.float32))
    t = _t(angles) * tgeo._DEG2RAD
    return (np.asarray(jnp.cos(theta)) == torch.cos(t).numpy()) \
        & (np.asarray(jnp.sin(theta)) == torch.sin(t).numpy())


@pytest.mark.parametrize("seed,H", [(3, 64), (4, 96)])
def test_rotate_nearest_matches_jax_eager(seed, H):
    """Sizes exact for every angle.  Pixels byte for byte where torch's and
    XLA's float32 cos and sin agree bitwise; on the other angles at most
    0.1 % of an image's pixels may differ (found: 0 on these inputs)."""
    B, N = 4, 6
    img, hs, ws, seeds = rotation_batch(seed, B, H)
    want = jax_rotations(img, hs, ws, seeds, N, "nearest")
    angles = np.asarray(want["angles"])
    got = trot._rotate(_t(img), _t(hs), _t(ws), _t(angles), "nearest")
    for k in ("heights", "widths", "angles"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    same_trig = trig_agrees(angles)
    assert same_trig.any()
    diff = (got["images"].numpy() != np.asarray(want["images"])).any(-1)
    share = diff.reshape(B, N, -1).mean(-1)
    assert share[same_trig].max() == 0
    assert share.max() <= 1e-3, f"differing share {share.max()}"
    # the fully transparent item keeps the expanded extents (h2, w2)
    h2, w2 = jax.vmap(lambda a: jgeo.rotated_size(hs[0], ws[0], a))(angles[0])
    assert got["heights"][0].tolist() == np.asarray(h2).tolist()
    assert got["widths"][0].tolist() == np.asarray(w2).tolist()


def test_rotated_size_matches_jax_on_many_angles():
    """(h2, w2) exactly, on angles where cos and sin agree bitwise; on the
    rest a size may move by one where the sum lands on a ceil or floor
    (found: none in 20000 angles)."""
    rng = np.random.default_rng(5)
    angles = rng.uniform(0, 360, 20000).astype(np.float32)
    h = rng.integers(1, 700, 20000).astype(np.int32)
    w = rng.integers(1, 700, 20000).astype(np.int32)
    want = jax.vmap(jgeo.rotated_size)(h, w, angles)
    got = tgeo.rotated_size(_t(h), _t(w), _t(angles))
    same = trig_agrees(angles)
    for g, j in zip(got, want):
        delta = np.abs(g.numpy() - np.asarray(j))
        assert delta[same].max() == 0
        assert delta.max() <= 1 and (delta > 0).sum() == 0


def test_rotate_rejects_unknown_method_and_interpolation():
    img, hs, ws, _ = rotation_batch(0, 2, 64)
    angles = torch.full((2, 1), 30.0)
    with pytest.raises(ValueError, match="method"):
        trot._rotate(_t(img), _t(hs), _t(ws), angles, "bicubic")
    with pytest.raises(ValueError, match="interpolation"):
        trot._rotate(_t(img), _t(hs), _t(ws), angles, "nearest", "bicubic")
    out = trot._rotate(_t(img), _t(hs), _t(ws), angles, "nearest", "bilinear")
    assert out["images"].shape == (2, 1, 64, 64, 4)


# -- symmetry -----------------------------------------------------------------

@pytest.mark.parametrize("C", [3, 4])
@pytest.mark.parametrize("which", [("h", "v", "hv"), ("v",), ()])
def test_symmetry_device_fn_matches_jax_eager(C, which):
    img, hs, ws = masked_batch(np.random.default_rng(C), 6, 64, 96, C)
    size = np.stack([hs, ws], 1)
    with jax.disable_jit():
        want = jsym.GenerateSymmetries().device_fn(
            {"image": jnp.asarray(img), "size": jnp.asarray(size)}, which)
    got = tsym.GenerateSymmetries().device_fn(
        {"image": _t(img), "size": _t(size)}, which)
    assert_same(got, want, f"symmetry {which}")


# -- whole pipelines through both engines -------------------------------------

def build_pipelines(pkg, transforms, root, imgs, labels, method, **step_kw):
    """Pipeline A (crop_square, copy) and B (rotations over A's crops,
    symmetry) with the same seeds in either package."""
    options = step_kw.pop("options", {})
    step = pkg.ProcessingStep
    a = pkg.ProcessingPipeline(root_dir=root / "A")
    a.add_step(step("crop", transforms.SquareCropAroundBBox(),
                    input_dirs=[imgs, labels],
                    output_dirs=["crops/imgs", "crops/labels"],
                    pairing_method="zip", seed=5, save_log=True,
                    options=dict(options), **step_kw))
    a.add_step(step("copy", transforms.copy_img_with_labels,
                    output_dirs=["copy/imgs", "copy/labels"],
                    pairing_method="zip", save_log=True))
    b = pkg.ProcessingPipeline(root_dir=root / "B")
    b.add_step(step("rot", transforms.RandomRotations(),
                    input_dirs=[root / "A" / "crops" / "imgs"],
                    output_dirs=["rot"], seed=7, save_log=True,
                    options=dict(options, num_rotations=3, method=method),
                    **step_kw))
    b.add_step(step("sym", transforms.GenerateSymmetries(),
                    output_dirs=["sym"], seed=9, save_log=True,
                    options=dict(options), **step_kw))
    return a, b


@pytest.fixture(scope="module")
def both_engines(tmp_path_factory):
    """Both engines over one dataset of 16 PNGs in four sizes, once for
    each rotation method."""
    base = tmp_path_factory.mktemp("engines")
    imgs, labels = make_dataset(base / "data", 16, seed=21)
    runs = {}
    for method in ("shear", "nearest"):
        for name, pkg, transforms, kw in (
                ("jax", jpkg, jtransforms,
                 {"options": {"native_compute": False}}),
                ("torch", tpkg, ttransforms, {"device": "cpu"})):
            root = base / method / name
            a, b = build_pipelines(pkg, transforms, root, imgs, labels,
                                   method, **kw)
            runs[method, name] = (root, a.run(progress=False)
                                  + b.run(progress=False))
    return runs


@pytest.mark.parametrize("method", ["shear", "nearest"])
def test_pipelines_give_the_same_statuses_and_reports(both_engines, method):
    jroot, jcounts = both_engines[method, "jax"]
    troot, tcounts = both_engines[method, "torch"]
    assert tcounts == jcounts == [Counter(Success=16), Counter(Success=16),
                                  Counter(Success=16), Counter(Success=64)]
    assert reports(troot) == reports(jroot)


@pytest.mark.parametrize("method", ["shear", "nearest"])
@pytest.mark.parametrize("directory,n_files", [
    ("A/crops/imgs", 16), ("A/crops/labels", 16), ("A/copy/imgs", 16),
    ("A/copy/labels", 16), ("B/rot", 64), ("B/sym", 256)])
def test_pipelines_give_the_same_files(both_engines, method, directory,
                                       n_files):
    """The same names; label lines equal as text; decoded pixels equal
    (PNG is lossless, so file bytes are not compared).  No item differs on
    this dataset, so none is named."""
    jdir = both_engines[method, "jax"][0] / directory
    tdir = both_engines[method, "torch"][0] / directory
    names = sorted(p.name for p in jdir.iterdir())
    assert sorted(p.name for p in tdir.iterdir()) == names
    assert len(names) == n_files
    for name in names:
        if name.endswith(".txt"):
            assert (tdir / name).read_text() == (jdir / name).read_text()
        else:
            got = np.asarray(Image.open(tdir / name))
            want = np.asarray(Image.open(jdir / name))
            assert got.shape == want.shape, name
            np.testing.assert_array_equal(got, want, err_msg=name)


def test_rotation_naming_options(tmp_path):
    rng = np.random.default_rng(8)
    src = tmp_path / "src"
    src.mkdir()
    Image.fromarray(make_image(rng, 40, 56, 4)).save(src / "a.png")
    names = {}
    for pkg, transforms, kw in ((jpkg, jtransforms, {
            "options": {"native_compute": False}}),
            (tpkg, ttransforms, {"device": "cpu"})):
        options = dict(kw.pop("options", {}), num_rotations=2,
                       output_prefix="t", original_key="orig",
                       rotation_key_format="{prefix}-{index}",
                       output_format="jpeg", method="shear")
        out = tmp_path / pkg.__name__
        step = pkg.ProcessingStep("rot", transforms.RandomRotations(),
                                  input_dirs=[src], output_dirs=[out],
                                  seed=1, options=options, **kw)
        assert step.run(progress=False) == Counter(Success=1)
        names[pkg.__name__] = sorted(p.name for p in out.iterdir())
    assert names[tpkg.__name__] == names[jpkg.__name__] == [
        "a_orig.jpg", "a_t-1.jpg", "a_t-2.jpg"]


# -- the shear method's vectors come from the host (F6) -----------------------

def test_rotations_device_fn_computes_its_shift_vectors_on_the_host():
    """device_fn hands ``_rotate`` the (quad, sh1, sh2) of
    geometry.shear_params evaluated on the CPU tensor of the drawn angles,
    so the step's device never computes the trig."""
    img, hs, ws, seeds = rotation_batch(5, 3, 64)
    seen = {}
    real = trot._rotate

    def spy(*args, **kw):
        seen.update(kw)
        return real(*args, **kw)

    step = trot.RandomRotations()
    batch = {"image": _t(img), "size": _t(np.stack([hs, ws], 1)),
             "seed": seeds}
    trot._rotate = spy
    try:
        out = step.device_fn(batch, (2, 1.0, 359.0, "shear", "nearest"))
        nearest = step.device_fn(batch, (2, 1.0, 359.0, "nearest", "nearest"))
    finally:
        trot._rotate = real
    angles = trot.draw_angles(seeds, 2, 1.0, 359.0)
    want = tgeo.shear_params(_t(angles.reshape(-1)), 64)
    got = trot.host_shifts(angles, 64, "cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and torch.equal(g, w)
    assert out["images"].shape == (3, 2, 64, 64, 4)
    assert seen["shifts"] is None and nearest["images"].shape == (3, 2, 64,
                                                                  64, 4)


# -- the mask, cleanup, enhance and crop steps --------------------------------

MASK_RANGES = [(0, 0, 0, 180, 255, 120), (20, 50, 50, 40, 255, 255)]


def jax_device_fn(step, batch, static, jit):
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if jit:
        return step._jitted()(step, jbatch, static)
    with jax.disable_jit():
        return step.device_fn(jbatch, static)


def torch_batch(batch, host=("seed",)):
    return {k: v if k in host else _t(v) for k, v in batch.items()}


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("options", [
    {"color_ranges_to_exclude_hsv": MASK_RANGES},
    {"color_ranges_to_exclude_hsv": MASK_RANGES,
     "zones": [None, (4, 6, 2, 3)]},
    {"color_ranges_to_exclude_hsv": [(200, 30, 45, 300, 100, 99.5)],
     "use_gimp_scale": True}], ids=["two", "zones", "gimp"])
def test_colormask_device_fn_matches_jax(options, jit):
    img, hs, ws = masked_batch(np.random.default_rng(31), 6, 64, 96, 3)
    batch = {"image": img, "size": np.stack([hs, ws], 1)}
    jstep, tstep = (m.ColorMaskTransparency()
                    for m in (jtransforms, ttransforms))
    static = tstep.static_args(options, ())
    assert static == jstep.static_args(options, ())
    got = tstep.device_fn(torch_batch(batch), static)
    assert_same(got, jax_device_fn(jstep, batch, static, jit), "colormask")


def test_colormask_rejects_bad_options(tmp_path):
    step = ttransforms.ColorMaskTransparency()
    with pytest.raises(ValueError, match="color_ranges_to_exclude_hsv"):
        step.load_item((tmp_path / "a.png",), {})
    with pytest.raises(ValueError, match="color_ranges_to_exclude_hsv"):
        step.probe_item((tmp_path / "a.png",), {})
    with pytest.raises(ValueError, match="must match filters"):
        step.static_args({"color_ranges_to_exclude_hsv": MASK_RANGES,
                          "zones": [None]}, ())


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("options", [{}, {"min_component_size": 30,
                                          "keep_large_components": True}],
                         ids=["largest", "keep_large"])
def test_cleanup_device_fn_matches_jax(options, jit):
    rng = np.random.default_rng(32)
    img, hs, ws = masked_batch(rng, 5, 64, 96, 4)
    img[..., 3] = np.where(rng.random(img.shape[:3]) > 0.45, 255, 0) \
        * (img[..., 0] > 0)
    img[0, ..., 3] = 0
    batch = {"image": img, "size": np.stack([hs, ws], 1)}
    jstep, tstep = (m.KeepLargestComponent()
                    for m in (jtransforms, ttransforms))
    static = tstep.static_args(options, ())
    assert static == jstep.static_args(options, ())
    got = tstep.device_fn(torch_batch(batch), static)
    assert_same(got, jax_device_fn(jstep, batch, static, jit), "cleanup")
    assert got["bh"][0] == 0 and (got["bh"][1:] > 0).all()


def test_enhance_factors_are_the_jitted_jax_draws():
    from image_processor_pipeline_tpu.transforms import enhance as jenh
    from image_processor_pipeline_tpu_torch.transforms import enhance as tenh

    seeds = np.random.default_rng(33).integers(0, 2**31, 3000).astype(
        np.uint32)
    want = jenh._factors_batch(seeds)
    b, c, col, sigma, gains = tenh.draw_factors(seeds)
    got = np.concatenate([np.stack([b, c, col, sigma], -1), gains], -1)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_enhance_device_fn_matches_jax_eager_given_the_factors():
    """The step's device_fn against the JAX package's enhance called
    eagerly with the jitted factor draws, blur and gains as flagged (with
    jit disabled the JAX step would draw other factors, F5)."""
    from image_processor_pipeline_tpu.ops import photometric as jphoto
    from image_processor_pipeline_tpu.transforms import enhance as jenh

    rng = np.random.default_rng(34)
    img, hs, ws = masked_batch(rng, 8, 64, 96, 3)
    seeds = rng.integers(0, 2**31, 8).astype(np.uint32)
    blur, rgb = np.arange(8) % 2 == 0, np.arange(8) % 4 < 2
    factors = jenh._factors_batch(seeds)
    with jax.disable_jit():
        want = np.stack([np.asarray(jphoto.enhance(
            jnp.asarray(img[i]), hs[i], ws[i], *factors[i, :4],
            bool(blur[i]), jnp.asarray(factors[i, 4:]), bool(rgb[i]),
            blur_max_radius=jphoto.box_radius_bound(3.0),
            blur_sigma_max=3.0)) for i in range(8)])
    got = ttransforms.EnhanceImage().device_fn(torch_batch({
        "image": img, "size": np.stack([hs, ws], 1), "apply_blur": blur,
        "apply_rgb": rgb, "seed": seeds}), ())
    assert sorted(got) == ["image"]
    np.testing.assert_array_equal(got["image"].numpy(), want)


@pytest.mark.parametrize("jit", [False, True], ids=["eager", "jit"])
@pytest.mark.parametrize("step", ["BorderCrop", "FitCrop"])
@pytest.mark.parametrize("C", [3, 4])
def test_crop_steps_device_fn_matches_jax(step, C, jit):
    rng = np.random.default_rng(35 + C)
    img, hs, ws = masked_batch(rng, 6, 64, 96, C)
    img[1] = 0                      # an empty bbox keeps the extent
    img[2, :10] = 0                 # content off the origin
    img[2, :, :7] = 0
    batch = {"image": img, "size": np.stack([hs, ws], 1)}
    if step == "BorderCrop":
        batch["margins"] = rng.integers(0, 6, (6, 4)).astype(np.int32)
    jstep, tstep = (getattr(m, step)() for m in (jtransforms, ttransforms))
    got = tstep.device_fn(torch_batch(batch), ())
    assert_same(got, jax_device_fn(jstep, batch, (), jit), step)


def test_crop_margins_and_format_gates_match_jax(tmp_path):
    from image_processor_pipeline_tpu.transforms import recadrages as jrec
    from image_processor_pipeline_tpu_torch.transforms import recadrages as trec

    for value, total in ((0, 50), (0.1, 50), (0.999, 7), (1, 50), (3.7, 50),
                         (0.3, 33)):
        assert trec.compute_crop_px(value, total) \
            == jrec.compute_crop_px(value, total)
    with pytest.raises(ValueError, match="negative"):
        trec.compute_crop_px(-0.1, 50)
    rng = np.random.default_rng(36)
    Image.fromarray(make_image(rng, 40, 56)).save(tmp_path / "a.jpg")
    Image.fromarray(make_image(rng, 40, 56)).save(tmp_path / "a.png")
    Image.fromarray(make_image(rng, 40, 56, 4)).save(tmp_path / "b.png")
    options = {"crop_margins": (0.1, 2, 0.05, 3)}
    for mod in (jrec, trec):
        step = mod.BorderCrop()
        for load in (step.load_item, step.probe_item):
            item = load((tmp_path / "a.jpg",), options)
            assert item["margins"].tolist() == [4, 2, 2, 3]
            assert step.bucket_key(item, options) == (128, 128, 3)
            with pytest.raises(ValueError, match="not a JPG"):
                load((tmp_path / "a.png",), options)
            with pytest.raises(ValueError, match="too large"):
                load((tmp_path / "a.jpg",), {"crop_margins": (0.5, 0.5, 0, 0)})
        step = mod.FitCrop()
        assert step.bucket_key(step.probe_item((tmp_path / "b.png",), {}),
                               {}) == (128, 128, 4)
        assert step.bucket_key(step.load_item((tmp_path / "a.jpg",), {}),
                               {}) == (128, 128, 3)
    got = trec.crop_to_alpha_bounding_box(tmp_path / "b.png")
    np.testing.assert_array_equal(
        got, jrec.crop_to_alpha_bounding_box(tmp_path / "b.png"))
    assert got.shape[2] == 4 and (got[..., 3] > 0).any()
    for path, error in ((tmp_path / "a.jpg", ValueError),
                        (tmp_path / "a.png", AttributeError)):
        with pytest.raises(error):
            trec.crop_to_alpha_bounding_box(path)


def test_cleanup_format_gates_match_jax(tmp_path):
    rng = np.random.default_rng(37)
    Image.fromarray(make_image(rng, 40, 56)).save(tmp_path / "rgb.png")
    Image.fromarray(make_image(rng, 40, 56)).save(tmp_path / "a.jpg")
    Image.fromarray(make_image(rng, 40, 56, 4)).save(tmp_path / "rgba.png")
    for mod in (jtransforms, ttransforms):
        step = mod.KeepLargestComponent()
        for load in (step.load_item, step.probe_item):
            with pytest.raises(ValueError, match="not a PNG"):
                load((tmp_path / "a.jpg",), {})
            with pytest.raises(AttributeError, match="no alpha"):
                load((tmp_path / "rgb.png",), {})
            item = load((tmp_path / "rgba.png",), {})
            assert item["size"].tolist() == [40, 56]


def test_transforms_export_what_the_jax_package_exports_so_far():
    assert set(ttransforms.__all__) == set(jtransforms.__all__)
    assert len(ttransforms.__all__) == 25
    for name in ("FusedChain", "EnhanceImage", "ColorMaskTransparency",
                 "BorderCrop", "FitCrop", "KeepLargestComponent",
                 "PasteOverlayOntoBackground", "OverlaysBorderCrop",
                 "frame_extraction", "process_overlay_pair",
                 "RotationsSymmetries", "RotationsChain", "RotSymChain",
                 "ChainSymmetries", "SymmetriesChain",
                 "RotationsChainSymmetries", "SymmetriesChainSymmetries"):
        assert name in ttransforms.__all__ and hasattr(ttransforms, name)


# -- pipelines C and E through both engines -----------------------------------

def build_mask_and_crop_pipelines(pkg, transforms, root, pngs, jpgs,
                                  **step_kw):
    """Pipeline C (BASELINE.json's config 3: color mask, then cleanup) over
    PNGs and E (enhance with the 'sample' pairing's flags, border crop,
    fit crop) over JPEGs, with the same seeds in either package."""
    options = step_kw.pop("options", {})
    step = pkg.ProcessingStep
    c = pkg.ProcessingPipeline(root_dir=root / "C")
    c.add_step(step("mask", transforms.ColorMaskTransparency(),
                    input_dirs=[pngs], output_dirs=["mask"], seed=3,
                    save_log=True, options=dict(
                        options, color_ranges_to_exclude_hsv=MASK_RANGES,
                        output_prefix="m"), **step_kw))
    c.add_step(step("clean", transforms.KeepLargestComponent(),
                    output_dirs=["clean"], seed=3, save_log=True,
                    options=dict(options, min_component_size=20), **step_kw))
    e = pkg.ProcessingPipeline(root_dir=root / "E")
    e.add_step(step("enhance", transforms.EnhanceImage(), input_dirs=[jpgs],
                    output_dirs=["enhance"], seed=4, pairing_method="sample",
                    save_log=True, options=dict(options), **step_kw))
    e.add_step(step("border", transforms.BorderCrop(), output_dirs=["border"],
                    seed=4, save_log=True, options=dict(
                        options, crop_margins=(0.1, 2, 0.05, 3)), **step_kw))
    e.add_step(step("fit", transforms.FitCrop(), output_dirs=["fit"], seed=4,
                    save_log=True, options=dict(options), **step_kw))
    return c, e


@pytest.fixture(scope="module")
def mask_and_crop_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mask_crop")
    pngs, _ = make_dataset(base / "data", 16, seed=22)
    jpgs = base / "data" / "jpgs"
    jpgs.mkdir()
    for path in sorted(pngs.iterdir()):
        Image.open(path).save(jpgs / f"{path.stem}.jpg", quality=90)
    runs = {}
    for name, pkg, transforms, kw in (
            ("jax", jpkg, jtransforms,
             {"options": {"native_compute": False}}),
            ("torch", tpkg, ttransforms, {"device": "cpu"})):
        c, e = build_mask_and_crop_pipelines(pkg, transforms, base / name,
                                             pngs, jpgs, **kw)
        runs[name] = (base / name, c.run(progress=False)
                      + e.run(progress=False), e.steps[0])
    return runs


def test_mask_and_crop_pipelines_give_the_same_statuses_and_reports(
        mask_and_crop_runs):
    jroot, jcounts, _ = mask_and_crop_runs["jax"]
    troot, tcounts, _ = mask_and_crop_runs["torch"]
    assert tcounts == jcounts == [Counter(Success=16)] * 5
    assert reports(troot) == reports(jroot)


def enhance_items_named_under_f5(step):
    """Names of the enhance step's items that were blurred with a sigma
    whose box weights differ under jit (F5); and how many were blurred."""
    from image_processor_pipeline_tpu_torch.transforms import enhance as tenh
    from torch_port_data import blur_differs_under_jit

    logs = sorted(step.process_logs, key=lambda e: str(e["inputs"][0]))
    seeds = (4 + np.arange(len(logs))) & 0x7FFFFFFF
    sigma = tenh.draw_factors(seeds.astype(np.uint32))[3]
    blurred = np.asarray([bool(e["inputs"][1]) for e in logs])
    named = blurred & blur_differs_under_jit(sigma)
    return ({Path(logs[i]["inputs"][0]).name
             for i in np.flatnonzero(named)}, int(blurred.sum()))


@pytest.mark.parametrize("directory", ["C/mask", "C/clean", "E/enhance",
                                       "E/border", "E/fit"])
def test_mask_and_crop_pipelines_give_the_same_files(mask_and_crop_runs,
                                                     directory):
    """Decoded pixels equal, but for an enhance item named under F5 and
    what the later steps make of it: these files are JPEGs of pixels that
    differ by a grey level, and are held to their shape (the fused chain's
    tests hold such an item to one grey level, in PNG)."""
    jroot, _, _ = mask_and_crop_runs["jax"]
    troot, _, enhance_step = mask_and_crop_runs["torch"]
    named, n_blurred = enhance_items_named_under_f5(enhance_step)
    assert n_blurred > len(named)
    names = assert_same_files(
        jroot / directory, troot / directory, 16,
        named=named if directory[0] == "E" else (), levels=None)
    assert all(n.startswith("m_") for n in names) == (directory[0] == "C")
    if directory == "C/clean":
        alphas = [np.asarray(Image.open(troot / directory / n))[..., 3]
                  for n in names]
        assert any((a == 0).any() for a in alphas)
        assert all((a == 255).any() for a in alphas)


# -- bilinear rotations -------------------------------------------------------

@pytest.mark.parametrize("seed,C", [(0, 3), (1, 4), (2, 4)])
def test_rotate_expand_bilinear_matches_jax_eager(seed, C):
    """The float32 bilinear form the engines run (traced angles): extents
    exact; pixels byte for byte on the angles whose float32 cos and sin
    agree bitwise between torch and XLA (F1), at most 0.1 % of an item's
    values elsewhere."""
    rng = np.random.default_rng(seed)
    B, H = 12, 96
    img = np.zeros((B, H, H, C), np.uint8)
    hs = rng.integers(20, 60, B).astype(np.int32)
    ws = rng.integers(20, 60, B).astype(np.int32)
    for i in range(B):
        im = make_image(rng, hs[i], ws[i], C)
        if C == 4:
            im[..., 3] = rng.integers(0, 256, (hs[i], ws[i]))
        img[i, :hs[i], :ws[i]] = im
    angles = rng.uniform(1, 359, B).astype(np.float32)
    with jax.disable_jit():
        want = jax.vmap(lambda i, h, w, a: jgeo.rotate_expand(
            i, h, w, a, "bilinear"))(jnp.asarray(img), hs, ws, angles)
    got = tgeo.rotate_expand(_t(img), _t(hs), _t(ws), _t(angles), "bilinear")
    for k in (1, 2):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    share = (got[0].numpy() != np.asarray(want[0])).reshape(B, -1).mean(-1)
    same = trig_agrees(angles)
    assert same.sum() >= B // 2 and share[same].max() == 0
    assert share.max() <= 1e-3
    assert np.abs(got[0].numpy().astype(int)
                  - np.asarray(want[0])).max() <= (1 if C == 3 else 255)


def pil_rotate_cases():
    for C in (1, 3, 4):
        for h, w in ((40, 56), (33, 17), (64, 64)):
            for angle in (0.0, 90.0, 180.0, 270.0, 1.0, 30.0, 44.99, 45.0,
                          123.456, 200.5, 359.0, -17.25, 400.0):
                yield C, h, w, angle


@pytest.mark.parametrize("C", [1, 3, 4])
def test_rotate_bilinear_exact_equals_pillow(C):
    """Bit for bit against Image.rotate(angle, expand=True, BILINEAR)
    itself, quarter turns and the symmetric angles included: the float64
    form is Pillow's own arithmetic, so it has no degenerate set."""
    rng = np.random.default_rng(40 + C)
    for channels, h, w, angle in pil_rotate_cases():
        if channels != C:
            continue
        im = rng.integers(0, 256, (h, w, C), np.uint8)
        canvas = np.zeros((128, 128, C), np.uint8)
        canvas[:h, :w] = im
        ref = Image.fromarray(im[..., 0] if C == 1 else im).rotate(
            angle, expand=True, resample=Image.BILINEAR)
        want = np.asarray(ref).reshape(ref.size[1], ref.size[0], C)
        out, nh, nw = tgeo.rotate_bilinear_exact(_t(canvas), angle, h, w)
        assert (nh, nw) == want.shape[:2], (h, w, angle)
        np.testing.assert_array_equal(out.numpy()[:nh, :nw], want,
                                      err_msg=f"{h}x{w} by {angle}")
        assert not out.numpy()[nh:].any() and not out.numpy()[:, nw:].any()


@pytest.mark.parametrize("C", [3, 4])
def test_rotate_bilinear_exact_against_the_jax_double_double_form(C):
    """Against the JAX package's _rotate_bilinear_exact: the same extents
    and matrix, quarter turns equal, and elsewhere equal on all but a few
    pixels (at most 1 % of an image), where the double-double value and
    Pillow's double fall on either side of a floor, a fill edge or the
    final truncation (that package's own tests allow for this set:
    tests/test_ops_geometry.py::TestRotateBilinear).  There one form has a
    pixel and the other the fill, or the two differ by one in Pillow's
    compute domain, and the port has Pillow's value (the test above)."""
    rng = np.random.default_rng(50 + C)
    differing = 0
    for channels, h, w, angle in pil_rotate_cases():
        if channels != C:
            continue
        im = rng.integers(0, 256, (h, w, C), np.uint8)
        canvas = np.zeros((128, 128, C), np.uint8)
        canvas[:h, :w] = im
        out, nh, nw = tgeo.rotate_bilinear_exact(_t(canvas), angle, h, w)
        jout, jnh, jnw = jgeo._rotate_bilinear_exact(
            jnp.asarray(canvas), float(angle), h, w)
        assert (int(jnh), int(jnw)) == (nh, nw)
        ours = out.numpy().astype(int)
        theirs = np.asarray(jout).astype(int)
        diff = np.abs(ours - theirs)
        if angle % 90.0 == 0.0:
            assert not diff.any()
            continue
        assert tgeo._pil_rotate_matrix(w, h, angle) \
            == jgeo._pil_rotate_matrix(w, h, angle)
        assert diff.any(-1).sum() <= 0.01 * nh * nw, (h, w, angle)
        differing += int(diff.any(-1).sum())
    assert differing > 0   # the set is not empty: the two forms do differ


@pytest.mark.parametrize("engine", ["device_fn", "pipeline"])
def test_rotations_step_takes_bilinear(engine, tmp_path):
    """RandomRotations(interpolation="bilinear"): the step's device_fn
    against the JAX step's run eagerly with JAX's angles; and the step
    through both engines, names and sizes equal, pixels equal but for at
    most 0.1 % of a file's values (the jitted JAX engine contracts the
    blends, F5, and its trig is XLA's, F1)."""
    if engine == "device_fn":
        B, N, H = 4, 3, 96
        img, hs, ws, seeds = rotation_batch(6, B, H)
        with jax.disable_jit():
            want = jax.vmap(lambda i, h, w, s: jrot._rotate_one(
                i, h, w, s, N, 1.0, 359.0, "nearest", "bilinear"))(
                jnp.asarray(img), hs, ws, seeds)
        angles = np.asarray(want["angles"])
        got = trot._rotate(_t(img), _t(hs), _t(ws), _t(angles), "nearest",
                           "bilinear")
        for k in ("heights", "widths"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        share = (got["images"].numpy() != np.asarray(want["images"])
                 ).reshape(B, N, -1).mean(-1)
        same = trig_agrees(angles)
        assert same.any() and share[same].max() == 0 and share.max() <= 1e-3
        return
    src = tmp_path / "src"
    src.mkdir()
    rng = np.random.default_rng(9)
    for i in range(4):
        Image.fromarray(make_image(rng, 40 + 8 * i, 56, 4)).save(
            src / f"a{i}.png")
    for pkg, transforms, kw in ((jpkg, jtransforms, {
            "options": {"native_compute": False}}),
            (tpkg, ttransforms, {"device": "cpu"})):
        options = dict(kw.pop("options", {}), num_rotations=3,
                       interpolation="bilinear")
        step = pkg.ProcessingStep("rot", transforms.RandomRotations(),
                                  input_dirs=[src],
                                  output_dirs=[tmp_path / pkg.__name__],
                                  seed=2, options=options, **kw)
        assert step.run(progress=False) == Counter(Success=4)
    jdir, tdir = tmp_path / jpkg.__name__, tmp_path / tpkg.__name__
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir()) and len(names) == 16
    for name in names:
        got = np.asarray(Image.open(tdir / name))
        want = np.asarray(Image.open(jdir / name))
        assert got.shape == want.shape, name
        assert (got != want).mean() <= 1e-3, name
