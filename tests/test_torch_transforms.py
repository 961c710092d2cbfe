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

import json
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
from torch_port_data import make_dataset, make_image


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
    with pytest.raises(NotImplementedError, match="bilinear"):
        trot._rotate(_t(img), _t(hs), _t(ws), angles, "nearest", "bilinear")


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


def reports(root):
    """Every step's report entries with the run's root taken out."""
    out = {}
    for path in sorted(root.rglob("*.json")):
        if path.name.endswith(".metrics.json"):
            continue
        entries = json.loads(path.read_text().replace(str(root), "ROOT"))
        out[path.name] = sorted(entries, key=lambda e: e["inputs"])
    return out


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
