"""The port's fused chain (transforms/fused.py) against the JAX package's,
on the CPU, at 40 to 96 px.

Draws: each stage's ``draw`` for a batch of keys equals the JAX stage's
jitted draw bit for bit.  Pixels: each stage's ``apply`` equals the JAX
stage's ``apply`` run eagerly item by item and given those draws (with jit
disabled ``jax.random.uniform`` rounds twice, F5, and the blends under jit
are contracted, F5), byte for byte; ``Rotate(method="shear")`` is given
JAX's shift vectors (F1), ``Rotate(method="nearest")`` is exact where
torch's and XLA's float32 cos and sin agree bitwise.  Whole chains: the
cases of tests/test_fused.py and a five-stage chain run through both
engines (the JAX engine on its jit path, ``native_compute=False``) and
must give the same names, statuses, report entries and decoded pixels;
a blurred item whose box weights differ under jit (F5,
``torch_port_data.blur_differs_under_jit``) is named and held to one grey
level and 95 % of its values instead.
"""

import io
from collections import Counter

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
from image_processor_pipeline_tpu.transforms import fused as jfused
from image_processor_pipeline_tpu_torch import interop
from image_processor_pipeline_tpu_torch import random as trandom
from image_processor_pipeline_tpu_torch.ops import geometry as tgeo
from image_processor_pipeline_tpu_torch.transforms import fused as tfused
from torch_port_data import (assert_same_files, blur_differs_under_jit,
                             make_image, reports)

SEEDS = np.arange(4000, dtype=np.uint32) * 7 + 1
MASK_RANGES = [(0, 0, 0, 180, 255, 120), (20, 50, 50, 40, 255, 255)]


def _t(a):
    return torch.as_tensor(np.array(a))


def stage_keys(seeds, index):
    return trandom.fold_in(trandom.PRNGKey(np.asarray(seeds, np.uint32)),
                           index)


def jax_draws(stage, seeds, index):
    """The JAX stage's draws as the engine makes them: jitted, from
    fold_in(PRNGKey(seed), index)."""
    out = jax.jit(jax.vmap(lambda s: stage.draw(
        jax.random.fold_in(jax.random.PRNGKey(s), index))))(
        jnp.asarray(seeds, jnp.uint32))
    return jax.tree_util.tree_map(np.asarray, out)


# -- draws --------------------------------------------------------------------

@pytest.mark.parametrize("index", [0, 3])
@pytest.mark.parametrize("name,args", [
    ("Rotate", ()), ("Rotate", (-30.0, 30.0)), ("Flip", ()),
    ("Flip", (("h", "hv", "o"),)), ("Enhance", ()), ("Enhance", (0.5, 0.9))])
def test_stage_draws_are_the_jitted_jax_draws(name, args, index):
    want = jax_draws(getattr(jfused, name)(*args), SEEDS, index)
    got = getattr(tfused, name)(*args).draw(stage_keys(SEEDS, index))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    if name == "Enhance":
        p_blur = args[0] if args else 0.3
        assert abs(got[5].mean() - p_blur) < 0.03


def test_stages_that_draw_nothing():
    keys = stage_keys(SEEDS[:4], 0)
    for stage in (tfused.ColorMask(MASK_RANGES), tfused.Cleanup(),
                  tfused.FitCrop(), tfused.BorderCrop()):
        assert stage.draw(keys) is None


def test_stage_configs_and_anchors_match_jax():
    for name, args in (("Rotate", (2.0, 90.0, "shear")), ("Flip", (("h",),)),
                       ("Enhance", (0.2, 0.4)),
                       ("ColorMask", (MASK_RANGES, [None, (1, 2, 3, 4)])),
                       ("ColorMask", ([(100, 30, 45, 240, 100, 99.5)], None,
                                      True, "replace")),
                       ("Cleanup", (50, True)), ("FitCrop", ()),
                       ("BorderCrop", ((0.1, 2, 0.25, 7),))):
        j, t = getattr(jfused, name)(*args), getattr(tfused, name)(*args)
        assert t.config() == j.config(), name
        assert t.pil_anchored == j.pil_anchored, name
        assert t.needs_diag_canvas == j.needs_diag_canvas, name
    with pytest.raises(ValueError, match="zones must match"):
        tfused.ColorMask(MASK_RANGES, zones=[None])
    with pytest.raises(ValueError, match="input_alpha"):
        tfused.ColorMask(MASK_RANGES, input_alpha="add")


# -- apply, stage by stage ----------------------------------------------------

def canvas_batch(seed, B, H, diag=False, transparent=True):
    """RGBA canvases [B, H, H, 4] with per-item extents, zero outside them,
    alpha 0 or 255 in blobs; with ``diag`` the extents leave room for the
    image diagonal.  Item 0 is fully transparent when asked."""
    rng = np.random.default_rng(seed)
    top = int(H / np.sqrt(2)) if diag else H
    hs = rng.integers(top // 2, top + 1, B).astype(np.int32)
    ws = rng.integers(top // 2, top + 1, B).astype(np.int32)
    img = np.stack([make_image(rng, H, H, 4) for _ in range(B)])
    img[..., 3] = np.where(img[..., 0] > 90, 255, 0)
    yy, xx = np.mgrid[0:H, 0:H]
    img *= ((yy[None] < hs[:, None, None])
            & (xx[None] < ws[:, None, None]))[..., None]
    if transparent:
        img[0, ..., 3] = 0
    return img, hs, ws


def jax_apply(stage, img, hs, ws, draws):
    """The JAX stage's apply, eager, item by item, ``draw`` giving each
    item its row of ``draws``."""
    outs = []
    with jax.disable_jit():
        for i in range(len(img)):
            row = jax.tree_util.tree_map(lambda d: jnp.asarray(d[i]), draws)
            stage.draw = lambda key, row=row: row
            outs.append(stage.apply(jnp.asarray(img[i]), hs[i], ws[i], None))
    return [np.stack([np.asarray(o[k]) for o in outs]) for k in range(3)]


def assert_stage_equal(got, want, what):
    for g, w, part in zip(got, want, ("image", "h", "w")):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        assert g.shape == w.shape, (what, part)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {part}")


@pytest.mark.parametrize("seed,H", [(0, 64), (1, 96)])
def test_rotate_shear_apply_matches_jax_given_its_vectors(seed, H):
    img, hs, ws = canvas_batch(seed, 5, H, diag=True)
    seeds = SEEDS[:5] + seed
    angles = jax_draws(jfused.Rotate(method="shear"), seeds, 0)
    want = jax_apply(jfused.Rotate(method="shear"), img, hs, ws, angles)
    shifts = interop.shifts_from_jax(*jax.vmap(
        lambda a: jgeo.shear_params(a, H))(angles))
    stage = tfused.Rotate(method="shear")
    got = stage.apply(_t(img), _t(hs), _t(ws), angles, shifts=shifts)
    assert_stage_equal(got, want, f"Rotate shear H={H}")
    assert got[1][0] == H and got[2][0] == H   # the empty-bbox rule
    # the port's own vectors, computed on the host: the same here
    own = stage.apply(_t(img), _t(hs), _t(ws), angles)
    assert_stage_equal(own, want, f"Rotate shear H={H}, own vectors")


def trig_agrees(angles):
    theta = jnp.deg2rad(jnp.asarray(angles, jnp.float32))
    t = _t(angles) * tgeo._DEG2RAD
    return (np.asarray(jnp.cos(theta)) == torch.cos(t).numpy()) \
        & (np.asarray(jnp.sin(theta)) == torch.sin(t).numpy())


def test_rotate_nearest_apply_matches_jax():
    """Extents exact; pixels byte for byte on the angles whose float32 cos
    and sin agree bitwise between torch and XLA (F1), at most 0.1 % of an
    item's pixels elsewhere (found: 0)."""
    img, hs, ws = canvas_batch(2, 6, 96, diag=True)
    angles = jax_draws(jfused.Rotate(), SEEDS[:6], 1)
    want = jax_apply(jfused.Rotate(), img, hs, ws, angles)
    got = tfused.Rotate().apply(_t(img), _t(hs), _t(ws), angles)
    for k in (1, 2):
        np.testing.assert_array_equal(got[k].numpy(), want[k])
    share = (got[0].numpy() != want[0]).any(-1).reshape(6, -1).mean(-1)
    same = trig_agrees(angles)
    assert same.any() and share[same].max() == 0 and share.max() <= 1e-3


@pytest.mark.parametrize("pool", [("o", "h", "v", "hv"), ("hv", "h"), ("o",)])
def test_flip_apply_matches_jax(pool):
    img, hs, ws = canvas_batch(3, 8, 64)
    idx = jax_draws(jfused.Flip(pool), SEEDS[:8], 2)
    want = jax_apply(jfused.Flip(pool), img, hs, ws, idx)
    got = tfused.Flip(pool).apply(_t(img), _t(hs), _t(ws), idx)
    assert_stage_equal(got, want, f"Flip {pool}")
    assert len(pool) == 1 or len(set(idx.tolist())) > 1


@pytest.mark.parametrize("seed", [0, 1])
def test_enhance_apply_matches_jax(seed):
    """Brightness, contrast over the valid region, colour, blur and gains
    as drawn (probabilities raised so that both branches occur), alpha
    carried and masked."""
    img, hs, ws = canvas_batch(4 + seed, 8, 64, transparent=False)
    draws = jax_draws(jfused.Enhance(0.6, 0.6), SEEDS[:8] + seed, 2)
    assert draws[5].any() and not draws[5].all()
    assert draws[6].any() and not draws[6].all()
    want = jax_apply(jfused.Enhance(0.6, 0.6), img, hs, ws, draws)
    got = tfused.Enhance(0.6, 0.6).apply(_t(img), _t(hs), _t(ws), draws)
    assert_stage_equal(got, want, "Enhance")


@pytest.mark.parametrize("input_alpha", ["combine", "replace"])
def test_colormask_apply_matches_jax(input_alpha):
    img, hs, ws = canvas_batch(6, 6, 64)
    args = (MASK_RANGES, [None, (3, 4, 5, 6)], False, input_alpha)
    want = jax_apply(jfused.ColorMask(*args), img, hs, ws, None)
    got = tfused.ColorMask(*args).apply(_t(img), _t(hs), _t(ws), None)
    assert_stage_equal(got, want, f"ColorMask {input_alpha}")
    alpha = got[0][..., 3]
    assert (alpha == 0).any() and (alpha == 255).any()


@pytest.mark.parametrize("keep_large", [False, True])
def test_cleanup_apply_matches_jax(keep_large):
    img, hs, ws = canvas_batch(7, 6, 64)
    want = jax_apply(jfused.Cleanup(30, keep_large), img, hs, ws, None)
    got = tfused.Cleanup(30, keep_large).apply(_t(img), _t(hs), _t(ws), None)
    assert_stage_equal(got, want, f"Cleanup keep_large={keep_large}")
    assert got[1][0] == 0 and got[2][0] == 0   # nothing opaque: extents 0


def test_fitcrop_apply_matches_jax():
    img, hs, ws = canvas_batch(8, 6, 64)
    want = jax_apply(jfused.FitCrop(), img, hs, ws, None)
    got = tfused.FitCrop().apply(_t(img), _t(hs), _t(ws), None)
    assert_stage_equal(got, want, "FitCrop")


@pytest.mark.parametrize("margins", [(0.1, 0.1, 0.1, 0.1), (0.3, 2, 0.07, 5),
                                     (1, 1.9, 0.999, 0), (0, 0, 0, 0)])
def test_bordercrop_apply_matches_jax(margins):
    """px() is a float32 multiply, then truncated: extents on which the
    float32 and the exact product fall on either side of an integer are
    among these (h = 50, margin 0.1 * 3; w up to 96)."""
    img, _, _ = canvas_batch(9, 8, 96, transparent=False)
    hs = np.asarray([50, 30, 70, 96, 10, 90, 47, 33], np.int32)
    ws = np.asarray([96, 50, 30, 70, 60, 10, 90, 47], np.int32)
    yy, xx = np.mgrid[0:96, 0:96]
    img *= ((yy[None] < hs[:, None, None])
            & (xx[None] < ws[:, None, None]))[..., None]
    want = jax_apply(jfused.BorderCrop(margins), img, hs, ws, None)
    got = tfused.BorderCrop(margins).apply(_t(img), _t(hs), _t(ws), None)
    assert_stage_equal(got, want, f"BorderCrop {margins}")


# -- whole chains through both engines ----------------------------------------

SIZES = ((40, 56), (64, 48), (56, 56), (40, 90))


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """12 RGB PNGs in four sizes under <root>/in."""
    root = tmp_path_factory.mktemp("fused")
    (root / "in").mkdir()
    rng = np.random.default_rng(3)
    for i in range(12):
        Image.fromarray(make_image(rng, *SIZES[i % 4])).save(
            root / "in" / f"f{i:02d}.png")
    return root


def run_chain(pkg, module, root, stages, out, seed=5, **options):
    """One FusedChain step of ``pkg`` over <root>/in into <root>/<out>."""
    chain = module.FusedChain([getattr(module, name)(*args)
                               for name, args in stages])
    kw = {"device": "cpu"} if pkg is tpkg else {}
    if pkg is jpkg:
        options = dict(options, native_compute=False)
    pipe = pkg.ProcessingPipeline(root_dir=root)
    pipe.add_step(pkg.ProcessingStep(
        name=f"fused_{out}", process_function=chain, input_dirs=["in"],
        output_dirs=[out], seed=seed, options=options, save_log=True, **kw))
    return pipe.run(progress=False)[0]


def blurred_items_named_under_f5(stages, n_items, seed):
    """File names of the items whose Enhance stage blurs with box weights
    that differ under jit: item i of the sorted inputs has the seed
    (seed + i) & 0x7FFFFFFF."""
    seeds = (seed + np.arange(n_items)) & 0x7FFFFFFF
    named = np.zeros(n_items, bool)
    blurred = np.zeros(n_items, bool)
    for index, (name, args) in enumerate(stages):
        if name == "Enhance":
            draws = tfused.Enhance(*args).draw(stage_keys(seeds, index))
            named |= draws[5] & blur_differs_under_jit(draws[3])
            blurred |= draws[5]
    return {f"f{i:02d}.png" for i in np.flatnonzero(named)}, blurred


CHAINS = {
    # the cases of tests/test_fused.py
    "rotate_flip_enhance": [("Rotate", ()), ("Flip", ()), ("Enhance", ())],
    "border_then_fit": [("BorderCrop", ((0.1, 0.1, 0.1, 0.1),)),
                        ("FitCrop", ())],
    "rotate_shear_fit": [("Rotate", (1.0, 359.0, "shear")), ("FitCrop", ())],
    "rotate_enhance": [("Rotate", ()), ("Enhance", ())],
    # pipeline D: every kind of stage but the crops
    "D": [("Rotate", (1.0, 359.0, "shear")), ("Flip", ()),
          ("ColorMask", (MASK_RANGES,)), ("Cleanup", (20,)),
          ("Enhance", (0.5, 0.5))],
}


@pytest.fixture(scope="module")
def chain_runs(inputs):
    runs = {}
    for name, stages in CHAINS.items():
        for tag, pkg, module in (("j", jpkg, jfused), ("t", tpkg, tfused)):
            runs[name, tag] = run_chain(pkg, module, inputs, stages,
                                        f"{tag}_{name}")
    return runs


@pytest.mark.parametrize("name", list(CHAINS))
def test_chain_gives_the_jax_engines_files(inputs, chain_runs, name):
    assert chain_runs[name, "t"] == chain_runs[name, "j"] \
        == Counter(Success=12)
    named, blurred = blurred_items_named_under_f5(CHAINS[name], 12, 5)
    names = assert_same_files(inputs / f"j_{name}", inputs / f"t_{name}", 12,
                              named=named)
    assert names == [f"f{i:02d}.png" for i in range(12)]
    if any(stage == "Enhance" for stage, _ in CHAINS[name]):
        # blurred items are among those compared exactly
        assert blurred.sum() > len(named)
    want = reports(inputs)
    assert want[f"fused_t_{name}.json"] == [
        {**e, "outputs": [o.replace(f"j_{name}", f"t_{name}")
                          for o in e["outputs"]]}
        for e in want[f"fused_j_{name}.json"]]


def test_chain_outputs_look_as_the_jax_tests_require(inputs, chain_runs):
    """The assertions of tests/test_fused.py on the port's files."""
    for i in range(12):
        h, w = SIZES[i % 4]
        arr = np.asarray(Image.open(
            inputs / "t_rotate_flip_enhance" / f"f{i:02d}.png"))
        assert arr.shape[2] == 4 and (arr.shape[0] > h or arr.shape[1] > w)
        arr = np.asarray(Image.open(
            inputs / "t_rotate_shear_fit" / f"f{i:02d}.png"))
        assert arr.shape[0] > h or arr.shape[1] > w
    arr = np.asarray(Image.open(inputs / "t_border_then_fit" / "f00.png"))
    assert arr.shape[:2] == (32, 46)  # 40-2*4, 56-2*5 margins
    differ = 0
    for i in range(12):
        out = np.asarray(Image.open(inputs / "t_D" / f"f{i:02d}.png"))
        assert (out[..., 3] == 0).any() or out.shape[0] < SIZES[i % 4][0]
        differ += out.shape != (*SIZES[i % 4], 4)
    assert differ == 12


def test_chain_is_deterministic_with_its_seed(inputs, chain_runs):
    run_chain(tpkg, tfused, inputs, CHAINS["rotate_enhance"], "t_again")
    run_chain(tpkg, tfused, inputs, CHAINS["rotate_enhance"], "t_other",
              seed=6)
    same = other = 0
    for i in range(12):
        a = np.asarray(Image.open(inputs / "t_rotate_enhance" / f"f{i:02d}.png"))
        b = np.asarray(Image.open(inputs / "t_again" / f"f{i:02d}.png"))
        c = np.asarray(Image.open(inputs / "t_other" / f"f{i:02d}.png"))
        same += a.shape == b.shape and np.array_equal(a, b)
        other += a.shape != c.shape or not np.array_equal(a, c)
    assert same == 12 and other == 12


def test_colormask_cleanup_chain_crops_the_object(tmp_path):
    (tmp_path / "in").mkdir()
    arr = np.zeros((48, 48, 3), np.uint8)
    arr[:, :] = (0, 250, 0)             # chroma background
    arr[10:38, 10:38] = (200, 30, 160)  # object
    arr[2, 44] = (200, 30, 160)         # isolated speck
    Image.fromarray(arr).save(tmp_path / "in" / "g.png")
    stages = [("ColorMask", ([(50, 100, 100, 70, 255, 255)],)),
              ("Cleanup", (100,))]
    for tag, pkg, module in (("j", jpkg, jfused), ("t", tpkg, tfused)):
        assert run_chain(pkg, module, tmp_path, stages, tag) \
            == Counter(Success=1)
    assert_same_files(tmp_path / "j", tmp_path / "t", 1)
    out = np.asarray(Image.open(tmp_path / "t" / "g.png"))
    assert out.shape == (28, 28, 4)  # tight-cropped object
    assert (out[..., 3] == 255).all()


def test_jpg_output_drops_alpha_and_bands_are_capped(inputs):
    stages = [("Enhance", ())]
    assert run_chain(tpkg, tfused, inputs, stages, "t_jpg",
                     output_suffix=".jpg") == Counter(Success=12)
    assert run_chain(jpkg, jfused, inputs, stages, "j_jpg",
                     output_suffix=".jpg") == Counter(Success=12)
    names = sorted(p.name for p in (inputs / "t_jpg").iterdir())
    assert names == sorted(p.name for p in (inputs / "j_jpg").iterdir()) \
        == [f"f{i:02d}.jpg" for i in range(12)]
    for name in names:
        with Image.open(inputs / "t_jpg" / name) as im, \
                Image.open(inputs / "j_jpg" / name) as jim:
            assert im.mode == "RGB" and im.size == jim.size
    run_chain(tpkg, tfused, inputs, stages, "t_bands", output_bands=3)
    run_chain(jpkg, jfused, inputs, stages, "j_bands", output_bands=3)
    named, _ = blurred_items_named_under_f5(stages, 12, 5)
    assert_same_files(inputs / "j_bands", inputs / "t_bands", 12, named=named)
    with Image.open(inputs / "t_bands" / "f00.png") as im:
        assert im.mode == "RGB"


def test_jpg_encoder_follows_the_final_stages_anchor(inputs):
    """A chain ending in a cv2-anchored stage (Flip) saves JPEG at quality
    95, one ending in a PIL-anchored stage (Enhance) at 75: the .png run of
    the same chain and seed gives the pixels, and each .jpg is Pillow's
    encoding of them at that quality (the port's native encoder writes
    Pillow's bytes)."""
    cases = [([("Enhance", ()), ("Flip", (("o",),))], 95),
             ([("Flip", (("o",),)), ("Enhance", ())], 75)]
    for stages, quality in cases:
        run_chain(tpkg, tfused, inputs, stages, f"q{quality}_png")
        run_chain(tpkg, tfused, inputs, stages, f"q{quality}_jpg",
                  output_suffix=".jpg")
        for i in range(12):
            rgb = np.asarray(Image.open(
                inputs / f"q{quality}_png" / f"f{i:02d}.png"))[..., :3]
            buf = io.BytesIO()
            Image.fromarray(rgb).save(buf, "JPEG", quality=quality)
            got = (inputs / f"q{quality}_jpg" / f"f{i:02d}.jpg").read_bytes()
            assert got == buf.getvalue(), (quality, i)


def test_fused_maskclean_equals_the_two_stage_pipeline(tmp_path):
    """ColorMask→Cleanup as ONE FusedChain step writes the files of the
    two-stage pipeline ColorMaskTransparency → KeepLargestComponent (these
    stages draw nothing and the intermediate PNG is lossless), in the port
    as in the JAX package, and the same files as the JAX package."""
    rng = np.random.default_rng(12)
    (tmp_path / "in").mkdir()
    hsv = [(100, 60, 60, 130, 255, 255)]
    for i in range(4):
        arr = rng.integers(0, 256, (40 + 5 * i, 64, 3), dtype=np.uint8)
        arr[10:30, 10:40] = (20, 30, 200)  # maskable block
        Image.fromarray(arr).save(tmp_path / "in" / f"m{i}.png")
    for tag, pkg, transforms, module in (
            ("j", jpkg, jtransforms, jfused), ("t", tpkg, ttransforms, tfused)):
        kw = {"device": "cpu"} if pkg is tpkg else {}
        opts = {"native_compute": False} if pkg is jpkg else {}
        pipe = pkg.ProcessingPipeline(root_dir=tmp_path)
        pipe.add_step(pkg.ProcessingStep(
            name="mask", process_function=transforms.ColorMaskTransparency(),
            input_dirs=["in"], output_dirs=[f"{tag}_mid"], seed=3,
            options=dict(opts, color_ranges_to_exclude_hsv=hsv), **kw))
        pipe.add_step(pkg.ProcessingStep(
            name="clean", process_function=transforms.KeepLargestComponent(),
            output_dirs=[f"{tag}_two_stage"], seed=3, options=opts, **kw))
        assert pipe.run(progress=False) == [Counter(Success=4)] * 2
        assert run_chain(pkg, module, tmp_path,
                         [("ColorMask", (hsv,)), ("Cleanup", ())],
                         f"{tag}_fused", seed=9) == Counter(Success=4)
    two = {p.name: p.read_bytes()
           for p in (tmp_path / "t_two_stage").iterdir()}
    one = {p.name: p.read_bytes() for p in (tmp_path / "t_fused").iterdir()}
    assert one == two and len(one) == 4
    assert_same_files(tmp_path / "j_fused", tmp_path / "t_fused", 4)
    assert_same_files(tmp_path / "j_two_stage", tmp_path / "t_two_stage", 4)


def test_empty_content_is_an_error_item(tmp_path):
    """A chain that leaves nothing opaque raises for that item, in both
    engines, with the same message."""
    (tmp_path / "in").mkdir()
    Image.fromarray(np.full((40, 40, 3), (0, 250, 0), np.uint8)).save(
        tmp_path / "in" / "green.png")
    stages = [("ColorMask", ([(50, 100, 100, 70, 255, 255)],)),
              ("Cleanup", ())]
    for tag, pkg, module in (("j", jpkg, jfused), ("t", tpkg, tfused)):
        assert run_chain(pkg, module, tmp_path, stages, tag) \
            == Counter(Error=1)
        assert not list((tmp_path / tag).iterdir())
    logs = reports(tmp_path)
    assert logs["fused_t.json"] == logs["fused_j.json"]
    assert "empty content" in logs["fused_t.json"][0]["error_message"]


def test_loader_asks_for_the_diagonal_canvas_only_with_a_rotate(tmp_path):
    Image.fromarray(make_image(np.random.default_rng(1), 100, 120)).save(
        tmp_path / "a.png")
    for stages, canvas in (([tfused.Rotate()], (256, 256)),
                           ([tfused.Flip()], (128, 128))):
        chain = tfused.FusedChain(stages)
        item = chain.load_item((tmp_path / "a.png",), {})
        probed = chain.probe_item((tmp_path / "a.png",), {})
        assert tuple(item["canvas"]) == tuple(probed["canvas"]) == canvas
        assert item["image"].shape == (*canvas, 4)
        assert item["size"].tolist() == probed["size"].tolist() == [100, 120]
    jchain = jfused.FusedChain([jfused.Rotate()])
    jitem = jchain.load_item((tmp_path / "a.png",), {})
    assert tuple(jitem["canvas"]) == (256, 256)
    t_static = tfused.FusedChain([tfused.Rotate(), tfused.Flip()]).static_args(
        {}, ())
    assert t_static == jfused.FusedChain(
        [jfused.Rotate(), jfused.Flip()]).static_args({}, ())
