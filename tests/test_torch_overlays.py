"""The port's overlay compositing (ops/compose.py, geometry.resize,
transforms/overlays.py, ovlborder.py, overlays_legacy.py) and the small
host helpers of this slice against Pillow and the JAX package, on the CPU.

Tolerances:
- ``geometry.resize`` equals ``PIL.Image.resize`` byte for byte (it is
  Pillow's fixed-point resample); the JAX package's float32 ``resize``
  is within its own ±2 of it.
- ``compose.alpha_paste`` equals JAX's and ``Image.paste`` byte for byte.
- The paste geometry (sizes, positions, ``ok``, ``xywhn``) equals the
  jitted JAX ``_draw_geometry`` exactly.
- Composite pixels equal the JAX package's native twin (Pillow's
  arithmetic) byte for byte, and its jit path within ±2 with at least
  99 % of the values equal.
- Whole pipelines (config 4 and ``OverlaysBorderCrop``, JPEG backgrounds)
  give the JAX engine's names, statuses, reports and label lines; decoded
  pixels equal the native-twin engine's (both JPEG codecs decode and
  encode these files alike on this host) and the jit engine's within 6
  grey levels on 95 % of the values (its ±2 composites re-quantized by
  the JPEG encode).
"""

import random
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
from image_processor_pipeline_tpu.ops import bbox as jbbox
from image_processor_pipeline_tpu.ops import compose as jcompose
from image_processor_pipeline_tpu.ops import geometry as jgeo
from image_processor_pipeline_tpu.ops import native_cpu
from image_processor_pipeline_tpu.transforms import overlays as jov
from image_processor_pipeline_tpu.transforms.crop_dummy import (
    crop_image as jcrop_image)
from image_processor_pipeline_tpu_torch import random as trandom
from image_processor_pipeline_tpu_torch.ops import bbox as tbbox
from image_processor_pipeline_tpu_torch.ops import compose as tcompose
from image_processor_pipeline_tpu_torch.ops import geometry as tgeo
from image_processor_pipeline_tpu_torch.transforms import overlays as tov
from image_processor_pipeline_tpu_torch.transforms.crop_dummy import (
    crop_image as tcrop_image)
from torch_port_data import make_image, reports

FILTERS = {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR}


def _canvas(arr, H, W):
    out = np.zeros((H, W, arr.shape[2]), np.uint8)
    out[:arr.shape[0], :arr.shape[1]] = arr
    return out


# -- resize ---------------------------------------------------------------------

RESIZE_CASES = [  # (h, w) -> (out_h, out_w)
    ((57, 83), (30, 45)),     # down
    ((57, 83), (100, 140)),   # up
    ((40, 64), (40, 97)),     # rows unchanged: Pillow skips that pass
    ((33, 48), (71, 48)),     # columns unchanged
    ((61, 1), (13, 7)),       # one column, odd sizes
    ((9, 95), (96, 3)),       # up one way, down the other
]


@pytest.mark.parametrize("method", ["lanczos", "bilinear"])
@pytest.mark.parametrize("size,out_size", RESIZE_CASES)
@pytest.mark.parametrize("mode", ["RGB", "RGBa"])
def test_resize_is_pillow_byte_for_byte(method, size, out_size, mode):
    """RGB, and premultiplied RGBa (what Image.resize resamples for an
    RGBA image); batched with a second item of other sizes, on a larger
    output canvas, zero outside the result."""
    rng = np.random.default_rng(sum(size) + sum(out_size))
    (h, w), (oh, ow) = size, out_size
    C = len(mode)
    arr = rng.integers(0, 256, (h, w, C), np.uint8)
    if mode == "RGBa":   # premultiplied: no value above its alpha
        arr[..., :3] = np.minimum(arr[..., :3], arr[..., 3:])
    other = rng.integers(0, 256, (20, 30, C), np.uint8)
    img = np.stack([_canvas(arr, 64, 128), _canvas(other, 64, 128)])
    out = tgeo.resize(torch.as_tensor(img), [h, 20], [w, 30], [oh, 25],
                      [ow, 11], method, out_canvas=(128, 160)).numpy()
    want = np.asarray(Image.frombytes(mode, (w, h), arr.tobytes())
                      .resize((ow, oh), FILTERS[method]))
    want = want.reshape(oh, ow, C)
    np.testing.assert_array_equal(out[0, :oh, :ow], want)
    assert not out[0, oh:].any() and not out[0, :, ow:].any()
    want1 = np.asarray(Image.frombytes(mode, (30, 20), other.tobytes())
                       .resize((11, 25), FILTERS[method])).reshape(25, 11, C)
    np.testing.assert_array_equal(out[1, :25, :11], want1)
    if mode == "RGB":   # the JAX package's float32 form, within its ±2
        jout = np.asarray(jgeo.resize(jnp.asarray(img[0]), h, w, oh, ow,
                                      method, out_canvas=(128, 160)))
        assert np.abs(jout.astype(int) - out[0]).max() <= 2


def test_resample_coeffs_are_pillows_normalized_taps():
    xmin, taps = tgeo.resample_coeffs(80, 37, "lanczos")
    assert taps.shape == (37, 2 * int(np.ceil(3 * 80 / 37)) + 1)
    assert (xmin >= 0).all() and taps.dtype == np.int64
    # each row sums to one in fixed point, up to the rounding of its taps
    assert np.abs(taps.sum(1) - (1 << tgeo.PRECISION_BITS)).max() \
        <= taps.shape[1]
    assert (taps < 0).any()   # lanczos lobes: rounded away from zero
    with pytest.raises(ValueError, match="unknown resize filter"):
        tgeo.resample_coeffs(8, 4, "cubic")


# -- alpha paste ------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_alpha_paste_equals_jax_and_pillow(seed):
    rng = np.random.default_rng(seed)
    B, H, W = 4, 48, 64
    bgs, ovs, args = [], [], []
    for _ in range(B):
        bh, bw = rng.integers(20, H + 1), rng.integers(20, W + 1)
        oh, ow = rng.integers(1, bh + 1), rng.integers(1, bw + 1)
        py, px = rng.integers(0, bh - oh + 1), rng.integers(0, bw - ow + 1)
        bg = _canvas(rng.integers(0, 256, (bh, bw, 3), np.uint8), H, W)
        ov = rng.integers(0, 256, (oh, ow, 4), np.uint8)
        ov[..., 3] = rng.choice([0, 255, 1, 128, 254], (oh, ow))
        bgs.append(bg)
        ovs.append(_canvas(ov, H, W))
        args.append((bh, bw, oh, ow, py, px))
    a = np.asarray(args, np.int32).T
    got = tcompose.alpha_paste(torch.as_tensor(np.stack(bgs)), *a[:2],
                               torch.as_tensor(np.stack(ovs)),
                               *(torch.as_tensor(v) for v in a[2:])).numpy()
    want = np.asarray(jcompose.alpha_paste_batch(
        jnp.asarray(np.stack(bgs)), *a[:2], jnp.asarray(np.stack(ovs)),
        *a[2:]))
    np.testing.assert_array_equal(got, want)
    for i, (bh, bw, oh, ow, py, px) in enumerate(args):
        pil = Image.fromarray(bgs[i][:bh, :bw])
        ov = Image.fromarray(ovs[i][:oh, :ow])
        pil.paste(ov, (int(px), int(py)), ov)
        np.testing.assert_array_equal(got[i, :bh, :bw], np.asarray(pil))
        assert not got[i, bh:].any() and not got[i, :, bw:].any()


# -- the paste geometry ------------------------------------------------------------

def _triples(n, seed):
    rng = np.random.default_rng(seed)
    seeds = rng.integers(0, 2**31, n).astype(np.uint32)
    ov = rng.integers(1, 1025, (n, 2)).astype(np.int32)
    bg = rng.integers(1, 4097, (n, 2)).astype(np.int32)
    q = n // 2   # half of them at config 4's scale
    ov[:q] = rng.integers(16, 200, (q, 2))
    bg[:q] = rng.integers(200, 1000, (q, 2))
    bg[:16] = ov[:16]          # spans of one: the overlay fills the bg
    ov[16:24, 0] = 1           # one-pixel-high overlays
    return seeds, ov, bg


SCALES = [(0.15, 0.30), (0.05, 0.9), (1.0, 1.0)]
DRAW_FIELDS = ("new_h", "new_w", "py", "px", "ok", "xywhn")


def draws_against_jax(n, seed, scale):
    """(port's draws, the jitted JAX engine's) over ``n`` triples."""
    seeds, ov, bg = _triples(n, seed)
    want = jov.PasteOverlayOntoBackground._native_draws(
        seeds, ov, bg, *scale)
    got = tov.draw_geometry(seeds, ov[:, 0], ov[:, 1], bg[:, 0], bg[:, 1],
                            *scale)
    return got, want


@pytest.mark.parametrize("scale", SCALES)
def test_draw_geometry_equals_the_jitted_jax_draws(scale):
    """A sample of the measurement this module runs as a script (PERF.md):
    every size, position, ok flag and label box equal to the engine's
    jitted draws."""
    got, want = draws_against_jax(20_000, int(scale[1] * 100), scale)
    for g, w, name in zip(got, want, DRAW_FIELDS):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[4].mean() > 0.5


@pytest.mark.parametrize("span_hi", [1, 2, 640])
def test_randint_with_per_item_bounds_equals_jax(span_hi):
    seeds = np.arange(3000, dtype=np.uint32) * 13 + 5
    hi = (np.arange(3000) % span_hi + 1).astype(np.int32)
    want = jax.jit(jax.vmap(lambda s, m: jax.random.randint(
        jax.random.PRNGKey(s), (), 0, m)))(seeds, hi)
    got = trandom.randint(trandom.PRNGKey(seeds), (), 0, hi)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert (got < hi).all() and (got >= 0).all()


# -- device_fn against the JAX step's ------------------------------------------------

def overlay_batch(seed, B=6):
    """Overlays (RGBA, alpha 0/128/255 blobs) and backgrounds on canvases,
    with per-item sizes; item 0's overlay is 1 x 200, too thin to paste
    on a background under 100 px wide."""
    rng = np.random.default_rng(seed)
    ovs, bgs, ov_size, bg_size = [], [], [], []
    for i in range(B):
        oh, ow = (1, 200) if i == 0 else tuple(rng.integers(12, 48, 2))
        bh, bw = rng.integers(40, 96, 2)
        ov = make_image(rng, oh, ow, 4) if oh > 4 else \
            rng.integers(0, 256, (oh, ow, 4), np.uint8)
        ov[..., 3] = np.where(ov[..., 3] > 0, 255,
                              rng.choice([0, 128], (oh, ow)))
        ovs.append(_canvas(ov, 48, 208))
        bgs.append(_canvas(make_image(rng, bh, bw), 96, 96))
        ov_size.append((oh, ow))
        bg_size.append((bh, bw))
    return {"overlay": np.stack(ovs), "background": np.stack(bgs),
            "ov_size": np.asarray(ov_size, np.int32),
            "bg_size": np.asarray(bg_size, np.int32),
            "seed": (np.arange(B) * 31 + seed).astype(np.uint32)}


def port_device_fn(transform, batch, static):
    tb = {k: (v if k in transform.host_fields else torch.as_tensor(v))
          for k, v in batch.items()}
    return {k: v.numpy() for k, v in transform.device_fn(tb, static).items()}


@pytest.mark.parametrize("seed,scale", [(0, (0.15, 0.30)), (1, (0.3, 0.9)),
                                        (2, (0.15, 0.30))])
def test_device_fn_equals_the_jax_steps(seed, scale):
    batch = overlay_batch(seed)
    got = port_device_fn(tov.PasteOverlayOntoBackground(), batch, scale)
    jt = jov.PasteOverlayOntoBackground()
    jit_out = jax.jit(lambda b: jt.device_fn(b, scale))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    for k in ("xywhn", "ok", "pos", "new_size"):
        np.testing.assert_array_equal(got[k], np.asarray(jit_out[k]),
                                      err_msg=k)
    assert not got["ok"][0] and got["ok"][1:].all()
    jimg = np.asarray(jit_out["image"]).astype(int)
    assert np.abs(got["image"].astype(int) - jimg).max() <= 2
    assert (got["image"] == jimg).mean() >= 0.99
    assert native_cpu.available()
    native = jt.native_fn(batch, scale, {})
    np.testing.assert_array_equal(got["image"], native["image"])
    # a degenerate item is its background, untouched
    np.testing.assert_array_equal(got["image"][0], batch["background"][0])


def test_same_size_resize_skips_the_premultiply_round_trip():
    """Image.resize returns a copy when the size does not change, so a
    semi-transparent overlay pasted at its own size keeps its colours."""
    rng = np.random.default_rng(4)
    ov = rng.integers(0, 256, (10, 12, 4), np.uint8)
    ov[..., 3] = 77
    bg = rng.integers(0, 256, (10, 12, 3), np.uint8)
    z = np.zeros(1, np.int32)
    got = tov.paste_overlays(
        torch.as_tensor(ov[None]), [10], [12], torch.as_tensor(bg[None]),
        [10], [12], [10], [12], z, z).numpy()[0]
    pil = Image.fromarray(bg)
    o = Image.fromarray(ov).resize((12, 10), Image.LANCZOS)
    pil.paste(o, (0, 0), o)
    np.testing.assert_array_equal(got, np.asarray(pil))


# -- whole pipelines through both engines ---------------------------------------

def write_overlay_inputs(root, n_ov=6, bg_ext=".jpg"):
    rng = np.random.default_rng(3)
    (root / "ov").mkdir(parents=True)
    (root / "bg").mkdir()
    for i in range(n_ov):
        ov = make_image(rng, 24 + 4 * i, 20 + 6 * i, 4)
        ov[..., 3] = np.where(ov[..., 3] > 0, 255, 0)
        ov[2:5, 2:5, 3] = 128
        Image.fromarray(ov).save(root / "ov" / f"ov{i}.png")
    for i, (h, w) in enumerate([(64, 96), (96, 64), (80, 80), (48, 120)]):
        im = Image.fromarray(make_image(rng, h, w))
        im.save(root / "bg" / f"bg{i}{bg_ext}",
                **({"quality": 92} if bg_ext == ".jpg" else {}))
    return root / "ov", root / "bg"


def build_config4(pkg, transforms, root, ov, bg, **kw):
    pipe = pkg.ProcessingPipeline(root_dir=root)
    pipe.add_step(pkg.ProcessingStep(
        "paste", transforms.PasteOverlayOntoBackground(),
        input_dirs=[ov, bg], output_dirs=["c4/i", "c4/l"],
        pairing_method="modulo", seed=6, save_log=True, **kw))
    pipe.add_step(pkg.ProcessingStep(
        "recrop", transforms.BorderCrop(), input_dirs=["c4/i"],
        output_dirs=["c4crop"], seed=7, fixed_input=True, save_log=True,
        options={"crop_margins": (0.05, 0.05, 0.05, 0.05)}, **kw))
    pipe.add_step(pkg.ProcessingStep(
        "ovlborder", transforms.OverlaysBorderCrop(),
        input_dirs=[ov, bg], output_dirs=["ob/i", "ob/l"],
        pairing_method="modulo", seed=6, save_log=True, fixed_input=True,
        options={"crop_margins": (0.05, 0.05, 0.05, 0.05)}, **kw))
    return pipe


ENGINES = {
    "jax_jit": (jpkg, jtransforms, {"native_compute": False}),
    "jax_native": (jpkg, jtransforms, {"native_compute": True}),
    "torch": (tpkg, ttransforms, None),
}


@pytest.fixture(scope="module")
def config4(tmp_path_factory):
    base = tmp_path_factory.mktemp("config4")
    ov, bg = write_overlay_inputs(base / "data")
    runs = {}
    for name, (pkg, transforms, options) in ENGINES.items():
        kw = {"device": "cpu"} if options is None else {}
        pipe = build_config4(pkg, transforms, base / name, ov, bg, **kw)
        if options is not None:
            for step in pipe.steps:
                step.options.update(options)
        runs[name] = (base / name, pipe.run(progress=False))
    return runs


def test_config4_statuses_and_reports(config4):
    counts = {name: c for name, (_, c) in config4.items()}
    assert counts["torch"] == counts["jax_jit"] == counts["jax_native"] \
        == [Counter(Success=6)] * 3
    assert reports(config4["torch"][0]) == reports(config4["jax_jit"][0])


@pytest.mark.parametrize("directory", ["c4/i", "c4/l", "c4crop", "ob/i",
                                       "ob/l"])
def test_config4_files(config4, directory):
    """Names and label lines equal; decoded JPEG pixels equal the native
    twin's run; the jit run's composites are within ±2 (the device_fn
    test), which a JPEG encode spreads: decoded, within 6 grey levels and
    equal on at least 95 % of the values (10 levels and 90 % after the
    border crop's second JPEG generation)."""
    tdir = config4["torch"][0] / directory
    names = sorted(p.name for p in tdir.iterdir())
    assert len(names) == 6
    for other, exact in (("jax_native", True), ("jax_jit", False)):
        odir = config4[other][0] / directory
        assert sorted(p.name for p in odir.iterdir()) == names
        for name in names:
            if name.endswith(".txt"):
                assert (tdir / name).read_text() == (odir / name).read_text()
                assert not (tdir / name).read_text().endswith("\n")
                continue
            got = np.asarray(Image.open(tdir / name)).astype(int)
            want = np.asarray(Image.open(odir / name)).astype(int)
            assert got.shape == want.shape, name
            if exact:
                np.testing.assert_array_equal(got, want, err_msg=name)
            else:
                # c4crop is a second JPEG generation of the composite
                levels, share = (10, 0.9) if directory == "c4crop" \
                    else (6, 0.95)
                assert np.abs(got - want).max() <= levels, name
                assert (got == want).mean() >= share, name


def test_fused_border_crop_is_the_composite_cropped(config4):
    """OverlaysBorderCrop's image is the composite cut by the margins (not
    a second JPEG generation): same size as the unfused crop, and the
    label is the paste step's."""
    root = config4["torch"][0]
    for p in sorted((root / "ob/i").iterdir()):
        fused = Image.open(p)
        unfused = Image.open(root / "c4crop" / p.name)
        assert fused.size == unfused.size
        assert (root / "ob/l" / f"{p.stem}.txt").read_text() \
            == (root / "c4/l" / f"{p.stem}.txt").read_text()


def _single_step(pkg, transforms, root, ov, bg, transform_name, options, kw):
    step = pkg.ProcessingStep(
        "paste", getattr(transforms, transform_name)(),
        input_dirs=[ov, bg], output_dirs=[root / "i", root / "l"],
        pairing_method="modulo", seed=2, options=options, **kw)
    return step.run(progress=False), step


@pytest.mark.parametrize("name", ["PasteOverlayOntoBackground",
                                  "OverlaysBorderCrop"])
def test_degenerate_overlays_and_failed_saves(tmp_path, name):
    """A 1-pixel-high overlay draws no size (no_output); an item whose
    label cannot be written rolls its image back (paste) or keeps the
    label-first order (border crop); a background that is not a JPEG
    fails the fused crop's gate.  Both engines log the same."""
    rng = np.random.default_rng(9)
    ov, bg = tmp_path / "ov", tmp_path / "bg"
    ov.mkdir()
    bg.mkdir()
    Image.fromarray(rng.integers(0, 256, (1, 60, 4), np.uint8)).save(
        ov / "a_thin.png")
    Image.fromarray(make_image(rng, 20, 24, 4)).save(ov / "b_ok.png")
    Image.fromarray(make_image(rng, 22, 18, 4)).save(ov / "c_blocked.png")
    Image.fromarray(make_image(rng, 60, 80)).save(bg / "bg.jpg")
    out = {}
    for engine, (pkg, transforms, options) in ENGINES.items():
        if engine == "jax_native":
            continue
        root = tmp_path / engine
        (root / "l" / "c_blocked.txt").mkdir(parents=True)
        kw = {"device": "cpu"} if options is None else {}
        counts, step = _single_step(pkg, transforms, root, ov, bg, name,
                                    dict(options or {}), kw)
        logs = sorted(step.process_logs, key=lambda e: e["inputs"])
        out[engine] = (counts, [(e["status"], bool(e["error_message"]))
                                for e in logs],
                       sorted(p.name for p in (root / "i").iterdir()))
    assert out["torch"] == out["jax_jit"]
    counts, statuses, files = out["torch"]
    assert statuses[0] == ("no_output", False)
    assert statuses[1] == ("Success", False)
    assert files == ["b_ok.jpg"]


# -- the deprecated pair, the toy crop, valid_boxes ---------------------------------

def test_process_overlay_pair_equals_jax_with_the_same_python_seed(tmp_path):
    rng = np.random.default_rng(5)
    ov_p, bg_p = tmp_path / "ov.png", tmp_path / "bg.jpg"
    ov = make_image(rng, 20, 30, 4)
    ov[..., 3] = np.where(ov[..., 3] > 0, 255, 90)
    Image.fromarray(ov).save(ov_p)
    Image.fromarray(make_image(rng, 80, 120)).save(bg_p)
    outs = {}
    for name, fn in (("jax", jtransforms.process_overlay_pair),
                     ("torch", ttransforms.process_overlay_pair)):
        dirs = [tmp_path / name / "i", tmp_path / name / "l"]
        for d in dirs:
            d.mkdir(parents=True)
        random.seed(1234)
        with pytest.deprecated_call():
            outs[name] = fn(ov_p, bg_p, dirs, yolo_class_id=2)
        with pytest.deprecated_call():
            assert fn(ov_p, bg_p, dirs[:1]) is None
    assert [p.name for p in outs["torch"]] == ["ov.jpg", "ov.txt"]
    assert [p.name for p in outs["jax"]] == ["ov.jpg", "ov.txt"]
    assert outs["torch"][1].read_text() == outs["jax"][1].read_text()
    np.testing.assert_array_equal(np.asarray(Image.open(outs["torch"][0])),
                                  np.asarray(Image.open(outs["jax"][0])))


def test_crop_image_equals_jax(tmp_path):
    rng = np.random.default_rng(6)
    p = tmp_path / "big.png"
    Image.fromarray(rng.integers(0, 256, (420, 410, 3), np.uint8)).save(p)
    got, want = tcrop_image(p), jcrop_image(p)
    assert got.shape == (300, 300, 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_size", [1.0, 2.5])
def test_valid_boxes_equals_jax(min_size):
    rng = np.random.default_rng(int(min_size * 10))
    boxes = rng.uniform(0, 10, (5, 7, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.choice(
        [0.0, 0.5, 1.0, 2.5, 3.0], (5, 7, 2)).astype(np.float32)
    got = tbbox.valid_boxes(torch.as_tensor(boxes), min_size).numpy()
    want = np.asarray(jbbox.valid_boxes(jnp.asarray(boxes), min_size))
    np.testing.assert_array_equal(got, want)
    assert got.any() and not got.all()


def main(n=400_000):
    """The draw measurement: the port's paste geometry against the jitted
    JAX ``_draw_geometry`` over ``n`` (seed, overlay size, background
    size) triples for each scale range; prints the items that differ in
    any field.  Run from the repository root:
    ``JAX_PLATFORMS=cpu PYTHONPATH=.:tests python
    tests/test_torch_overlays.py [n]``."""
    for i, scale in enumerate(SCALES):
        got, want = draws_against_jax(n, 1000 + i, scale)
        bad = np.zeros(n, bool)
        for g, w in zip(got, want):
            bad |= (g != w).reshape(n, -1).any(1)
        print(f"scale {scale}: {int(bad.sum())} of {n} triples differ; "
              f"{int(got[4].sum())} paste (ok)")


if __name__ == "__main__":
    import sys

    jax.config.update("jax_platforms", "cpu")
    main(*(int(a) for a in sys.argv[1:2]))
