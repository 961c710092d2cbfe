"""The port's host IO (io/images.py, io/batching.py, io/labels.py,
utils/utils.py) against the JAX package's on the same files: decode, pad,
probe, batch decode and the encode round trip.  PNG is lossless, so decoded
pixels are compared exactly, never file bytes; JPEG files are only read
back for shape (the JAX package's native JPEG encoder is not ported)."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from image_processor_pipeline_tpu.io import batching as jbatching
from image_processor_pipeline_tpu.io import images as jimages
from image_processor_pipeline_tpu.io import labels as jlabels
from image_processor_pipeline_tpu.io import native as jnative
from image_processor_pipeline_tpu.utils import utils as jutils
from image_processor_pipeline_tpu_torch.io import batching, images, labels
from image_processor_pipeline_tpu_torch.utils import utils
from torch_port_data import make_image


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One file of each kind the probes tell apart."""
    d = tmp_path_factory.mktemp("io")
    rng = np.random.default_rng(0)
    rgb = make_image(rng, 37, 53)
    rgba = make_image(rng, 41, 29, 4)
    Image.fromarray(rgb).save(d / "rgb.png")
    Image.fromarray(rgba).save(d / "rgba.png")
    Image.fromarray(rgb[..., 0]).save(d / "grey.png")
    Image.fromarray(rgb).convert("P").save(d / "palette.png")
    Image.fromarray(rgb).save(d / "trns.png", transparency=(1, 2, 3))
    Image.fromarray((rgb[..., 0].astype(np.uint16) * 257)).save(
        d / "deep.png")
    Image.fromarray(rgb).save(d / "rgb.jpg", quality=90)
    Image.fromarray(rgb[..., 0]).save(d / "grey.jpg")
    Image.fromarray(rgb).save(d / "rgb.bmp")
    (d / "broken.png").write_bytes(b"\x89PNG\r\n\x1a\nnope")
    return d


NAMES = ["rgb.png", "rgba.png", "grey.png", "palette.png", "trns.png",
         "deep.png", "rgb.jpg", "grey.jpg", "rgb.bmp"]


@pytest.mark.parametrize("mode", [None, "RGB", "RGBA"])
@pytest.mark.parametrize("name", [n for n in NAMES if n != "deep.png"])
def test_decode_image_matches_the_jax_package(files, name, mode):
    want = jimages.decode_image(files / name, mode)
    got = images.decode_image(files / name, mode)
    assert got.dtype == np.uint8 and got.shape == want.shape
    if name.endswith(".jpg") and mode is not None:
        # the JAX package decodes these with its own libjpeg build: held to
        # 2 grey levels (IDCT and upsampling differ by rounding)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 2
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("name,mode", [
    ("rgb.png", "RGB"), ("rgb.png", "RGBA"), ("rgba.png", "RGBA"),
    ("rgba.png", "RGB"), ("grey.png", "RGB"), ("palette.png", "RGBA"),
    ("rgb.bmp", "RGB"), ("rgba.png", None)])
def test_decode_padded_matches_the_jax_package(files, name, mode, diag):
    want = jimages.decode_padded(files / name, mode, diag)
    got = images.decode_padded(files / name, mode, diag)
    assert got[1:] == want[1:]  # h, w, canvas
    np.testing.assert_array_equal(got[0], want[0])
    h, w = got[1:3]
    assert not got[0][h:].any() and not got[0][:, w:].any()


@pytest.mark.parametrize("name", NAMES + ["broken.png", "missing.png"])
def test_probes_match_the_native_header_probes(files, name):
    """(h, w, channels) and the band rule (3, 4 or 0) of io/native.py."""
    assert jnative.available()
    assert images.probe(files / name) == jnative.probe(files / name)
    assert images.probe_bands(files / name) == \
        jnative.probe_bands(files / name)
    for mode in ("RGB", "RGBA", "L"):
        for diag in (False, True):
            assert images.probe_padded(files / name, mode, diag) == \
                jimages.probe_padded(files / name, mode, diag)


def test_probe_reads_no_pixels(files, monkeypatch):
    from PIL import ImageFile

    def no_load(self):
        raise AssertionError("pixels were loaded")

    monkeypatch.setattr(ImageFile.ImageFile, "load", no_load)
    assert images.probe(files / "rgb.png") == (37, 53, 3)
    assert images.probe_bands(files / "rgba.png") == (41, 29, 4)


def _probed(files, names, mode, diag=False):
    items = []
    for name in names:
        h, w, canvas = images.probe_padded(files / name, mode, diag)
        items.append({"canvas": canvas, "size": np.asarray([h, w], np.int32),
                      "_decode": (str(files / name), mode, diag)})
    return items


@pytest.mark.parametrize("n_threads", [1, 3])
def test_fill_pending_images_prestacks_a_padded_chunk(files, n_threads):
    items = _probed(files, ["rgb.png", "rgba.png", "grey.png"], "RGBA")
    chunk = items + [items[-1]]  # ladder padding repeats the last dict
    made = []

    def alloc(shape):
        made.append(shape)
        return np.zeros(shape, np.uint8)

    images.fill_pending_images(chunk, n_threads, alloc)
    pre = chunk[0]["_prestacked_image"]
    assert made == [(4, 128, 128, 4)] and pre.shape == made[0]
    assert not pre[3].any()  # the pad row stays zero
    for i, it in enumerate(items):
        want = jimages.decode_padded(Path(it["_decode"][0]), "RGBA")[0]
        np.testing.assert_array_equal(it["image"], want)
        assert np.shares_memory(it["image"], pre[i])


def test_fill_pending_images_mixed_groups_and_faults(files, tmp_path):
    """Two canvases in one chunk decode group by group (no prestack); a
    file that shrank after its probe and one that went away get
    ``_load_error`` and a zero canvas."""
    small = _probed(files, ["rgb.png", "rgb.jpg"], "RGB")
    big = _probed(files, ["rgb.png"], "RGB", diag=True)
    big[0]["canvas"] = (256, 256)
    big[0]["_decode"] = (str(files / "rgba.png"), "RGB", False)  # dims moved
    gone = _probed(files, ["rgb.png"], "RGB")
    gone[0]["_decode"] = (str(tmp_path / "gone.png"), "RGB", False)
    done = {"canvas": (128, 128), "image": np.ones((128, 128, 3), np.uint8),
            "size": np.asarray([5, 5], np.int32)}
    chunk = small + big + gone + [done]
    images.fill_pending_images(chunk, 2)
    assert "_prestacked_image" not in chunk[0]
    assert [("_load_error" in it) for it in chunk] == [False, False, True,
                                                       True, False]
    assert "decode dims changed" in big[0]["_load_error"]
    assert "FileNotFoundError" in gone[0]["_load_error"]
    assert big[0]["image"].shape == (256, 256, 3) and not big[0]["image"].any()
    np.testing.assert_array_equal(
        small[0]["image"], jimages.decode_padded(files / "rgb.png", "RGB")[0])
    assert done["image"].all()


def test_fill_pending_multi_decodes_each_field(files):
    item = {"canvas": (128, 128), "_pending": {
        "overlay": (str(files / "rgba.png"), "RGBA", False, (128, 128), 41,
                    29),
        "background": (str(files / "rgb.png"), "RGB", True, (128, 128), 37,
                       53)}}
    images.fill_pending_images([item, item], 2)
    np.testing.assert_array_equal(
        item["overlay"], jimages.decode_padded(files / "rgba.png", "RGBA")[0])
    np.testing.assert_array_equal(
        item["background"],
        jimages.decode_padded(files / "rgb.png", "RGB", True)[0])
    assert "_load_error" not in item


@pytest.mark.parametrize("channels", [1, 3, 4])
@pytest.mark.parametrize("encode", ["encode_image", "encode_image_pil"])
def test_png_round_trip_and_cross_decode(tmp_path, channels, encode):
    """What the port writes, both packages read back exactly, and the
    other way round."""
    rng = np.random.default_rng(channels)
    arr = rng.integers(0, 256, (33, 47, channels), np.uint8)
    ours = getattr(images, encode)(arr, tmp_path / "sub" / "ours.png")
    theirs = getattr(jimages, encode)(arr, tmp_path / "theirs.png")
    for path in (ours, theirs):
        np.testing.assert_array_equal(images.decode_image(path), arr)
        np.testing.assert_array_equal(jimages.decode_image(path), arr)
    # a flipped view encodes like its copy
    view = arr[::-1, ::-1]
    images.encode_image(view, tmp_path / "view.png")
    np.testing.assert_array_equal(images.decode_image(tmp_path / "view.png"),
                                  np.ascontiguousarray(view))


def test_jpeg_defaults_follow_the_two_reference_encoders(tmp_path):
    """encode_image saves JPEG at quality 95 (cv2's default), the _pil form
    at 75 (Pillow's), and RGBA loses its alpha."""
    arr = make_image(np.random.default_rng(2), 64, 64, 4)
    hi = images.encode_image(arr, tmp_path / "hi.jpg")
    lo = images.encode_image_pil(arr, tmp_path / "lo.jpeg")
    assert hi.stat().st_size > lo.stat().st_size
    assert images.decode_image(hi).shape == (64, 64, 3)
    same = tmp_path / "same.jpg"
    Image.fromarray(arr[..., :3]).save(same, quality=75)
    assert lo.read_bytes() == same.read_bytes()


def test_list_files_sorts_filters_and_raises(tmp_path):
    for name in ("b.png", "a.PNG", "c.txt"):
        (tmp_path / name).write_text("x")
    (tmp_path / "sub").mkdir()
    assert [p.name for p in images.list_files(tmp_path)] == \
        [p.name for p in jimages.list_files(tmp_path)] == \
        ["a.PNG", "b.png", "c.txt"]
    assert [p.name for p in images.list_files(tmp_path, [".png"])] == \
        ["a.PNG", "b.png"]
    with pytest.raises(FileNotFoundError):
        images.list_files(tmp_path / "none")


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1024, 1025, 4096, 5000])
def test_bucket_dim_and_canvas_match_the_jax_package(n):
    assert batching.bucket_dim(n) == jbatching.bucket_dim(n)
    assert batching.canvas_for(n, 2 * n, 1.5) == \
        jbatching.canvas_for(n, 2 * n, 1.5)


@pytest.mark.parametrize("c,channels", [(3, None), (3, 4), (1, 3), (4, 4)])
def test_pad_to_canvas_matches_the_jax_package(c, channels):
    arr = np.random.default_rng(c).integers(1, 256, (20, 30, c), np.uint8)
    np.testing.assert_array_equal(
        batching.pad_to_canvas(arr, (128, 128), channels),
        jbatching.pad_to_canvas(arr, (128, 128), channels))


def test_bucketizer_and_stack_field():
    b, jb = batching.Bucketizer(4), jbatching.Bucketizer(4)
    for i in range(11):
        for x in (b, jb):
            x.add((128, 128 * (1 + i % 2)), {"i": np.int32(i)})
    got = [(k, [it["i"] for it in items], n) for k, items, n in b.batches()]
    want = [(k, [it["i"] for it in items], n) for k, items, n in jb.batches()]
    assert got == want
    assert batching.stack_field([{"a": np.ones(2)}] * 3, "a").shape == (3, 2)


def test_labels_round_trip_and_format(tmp_path):
    rng = np.random.default_rng(4)
    classes = rng.integers(0, 80, 7)
    xywhn = rng.uniform(0, 1, (7, 4)).astype(np.float32)
    ours = labels.write_yolo_labels(tmp_path / "d" / "a.txt", classes, xywhn)
    theirs = jlabels.write_yolo_labels(tmp_path / "b.txt", classes, xywhn)
    assert ours.read_text() == theirs.read_text()
    for got, want in zip(labels.read_yolo_labels(ours),
                         jlabels.read_yolo_labels(theirs)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    with pytest.warns(UserWarning):
        cls, box = labels.read_yolo_labels(empty)
    assert cls.shape == (0,) and box.shape == (0, 4)
    bad = tmp_path / "bad.txt"
    bad.write_text("1 0.5 0.5\n")
    with pytest.raises(ValueError, match="columns"):
        labels.read_yolo_labels(bad)


def test_utils_match_the_jax_package(tmp_path):
    assert utils.IMG_FORMATS == jutils.IMG_FORMATS
    assert utils.VID_FORMATS == jutils.VID_FORMATS
    assert utils.check_path("a/b", tmp_path) == tmp_path / "a/b"
    assert utils.check_path(tmp_path, "/other") == tmp_path
    assert utils.validate_dirs(["x", "y", "z"], 2) == (Path("x"), Path("y"))
    assert utils.validate_dirs(["x"]) == Path("x")
    with pytest.raises(ValueError):
        utils.validate_dirs(["x"], 2)
    assert utils.is_image_file("a.JPG") and utils.is_video_file("a.mp4")
    assert not utils.is_image_file("a.txt")
    arr = make_image(np.random.default_rng(1), 16, 16)
    out = utils.save_yolo_pair(arr, [1], [[0.5, 0.5, 0.25, 0.25]],
                               tmp_path / "i" / "a.png",
                               tmp_path / "l" / "a.txt")
    assert out[1].read_text() == "1 0.500000 0.500000 0.250000 0.250000\n"
    np.testing.assert_array_equal(images.decode_image(out[0]), arr)
