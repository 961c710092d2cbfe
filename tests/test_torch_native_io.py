"""The port's native IO engine (image_processor_pipeline_tpu_torch/native/
ipp_io.cpp through io/native.py) against the JAX package's, both built
here: the same JPEG and PNG-parity bytes (and cv2's and Pillow's where the
JAX package's tests pin those), the same decoded pixels, and the three
faults of the JAX host codec (F4) not copied; and the port's coefficient
coder (native/ipp_jcoef.cpp through io/jcoef.py, no codec library)
against the JAX library's libjpeg coefficient functions: the same
coefficient arrays and coefficient-written files."""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from image_processor_pipeline_tpu.io import native as jnative
from image_processor_pipeline_tpu_torch.io import jcoef, native
from torch_port_data import make_image


@pytest.fixture(scope="module", autouse=True)
def built():
    assert native.available(), native.build_error()
    assert jnative.available()
    assert native.build_error() is None
    assert jcoef.available(), jcoef.build_error()


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """JPEGs the readers tell apart: 4:2:0, 4:4:4, 4:2:2, grayscale,
    progressive, a dense (noise) one, an odd size, and a PNG."""
    d = tmp_path_factory.mktemp("jpegs")
    rng = np.random.default_rng(0)
    img = make_image(rng, 61, 83)
    Image.fromarray(img).save(d / "a420.jpg", quality=90)
    Image.fromarray(img).save(d / "b444.jpg", quality=90, subsampling=0)
    Image.fromarray(img).save(d / "c422.jpg", quality=90, subsampling=1)
    Image.fromarray(img[..., 0]).save(d / "d_grey.jpg", quality=90)
    Image.fromarray(img).save(d / "e_prog.jpg", quality=90, progressive=True)
    Image.fromarray(rng.integers(0, 256, (64, 64, 3), np.uint8)).save(
        d / "f_noise.jpg", quality=95)
    Image.fromarray(make_image(rng, 17, 9)).save(d / "g_odd.jpg", quality=75)
    Image.fromarray(img).save(d / "h.png")
    return sorted(d.iterdir())


@pytest.mark.parametrize("quality", [75, 95])
def test_jpeg_bytes_equal_the_jax_library_cv2_and_pillow(tmp_path, quality):
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(quality)
    for h, w in [(120, 160), (121, 161), (33, 47)]:
        rgb = rng.integers(0, 256, (h, w, 3), np.uint8)
        ours, theirs = tmp_path / "o.jpg", tmp_path / "t.jpg"
        assert native.encode_jpeg(ours, rgb, quality)
        assert jnative.encode_jpeg(theirs, rgb, quality)
        assert ours.read_bytes() == theirs.read_bytes(), (h, w)
        cv = tmp_path / "cv.jpg"
        cv2.imwrite(str(cv), rgb[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY,
                                              quality])
        assert ours.read_bytes() == cv.read_bytes(), (h, w)
        if quality == 75:
            pil = tmp_path / "pil.jpg"
            Image.fromarray(rgb).save(pil)
            assert ours.read_bytes() == pil.read_bytes(), (h, w)
        # a flipped view encodes like its copy
        assert native.encode_jpeg(ours, rgb[::-1, ::-1], quality)
        assert jnative.encode_jpeg(theirs, np.ascontiguousarray(
            rgb[::-1, ::-1]), quality)
        assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("c", [1, 3, 4])
def test_png_parity_bytes_fast_and_tiled_pixels(tmp_path, c, monkeypatch):
    rng = np.random.default_rng(c)
    img = rng.integers(0, 256, (61, 81, c), np.uint8)
    ours, theirs = tmp_path / "o.png", tmp_path / "t.png"
    assert native.encode_png(ours, img, mode="parity")
    assert jnative.encode_png(theirs, img, mode="parity")
    assert ours.read_bytes() == theirs.read_bytes()
    monkeypatch.setattr(native, "PNG_THREADS", "4")
    for view in (img, img[::-1], img[:, ::-1]):
        for mode in ("fast", "parity"):
            assert native.encode_png(ours, view, mode=mode)
            got = np.asarray(Image.open(ours))
            np.testing.assert_array_equal(got.reshape(view.shape), view)
    monkeypatch.setattr(native, "PNG_THREADS", "1")
    assert native.encode_png(ours, img, mode="fast")
    assert jnative.encode_png(theirs, img, mode="fast")
    assert ours.read_bytes() == theirs.read_bytes()


def test_decode_batch_probes_and_decode_to_canvas(jpegs):
    paths = jpegs + [jpegs[0].parent / "missing.jpg"]
    for channels in (3, 4):
        ours = native.decode_batch(paths, (128, 128), channels, 3, n_rows=10)
        theirs = jnative.decode_batch(paths, (128, 128), channels, 3,
                                      n_rows=10)
        np.testing.assert_array_equal(ours[0], theirs[0])
        np.testing.assert_array_equal(ours[1], theirs[1])
        assert ours[1][-1, 0] < 0 and not ours[0][-1].any()
        out = np.zeros((len(paths), 128, 128, channels), np.uint8)
        assert native.decode_batch(paths, (128, 128), channels, 2,
                                   out=out)[0] is out
        np.testing.assert_array_equal(out, ours[0][:len(paths)])
    for p in paths:
        assert native.probe(p) == jnative.probe(p)
        assert native.probe_bands(p) == jnative.probe_bands(p)
        for ch in (3, 4):
            a = native.decode_to_canvas(p, (64, 96), ch)
            b = jnative.decode_to_canvas(p, (64, 96), ch)
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a[0], b[0])
                assert a[1:] == b[1:]


def test_coefficient_readers_equal(jpegs):
    """Dense and sparse, single and batch, with the 4:2:0 default chroma
    caps (the -3 rejections of 4:4:4/4:2:2) and full ones, and a sparse
    cap small enough that the noise file overflows (-6)."""
    cap = (9, 11)
    for cap_c in (None, cap):
        a = jcoef.read_jpeg_coefs_batch(jpegs, cap, cap_c, 3)
        b = jnative.read_jpeg_coefs_batch(jpegs, cap, cap_c, 3)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        for cap_nnz in (None, 900):
            a = jcoef.read_jpeg_coefs_sparse_batch(jpegs, cap, cap_c,
                                                   cap_nnz, 2)
            b = jnative.read_jpeg_coefs_sparse_batch(jpegs, cap, cap_c,
                                                     cap_nnz, 2)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
        codes = {min(int(v), 0) for v in a[4][:, 0]}
        assert codes >= {0, -6} | ({-3} if cap_c is None else set())
        for p in jpegs:
            x = jcoef.read_jpeg_coefs(p, cap, cap_c)
            y = jnative.read_jpeg_coefs(p, cap, cap_c)
            assert (x is None) == (y is None)
            for u, v in zip(x or (), y or ()):
                np.testing.assert_array_equal(u, v)


def test_write_jpeg_coefs_files_equal(tmp_path, jpegs):
    """Files written from coefficients (dense, sparse, sparse batch) equal
    the JAX library's byte for byte, and the pixel encoder's: the
    coefficients of a q75 file re-read and written back at q75."""
    src = tmp_path / "src.jpg"
    rgb = make_image(np.random.default_rng(7), 45, 70)
    assert native.encode_jpeg(src, rgb, 75)
    cap, cap_c = (6, 9), (3, 5)
    cy, cc, _, info = jcoef.read_jpeg_coefs(src, cap, cap_c)
    h, w = int(info[0]), int(info[1])
    for lib, name in ((jcoef, "o"), (jnative, "t")):
        assert lib.write_jpeg_coefs(tmp_path / f"{name}_d.jpg", cy, cc, h, w,
                                    75)
    flat = np.concatenate([cy.ravel(), cc.ravel()])
    nz = np.nonzero(flat)[0].astype(np.int32)
    idx = np.zeros((2, 4096), np.int32)
    val = np.zeros((2, 4096), np.int16)
    idx[:, :len(nz)], val[:, :len(nz)] = nz, flat[nz]
    nnz = np.array([len(nz), 5000], np.int32)          # item 1 overflows
    for lib, name in ((jcoef, "o"), (jnative, "t")):
        assert lib.write_jpeg_coefs_sparse(
            tmp_path / f"{name}_s.jpg", idx[0], val[0], len(nz), cap, cap_c,
            h, w, 75) == 0
        rcs = lib.write_jpeg_coefs_sparse_batch(
            [tmp_path / f"{name}_b0.jpg", tmp_path / f"{name}_b1.jpg"], idx,
            val, nnz, cap, cap_c, np.array([h, h]), np.array([w, w]), 75)
        assert list(rcs) == [0, -6]
    want = src.read_bytes()
    for f in ("d", "s", "b0"):
        assert (tmp_path / f"o_{f}.jpg").read_bytes() == want
        assert (tmp_path / f"t_{f}.jpg").read_bytes() == want


def test_parse_yolo(tmp_path):
    p = tmp_path / "l.txt"
    p.write_text("0 0.5 0.5 0.25 0.125\n3 0.1 0.2 0.3 0.4\n\n7 1 1 1 1\n")
    for a, b in zip(native.parse_yolo(p), jnative.parse_yolo(p)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert native.parse_yolo(tmp_path / "none.txt") is None
    assert jnative.parse_yolo(tmp_path / "none.txt") is None


# -- F4: the JAX host codec's faults are not copied ------------------------

def test_encoder_concurrency_is_restored_after_a_step(tmp_path):
    """A step sets the saver width for the auto-tiled PNG encoder and
    puts the caller's value back afterwards (the JAX engine resets it to
    1)."""
    from image_processor_pipeline_tpu_torch.pipeline import ProcessingStep

    (tmp_path / "in").mkdir()
    (tmp_path / "in" / "a.txt").write_text("x")
    seen = []

    def host(path, output_dirs=None, **kw):
        seen.append(native.encoder_concurrency())
        return None

    prev = native.set_encoder_concurrency(3)
    try:
        ProcessingStep("s", host, input_dirs=[tmp_path / "in"],
                       output_dirs=[tmp_path / "out"], workers=2,
                       device="cpu").run(progress=False)
        assert seen == [2] and native.encoder_concurrency() == 3
    finally:
        native.set_encoder_concurrency(prev)


def test_forced_png_threads_are_clamped(monkeypatch, tmp_path):
    for forced, want in (("100000", native.PNG_THREADS_MAX), ("0", 1),
                         ("-7", 1), ("3", 3), ("many", 1)):
        monkeypatch.setattr(native, "PNG_THREADS", forced)
        assert native._png_threads(1 << 20) == want, forced
    monkeypatch.setattr(native, "PNG_THREADS", "100000")
    img = np.random.default_rng(0).integers(0, 256, (70, 9, 3), np.uint8)
    assert native.encode_png(tmp_path / "a.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  img)


def test_tiled_band_guard_splits_long_bands(tmp_path, monkeypatch):
    """zlib counts a call's bytes in 32 bits: a band of 4 GiB or more is
    fed in pieces (the length check), never cast whole.  Lowering the
    piece limit drives the same piecewise path on a small image."""
    assert native.zlib_piece(5 << 30) == 1 << 30
    assert native.zlib_piece((1 << 32) + 7) == 1 << 30
    assert native.zlib_piece(1000) == 1000
    monkeypatch.setattr(native, "PNG_THREADS", "3")
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (90, 70, 4), np.uint8)
    img[:40] = 7                                  # a band that compresses
    try:
        for piece in (1, 97, 4096):
            native.set_zlib_piece(piece)
            assert native.zlib_piece(5 << 30) == max(piece, 64)
            p = tmp_path / f"t{piece}.png"
            assert native.encode_png(p, img, mode="fast")
            np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    finally:
        native.set_zlib_piece(0)
    assert native.zlib_piece(5 << 30) == 1 << 30


def test_build_error_names_the_compiler_message(tmp_path, monkeypatch):
    """A library that cannot be built leaves the module unavailable, with
    the compiler's own words in build_error()."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(native, "_SO", tmp_path / "libipp_io.so")
    monkeypatch.setattr(native, "BUILD", tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    assert not native.available()
    assert "no_such_header_here.h" in native.build_error()
    assert native.encode_jpeg(tmp_path / "x.jpg",
                              np.zeros((8, 8, 3), np.uint8)) is False
    assert native.decode_batch([Path("x.jpg")], (8, 8)) is None
