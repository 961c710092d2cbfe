"""The port's JPEG coefficient coder (native/ipp_jcoef.cpp through
io/jcoef.py, C++ with no codec library) against the JAX package's
coefficient functions (image_processor_pipeline_tpu/native/ipp_io.cpp:
libjpeg's jpeg_read_coefficients and jpeg_write_coefficients), both built
here.

Reader: a corpus made from seeds (Pillow files at seven qualities, three
subsamplings, baseline, progressive and optimised tables, grayscale, four
odd sizes; cv2 files with restart intervals and 4:1:1 / 4:4:0 sampling;
variants of the headers; cuts inside the scans; damaged copies; a CMYK
file, garbage and a PNG) read dense and sparse, one by one and in batches,
with half and full chroma caps and with sparse caps that overflow: every
array, table, info row and return code equal.  The one exception is F18:
arithmetic, lossless, hierarchical and 12-bit streams give the coder's -7
where libjpeg gives 0 or -2.

Writer: coefficient grids from real files and random ones clipped to the
legal range, 1-200 px, q 1-100: the files equal libjpeg's byte for byte,
dense, sparse and batched, with the same return codes."""

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from image_processor_pipeline_tpu.io import native as jnative
from image_processor_pipeline_tpu_torch.io import jcoef
from image_processor_pipeline_tpu_torch.utils import native_build

cv2 = pytest.importorskip("cv2")

QUALITIES = (1, 25, 50, 75, 90, 95, 100)
#: (h, w) of the Pillow corpus
SIZES = ((1, 1), (7, 9), (17, 33), (8, 2048))
#: the F18 return code
UNSUPPORTED = -7


@pytest.fixture(scope="module", autouse=True)
def built():
    assert jcoef.available(), jcoef.build_error()
    assert jcoef.build_error() is None
    assert jnative.available()


def image(rng, h, w, c=3):
    """A gradient under noise: real-looking blocks at every quality."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 // max(w - 1, 1), yy * 255 // max(h - 1, 1),
                     (xx + yy) * 7 % 256, xx * 0 + 128], -1)[..., :c]
    noise = rng.integers(-20, 21, (h, w, c))
    return np.clip(base + noise, 0, 255).astype(np.uint8)


def caps_for(h, w):
    """Luma caps that fit any sampling of an h x w image."""
    return (-(-h // 8), -(-w // 8))


# -- the two libraries' readers, called alike -------------------------------

def _p(a, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _jax_lib():
    lib = jnative._load()
    fn = lib.ipp_read_jpeg_coefs_sparse
    fn.argtypes = jcoef._load().ipp_read_jpeg_coefs_sparse.argtypes
    fn.restype = ctypes.c_int
    return lib


def read_dense(lib, path, cap, cap_c):
    """(rc, flat coefficients, qtabs, info) as the call left them."""
    ny, nc = cap[0] * cap[1] * 64, cap_c[0] * cap_c[1] * 64
    flat = np.zeros(ny + 2 * nc, np.int16)
    q = np.zeros((3, 64), np.uint16)
    info = np.zeros(16, np.int32)
    rc = lib.ipp_read_jpeg_coefs(
        str(path).encode(), _p(flat, ctypes.c_int16), cap[0], cap[1],
        cap_c[0], cap_c[1], _p(q, ctypes.c_uint16), _p(info, ctypes.c_int))
    return rc, flat, q, info


def read_sparse(lib, path, cap, cap_c, cap_nnz):
    idx = np.zeros(cap_nnz, np.int32)
    val = np.zeros(cap_nnz, np.int16)
    nnz = ctypes.c_int(0)
    q = np.zeros((3, 64), np.uint16)
    info = np.zeros(16, np.int32)
    rc = lib.ipp_read_jpeg_coefs_sparse(
        str(path).encode(), _p(idx, ctypes.c_int32), _p(val, ctypes.c_int16),
        cap_nnz, ctypes.byref(nnz), cap[0], cap[1], cap_c[0], cap_c[1],
        _p(q, ctypes.c_uint16), _p(info, ctypes.c_int))
    return rc, idx, val, nnz.value, q, info


def assert_same(a, b, what):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=str(what))
        else:
            assert x == y, what


def assert_single_reads_equal(path, cap, cap_c, cap_nnz, allow_f18=False):
    """Dense and sparse single reads of both libraries: everything equal.
    Returns the rc."""
    jlib, tlib = _jax_lib(), jcoef._load()
    want = read_dense(jlib, path, cap, cap_c)
    got = read_dense(tlib, path, cap, cap_c)
    want_s = read_sparse(jlib, path, cap, cap_c, cap_nnz)
    got_s = read_sparse(tlib, path, cap, cap_c, cap_nnz)
    if allow_f18 and got[0] == UNSUPPORTED:
        assert want[0] in (0, -2) and got_s[0] == UNSUPPORTED, path
        return UNSUPPORTED
    assert_same(got, want, (path.name, "dense", cap, cap_c))
    assert_same(got_s, want_s, (path.name, "sparse", cap, cap_c, cap_nnz))
    return got[0]


def assert_batches_equal(paths, cap, cap_c, cap_nnz):
    """The four batch readers of both libraries (two threads): equal."""
    a = jcoef.read_jpeg_coefs_batch(paths, cap, cap_c, 2)
    b = jnative.read_jpeg_coefs_batch(paths, cap, cap_c, 2)
    assert_same(a, b, ("batch", cap, cap_c))
    a = jcoef.read_jpeg_coefs_sparse_batch(paths, cap, cap_c, cap_nnz, 2)
    b = jnative.read_jpeg_coefs_sparse_batch(paths, cap, cap_c, cap_nnz, 2)
    assert_same(a, b, ("sparse batch", cap, cap_c, cap_nnz))
    return {min(int(v), 0) for v in a[4][:, 0]}


# -- the corpus ---------------------------------------------------------------

@pytest.fixture(scope="module")
def pillow_corpus(tmp_path_factory):
    """{(h, w): [paths]}: Pillow files at every quality, subsampling 0, 1
    and 2, baseline, progressive and optimised, and grayscale ones."""
    d = tmp_path_factory.mktemp("pillow")
    rng = np.random.default_rng(2024)
    out = {}
    for h, w in SIZES:
        files = out.setdefault((h, w), [])
        for q in QUALITIES:
            img = image(rng, h, w)
            for ss in (0, 1, 2):
                for kind, kw in (("base", {}), ("prog", {"progressive": True}),
                                 ("opt", {"optimize": True})):
                    p = d / f"{h}x{w}_q{q}_s{ss}_{kind}.jpg"
                    Image.fromarray(img).save(p, quality=q, subsampling=ss,
                                              **kw)
                    files.append(p)
            for kind, kw in (("grey", {}),
                             ("greyprog", {"progressive": True})):
                p = d / f"{h}x{w}_q{q}_{kind}.jpg"
                Image.fromarray(img[..., 1]).save(p, quality=q, **kw)
                files.append(p)
    return out


@pytest.fixture(scope="module")
def odd_corpus(tmp_path_factory):
    """cv2 files with restart intervals and 4:1:1, 4:4:0 and 4:2:2
    sampling (baseline and progressive), a CMYK file (-5), garbage after
    an SOI, a PNG and a missing path."""
    d = tmp_path_factory.mktemp("odd")
    rng = np.random.default_rng(7)
    files = []
    for samp in ("411", "440", "422"):
        flag = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{samp}")
        for rst in (0, 1, 3):
            for prog in (0, 1):
                img = image(rng, 53, 71)
                p = d / f"cv_{samp}_rst{rst}_p{prog}.jpg"
                assert cv2.imwrite(str(p), img[..., ::-1], [
                    cv2.IMWRITE_JPEG_SAMPLING_FACTOR, flag,
                    cv2.IMWRITE_JPEG_RST_INTERVAL, rst,
                    cv2.IMWRITE_JPEG_PROGRESSIVE, prog,
                    cv2.IMWRITE_JPEG_QUALITY, 85])
                files.append(p)
    p = d / "cmyk.jpg"
    Image.fromarray(image(rng, 20, 24, 4), "CMYK").save(p)
    files.append(p)
    (d / "garbage.jpg").write_bytes(b"\xff\xd8 garbage")
    Image.fromarray(image(rng, 20, 24)).save(d / "png.jpg", format="PNG")
    (d / "empty.jpg").write_bytes(b"")
    return files + [d / "garbage.jpg", d / "png.jpg", d / "empty.jpg",
                    d / "missing.jpg"]


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_pillow_corpus_reads_equal_libjpeg(pillow_corpus, size):
    """Every file of one size, single and batched, dense and sparse, with
    the full chroma caps and the 4:2:0 ones (the -3 of 4:4:4 and 4:2:2
    where the halved grid is smaller), and a sparse cap of 8 (-6)."""
    files = pillow_corpus[size]
    cap = caps_for(*size)
    half = ((cap[0] + 1) // 2, (cap[1] + 1) // 2)
    codes = set()
    for cap_c in (cap, half):
        for cap_nnz in (1 << 16, 8):
            codes |= assert_batches_equal(files, cap, cap_c, cap_nnz)
            for p in files:
                codes.add(assert_single_reads_equal(p, cap, cap_c, cap_nnz))
    assert 0 in codes and (-6 in codes or size == (1, 1))
    if half != cap:
        assert -3 in codes


def test_odd_files_read_equal_libjpeg(odd_corpus):
    """Restart intervals, 4:1:1 (luma 4 x 1) and 4:4:0, CMYK (-5), garbage
    and a PNG (-2), a missing file (-1); a cap one block short (-3)."""
    codes = set()
    for cap in ((7, 9), (7, 8)):
        for cap_c in (cap, (4, 5)):
            codes |= assert_batches_equal(odd_corpus, cap, cap_c, 4096)
            for p in odd_corpus:
                codes.add(assert_single_reads_equal(p, cap, cap_c, 4096))
    assert codes == {0, -1, -2, -3, -5}


# -- headers: segment by segment ---------------------------------------------

def segments(data):
    """[(marker, bytes)] of a JPEG; an SOS segment carries its entropy
    data (restart markers included)."""
    segs, i = [(0xd8, data[:2])], 2
    while i < len(data):
        m = data[i + 1]
        if m == 0xd9:
            segs.append((m, data[i:i + 2]))
            i += 2
            continue
        j = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if m == 0xda:
            while not (data[j] == 0xff and data[j + 1] != 0
                       and not 0xd0 <= data[j + 1] <= 0xd7):
                j += 1
        segs.append((m, data[i:j]))
        i = j
    return segs


def join(segs):
    return b"".join(s for _, s in segs)


def dqt16(seg, scale=1):
    """A DQT segment with its tables rewritten to 16-bit entries."""
    body, out, k = seg[4:], bytearray(), 0
    while k < len(body):
        out.append(0x10 | body[k] & 15)
        for v in body[k + 1:k + 65]:
            out += (v * scale).to_bytes(2, "big")
        k += 65
    return b"\xff\xdb" + (len(out) + 2).to_bytes(2, "big") + bytes(out)


def header_variants(base, prog):
    """name -> bytes: the header shapes of users' files, and broken ones
    libjpeg refuses."""
    s, sp = segments(base), segments(prog)
    mk = [m for m, _ in s]
    sof, sos = mk.index(0xc0), mk.index(0xda)
    no_jfif = [x for x in s if x[0] != 0xe0]
    adobe = [(0xee, b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00" +
              bytes([t])) for t in (0, 1, 2)]
    com = (0xfe, b"\xff\xfe\x00\x07hello")
    app1 = (0xe1, b"\xff\xe1\x00\x0aExif\x00\x00ab")
    dri = (0xdd, b"\xff\xdd\x00\x04\x00\x02")

    def with_ids(ids):
        out = []
        for m, seg in no_jfif:
            seg = bytearray(seg)
            for k in range(3):
                if m == 0xc0:
                    seg[10 + 3 * k] = ids[k]
                elif m == 0xda:
                    seg[5 + 2 * k] = ids[k]
            out.append((m, bytes(seg)))
        return join(out)

    def sos_order(order):
        seg = bytearray(s[sos][1])
        comps = [bytes(seg[5 + 2 * k:7 + 2 * k]) for k in range(3)]
        seg[5:11] = b"".join(comps[k] for k in order)
        return join(s[:sos] + [(0xda, bytes(seg))] + s[sos + 1:])

    def sof_bytes(changes):
        seg = bytearray(s[sof][1])
        for offset, value in changes.items():
            seg[offset] = value
        return join(s[:sof] + [(0xc0, bytes(seg))] + s[sof + 1:])

    first_dht = [m for m, _ in sp].index(0xc4)
    return {
        "no_dht_std_tables": join([x for x in s if x[0] != 0xc4]),
        "dqt16": join([(m, dqt16(g) if m == 0xdb else g) for m, g in s]),
        "dqt16_wide": join([(m, dqt16(g, 300) if m == 0xdb else g)
                            for m, g in s]),
        "dqt_after_sof": join([x for x in s if x[0] != 0xdb][:3]
                              + [x for x in s if x[0] == 0xdb]
                              + [x for x in s if x[0] != 0xdb][3:]),
        "com_app1_fill": join(s[:2] + [com, app1]) + b"\xff\xff" + join(s[2:]),
        "bytes_before_marker": join(s[:2]) + b"\x00\x12" + join(s[2:]),
        "no_jfif": join(no_jfif),
        **{f"adobe{t}": join(no_jfif[:1] + [a] + no_jfif[1:])
           for t, a in enumerate(adobe)},
        "adobe0_and_jfif": join(s[:2] + [adobe[0]] + s[2:]),
        "ids_rgb": with_ids((82, 71, 66)),
        "ids_other": with_ids((5, 9, 7)),
        "dri_without_rst": join(s[:2] + [dri] + s[2:]),
        "no_eoi": join(s[:-1]),
        "junk_after_eoi": join(s) + b"junk",
        "gray_samp22": None,  # filled below
        "progressive_without_first_dht": join(sp[:first_dht]
                                              + sp[first_dht + 1:]),
        "two_sof": join(s[:sof + 1] + [s[sof]] + s[sof + 1:]),
        "sos_swapped": sos_order((1, 0, 2)),
        "sos_duplicate": sos_order((0, 0, 2)),
        "second_sos_in_baseline": join(s[:sos + 1] + [s[sos]] + s[sos + 1:]),
        # three 2 x 2 components: 12 blocks an MCU, past libjpeg's 10
        "all_samp22": sof_bytes({14: 0x22, 17: 0x22}),
        "sof1": sof_bytes({1: 0xc1}),
        "jpg_marker": sof_bytes({1: 0xc8}),
        # F18: libjpeg refuses these (-2), the coder names them (-7)
        "precision12": sof_bytes({4: 12}),
        **{f"sof{code:x}": sof_bytes({1: code})
           for code in (0xc3, 0xc5, 0xc9, 0xca)},
    }


def test_header_variants_read_equal_libjpeg(tmp_path):
    rng = np.random.default_rng(3)
    img = image(rng, 61, 83)
    Image.fromarray(img).save(tmp_path / "b.jpg", quality=75)
    Image.fromarray(img).save(tmp_path / "p.jpg", quality=75,
                              progressive=True)
    Image.fromarray(img[..., 0]).save(tmp_path / "g.jpg", quality=75)
    variants = header_variants((tmp_path / "b.jpg").read_bytes(),
                               (tmp_path / "p.jpg").read_bytes())
    g = segments((tmp_path / "g.jpg").read_bytes())
    k = [m for m, _ in g].index(0xc0)
    seg = bytearray(g[k][1])
    seg[11] = 0x22
    variants["gray_samp22"] = join(g[:k] + [(0xc0, bytes(seg))] + g[k + 1:])
    codes = {}
    for name, data in variants.items():
        p = tmp_path / f"{name}.jpg"
        p.write_bytes(data)
        codes[name] = assert_single_reads_equal(p, (8, 11), (8, 11), 1 << 14,
                                                allow_f18=True)
    for name in ("precision12", "sofc3", "sofc5", "sofc9", "sofca"):
        assert codes[name] == UNSUPPORTED, name
    for name in ("two_sof", "sos_swapped", "sos_duplicate", "jpg_marker",
                 "second_sos_in_baseline", "all_samp22",
                 "progressive_without_first_dht"):
        assert codes[name] == -2, name
    assert sum(c == 0 for c in codes.values()) >= 17


# -- cut and damaged streams --------------------------------------------------

def scan_spans(data):
    """(start, end) byte offsets of every scan's entropy data."""
    spans, off = [], 0
    for m, seg in segments(data):
        if m == 0xda:
            head = 2 + int.from_bytes(seg[2:4], "big")
            spans.append((off + head, off + len(seg)))
        off += len(seg)
    return spans


@pytest.fixture(scope="module")
def cut_sources(pillow_corpus, odd_corpus):
    """Files whose cuts reach every decoder: baseline, progressive
    (refinement scans included), optimised, grayscale, restarts."""
    pick = [p for p in pillow_corpus[(17, 33)]
            if re.search(r"q(75|95)_s[02]_(base|prog|opt)|q90_grey", p.name)]
    pick += [p for p in odd_corpus if "rst" in p.name]
    return pick


def test_cut_streams_read_equal_libjpeg(tmp_path, cut_sources):
    """Files cut at several offsets inside each scan: libjpeg's
    "premature end" (rc 0, the block in progress read with zero bits, the
    later ones zero) and the coder agree to the coefficient."""
    n_ok = 0
    for src in cut_sources:
        data = src.read_bytes()
        for lo, hi in scan_spans(data):
            for frac in (0.0, 0.1, 0.37, 0.5, 0.81, 0.99):
                cut = lo + int((hi - lo) * frac)
                p = tmp_path / "cut.jpg"
                p.write_bytes(data[:cut])
                rc = assert_single_reads_equal(p, (7, 9), (7, 9), 1 << 14)
                n_ok += rc == 0
    assert n_ok > 200


def test_damaged_streams_read_equal_libjpeg(tmp_path, cut_sources):
    """Seeded damage: bytes changed in the headers and the entropy data,
    bytes inserted and removed, files cut anywhere.  Corrupt Huffman codes,
    restart markers out of place, runs past the block's end: the same
    arrays and return codes as libjpeg, or F18's -7."""
    rng = np.random.default_rng(11)
    codes = {}
    for it in range(600):
        src = cut_sources[rng.integers(len(cut_sources))]
        b = bytearray(src.read_bytes())
        kind = it % 4
        if kind == 0:
            b = b[:rng.integers(2, len(b))]
        elif kind == 1:
            for _ in range(rng.integers(1, 4)):
                b[rng.integers(len(b))] = rng.integers(256)
        elif kind == 2:
            for _ in range(rng.integers(1, 6)):
                b[rng.integers(len(b) * 3 // 10, len(b))] = rng.integers(256)
        else:
            i = int(rng.integers(2, len(b)))
            if rng.integers(2):
                del b[i]
            else:
                b.insert(i, int(rng.integers(256)))
        p = tmp_path / "damaged.jpg"
        p.write_bytes(bytes(b))
        rc = assert_single_reads_equal(p, (7, 9), (7, 9), 1 << 14,
                                       allow_f18=True)
        codes[rc] = codes.get(rc, 0) + 1
    assert codes.get(0, 0) > 200 and codes.get(-2, 0) > 100


# -- F18: arithmetic coding --------------------------------------------------

ARITH_WRITER = r"""
#include <cstdio>
#include <jpeglib.h>
int main(int argc, char** argv) {
  jpeg_compress_struct c;
  jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* f = fopen(argv[1], "wb");
  jpeg_stdio_dest(&c, f);
  c.image_width = 48;
  c.image_height = 32;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  c.arith_code = TRUE;
  if (argc > 2) jpeg_simple_progression(&c);
  jpeg_start_compress(&c, TRUE);
  unsigned char row[48 * 3];
  while (c.next_scanline < c.image_height) {
    for (int x = 0; x < 48 * 3; ++x) row[x] = (x * 7 + c.next_scanline * 13);
    JSAMPROW r = row;
    jpeg_write_scanlines(&c, &r, 1);
  }
  jpeg_finish_compress(&c);
  fclose(f);
  jpeg_destroy_compress(&c);
  return 0;
}
"""


def test_arithmetic_streams_are_f18(tmp_path):
    """F18: libjpeg-turbo decodes arithmetic-coded streams (SOF9, SOF10);
    the coder returns -7 for them before any entropy decode, and the
    engine decodes such items on the host."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build libjpeg's arithmetic writer")
    src = tmp_path / "arith.cpp"
    src.write_text(ARITH_WRITER)
    exe = tmp_path / "arith"
    res = subprocess.run([cxx, str(src), "-o", str(exe), "-ljpeg"],
                         capture_output=True, text=True)
    if res.returncode != 0:
        pytest.skip(f"libjpeg's arithmetic writer does not build: "
                    f"{res.stderr[:200]}")
    for args, sof in (((), 0xc9), (("progressive",), 0xca)):
        p = tmp_path / f"arith_{sof:x}.jpg"
        subprocess.run([str(exe), str(p), *args], check=True)
        assert bytes([0xff, sof]) in p.read_bytes()
        want = read_dense(_jax_lib(), p, (4, 6), (4, 6))
        assert want[0] == 0 and want[3][0] == 32
        got = read_dense(jcoef._load(), p, (4, 6), (4, 6))
        assert got[0] == UNSUPPORTED
        assert not got[1].any() and not got[3].any()
        assert jcoef.read_jpeg_coefs_batch([p], (4, 6))[3][0, 0] == \
            UNSUPPORTED


# -- the writer --------------------------------------------------------------

def legal_grid(rng, shape, density):
    """Coefficients as a quantiser makes them: mostly zero past the low
    frequencies, magnitudes within the baseline range (<= 1023)."""
    keep = rng.random(shape) < density * np.exp(-np.arange(64) / 8.0)
    vals = np.clip(np.round(rng.laplace(0, 40, shape)), -1023, 1023)
    return np.where(keep, vals, 0).astype(np.int16)


def write_both(tmp_path, cy, cc, h, w, q):
    """The dense, sparse and batch writers of both libraries on the same
    grids: every file equal, and the rcs.  Returns our dense file."""
    files = {}
    for lib, tag in ((jcoef, "o"), (jnative, "t")):
        assert lib.write_jpeg_coefs(tmp_path / f"{tag}_d.jpg", cy, cc, h, w,
                                    q)
        flat = np.concatenate([cy.ravel(), cc.ravel()])
        nz = np.nonzero(flat)[0].astype(np.int32)
        cap_nnz = max(len(nz), 1)
        idx = np.zeros((2, cap_nnz), np.int32)
        val = np.zeros((2, cap_nnz), np.int16)
        idx[0, :len(nz)], val[0, :len(nz)] = nz, flat[nz]
        assert lib.write_jpeg_coefs_sparse(
            tmp_path / f"{tag}_s.jpg", idx[0], val[0], len(nz), cy.shape[:2],
            cc.shape[1:3], h, w, q) == 0
        rcs = lib.write_jpeg_coefs_sparse_batch(
            [tmp_path / f"{tag}_b0.jpg", tmp_path / f"{tag}_b1.jpg"], idx,
            val, np.array([len(nz), cap_nnz + 1]), cy.shape[:2],
            cc.shape[1:3], np.array([h, h]), np.array([w, w]), q, 2)
        assert list(rcs) == [0, -6]
        files[tag] = [(tmp_path / f"{tag}_{f}.jpg").read_bytes()
                      for f in ("d", "s", "b0")]
    assert files["o"] == files["t"]
    assert files["o"][0] == files["o"][1] == files["o"][2]
    return files["o"][0]


def test_writer_rewrites_libjpeg_files_byte_for_byte(tmp_path):
    """Grids read from baseline 4:2:0 files (Pillow's defaults, q 1-100,
    odd sizes) and written back at their quality: the source file, byte
    for byte, from both libraries."""
    rng = np.random.default_rng(5)
    for q in (1, 13, 50, 75, 90, 95, 100):
        for h, w in ((1, 1), (7, 9), (17, 33), (16, 16), (45, 70),
                     (8, 200)):
            src = tmp_path / "src.jpg"
            Image.fromarray(image(rng, h, w)).save(src, quality=q)
            cap = (-(-h // 16) * 2, -(-w // 16) * 2)
            cap_c = (cap[0] // 2, cap[1] // 2)
            cy, cc, _, info = jcoef.read_jpeg_coefs(src, cap, cap_c)
            assert (int(info[0]), int(info[1])) == (h, w)
            assert write_both(tmp_path, cy, cc, h, w, q) == src.read_bytes()


def test_writer_random_grids_equal_libjpeg(tmp_path):
    """Random legal grids, 1-200 px, q 1-100 and out-of-range qualities
    (clamped as libjpeg clamps), caps larger than the grid (ignored past
    it): byte for byte, dense, sparse and batched."""
    rng = np.random.default_rng(17)
    for it in range(60):
        h, w = (int(x) for x in rng.integers(1, 201, 2))
        q = int(rng.integers(1, 101)) if it % 15 else (0, 101, -3, 150)[
            it // 15]
        extra = int(rng.integers(0, 3))
        by, bx = -(-h // 16) * 2 + extra, -(-w // 16) * 2 + extra
        cy = legal_grid(rng, (by, bx, 64), rng.random())
        cc = legal_grid(rng, (2, by // 2 + extra, bx // 2 + extra, 64),
                        rng.random())
        if it % 7 == 0:  # every magnitude the tables code
            cy[...] = rng.integers(-1023, 1024, cy.shape)
        data = write_both(tmp_path, cy, cc, h, w, q)
        assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"


def write_dense(lib, path, cy, cc, h, w, q):
    """The dense writer's rc, straight from the C entry point."""
    flat = np.concatenate([cy.ravel(), cc.ravel()])
    return lib.ipp_write_jpeg_coefs(
        str(path).encode(), _p(flat, ctypes.c_int16), cy.shape[0],
        cy.shape[1], cc.shape[1], cc.shape[2], h, w, q)


def test_writer_return_codes_equal_libjpeg(tmp_path):
    """Caps one block short (-3, an empty file left behind), no pixels
    (-4), an index past the grid (-4), a directory that is missing (-1)."""
    cy = np.zeros((4, 4, 64), np.int16)
    cc = np.zeros((2, 2, 2, 64), np.int16)
    cases = [(tmp_path / "a.jpg", 33, 32, -3),
             (tmp_path / "b.jpg", 32, 33, -3),
             (tmp_path / "c.jpg", 0, 5, -4),
             (tmp_path / "no" / "d.jpg", 8, 8, -1)]
    for path, h, w, code in cases:
        assert write_dense(jcoef._load(), path, cy, cc, h, w, 75) == \
            write_dense(jnative._load(), path, cy, cc, h, w, 75) == code
    assert cases[0][0].read_bytes() == b""
    idx = np.array([0, 10 ** 6], np.int32)
    val = np.array([3, 4], np.int16)
    assert jcoef.write_jpeg_coefs_sparse(tmp_path / "e.jpg", idx, val, 2,
                                         (4, 4), (2, 2), 8, 8, 75) == -4
    assert jnative.write_jpeg_coefs_sparse(tmp_path / "f.jpg", idx, val, 2,
                                           (4, 4), (2, 2), 8, 8, 75) == -4


# -- the build ---------------------------------------------------------------

CODEC_LIBS = ("jpeg", "png", "deflate", "z")


def test_build_names_no_codec_library():
    """The coder's compile command links the C++ runtime and pthreads
    only, its source includes no codec header, and its .so needs none of
    libjpeg, libpng, libdeflate and libz (the card machine has no
    jpeglib.h, png.h or libdeflate.h)."""
    cmd = native_build.command(jcoef.SOURCE, Path("out.so"), jcoef.CXX_FLAGS,
                               jcoef.LIBS)
    assert not [a for a in cmd if a.startswith("-l") and a[2:] in CODEC_LIBS]
    assert "-std=c++17" in cmd and cmd[-1] == "-lpthread"
    includes = re.findall(r"^#include\s*<([^>]+)>",
                          jcoef.SOURCE.read_text(), re.M)
    assert includes and not [h for h in includes if re.match(
        r"(jpeglib|jerror|png|zlib|libdeflate|turbojpeg)", h)]
    readelf = shutil.which("readelf")
    assert readelf, "readelf (binutils) reads the library's NEEDED entries"
    out = subprocess.run([readelf, "-d", str(jcoef._SO)],
                         capture_output=True, text=True, check=True).stdout
    needed = re.findall(r"\(NEEDED\)\s+Shared library: \[([^\]]+)\]", out)
    assert needed
    for name in needed:
        stem = name.split(".so")[0].removeprefix("lib")
        assert stem not in CODEC_LIBS and not stem.startswith(
            ("jpeg", "turbojpeg", "png")), name


def test_build_error_names_the_compiler_message(tmp_path, monkeypatch):
    """A coder that cannot be built leaves the module unavailable, with
    the compiler's own words in build_error(), and every entry point
    returns its "not handled" value."""
    monkeypatch.setattr(jcoef, "_lib", None)
    monkeypatch.setattr(jcoef, "_error", None)
    monkeypatch.setattr(jcoef, "_SO", tmp_path / "libipp_jcoef.so")
    bad = tmp_path / "bad.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(jcoef, "SOURCE", bad)
    assert not jcoef.available()
    assert "no_such_header_here.h" in jcoef.build_error()
    grid = np.zeros((2, 2, 64), np.int16), np.zeros((2, 1, 1, 64), np.int16)
    assert jcoef.read_jpeg_coefs(tmp_path / "x.jpg", (2, 2)) is None
    assert jcoef.read_jpeg_coefs_batch([tmp_path / "x.jpg"], (2, 2)) is None
    assert jcoef.read_jpeg_coefs_sparse_batch([tmp_path / "x.jpg"],
                                              (2, 2)) is None
    assert jcoef.write_jpeg_coefs(tmp_path / "x.jpg", *grid, 8, 8, 75) is \
        False
    assert jcoef.write_jpeg_coefs_sparse(
        tmp_path / "x.jpg", np.zeros(1, np.int32), np.zeros(1, np.int16), 0,
        (2, 2), (1, 1), 8, 8, 75) == -100


def test_rebuilt_when_the_source_is_newer(tmp_path):
    """The library is built and its compile timed at the first load, loaded
    as it is while the source is older, and stale once the source is
    newer."""
    src = tmp_path / "ipp_jcoef.cpp"
    src.write_text(jcoef.SOURCE.read_text())
    so = tmp_path / "libipp_jcoef.so"
    args = (src, so, jcoef.CXX_FLAGS, jcoef.LIBS,
            lambda lib: lib.ipp_read_jpeg_coefs)
    assert native_build.stale(src, so)
    native_build.BUILD_SECONDS.pop(so.name, None)
    lib, error = native_build.load(*args)
    assert lib is not None and error is None
    assert not native_build.stale(src, so)
    assert native_build.BUILD_SECONDS.pop(so.name) > 0
    built = so.stat().st_mtime_ns
    assert native_build.load(*args)[0] is not None
    assert so.stat().st_mtime_ns == built
    assert so.name not in native_build.BUILD_SECONDS
    os.utime(src, ns=(built + 10 ** 9, built + 10 ** 9))
    assert native_build.stale(src, so)
