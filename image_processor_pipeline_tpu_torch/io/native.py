"""ctypes bindings for the port's native IO engine (native/ipp_io.cpp).

The library is built at first use with ``g++`` against the system's
libjpeg, libpng, zlib and libdeflate into ``_build/libipp_io.so``; an flock
serialises the build across processes and the result is renamed into
place, so no process ever loads a half-written library.  It is rebuilt
when the source is newer than it.  Where the compiler, a header or a
library is missing, ``available()`` is false, ``build_error()`` says why
in the compiler's words, and every function here returns its "not
handled" value (None, False or -100) so callers keep their Pillow path.

Environment: ``IPP_PNG_MODE`` ("fast" or "parity") and ``IPP_PNG_THREADS``
("auto" or a thread count, clamped to [1, 64]), read at import.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "ipp_io.cpp"
BUILD = _PKG / "_build"
_SO = BUILD / "libipp_io.so"

# -march=native is safe: _build/ is git-ignored and the library is built
# on the host that loads it
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LIBS = ("-ljpeg", "-lpng", "-lz", "-ldeflate", "-lpthread")

_lock = threading.Lock()
_lib = None
_error: Optional[str] = None


def _stale() -> bool:
    return (not _SO.exists()
            or SOURCE.stat().st_mtime > _SO.stat().st_mtime)


def _build() -> None:
    """Compile the library under an flock, then rename it into place."""
    BUILD.mkdir(exist_ok=True)
    with open(BUILD / ".io.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not _stale():
            return
        tmp = _SO.with_name(f"{_SO.name}.{os.getpid()}.tmp")
        cxx = os.environ.get("CXX", "g++")
        try:
            res = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                capture_output=True, text=True, timeout=300)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"{cxx}: {e}") from None
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cxx} exited with code {res.returncode}:\n"
                f"{res.stderr.strip()}")
        os.replace(tmp, _SO)


def _load():
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        try:
            if _stale():
                _build()
            lib = ctypes.CDLL(str(_SO))
            _bind_symbols(lib)
        except (RuntimeError, OSError, AttributeError) as e:
            _error = str(e)
            return None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    """Why the library is unavailable (the compiler's or the loader's
    message), or None when it is built and loaded."""
    _load()
    return _error


def _bind_symbols(lib) -> None:
    """Declare argtypes/restypes for every exported symbol.  Raises
    AttributeError when the loaded library lacks one."""
    c_int, c_p = ctypes.c_int, ctypes.c_char_p
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ip = ctypes.POINTER(ctypes.c_int)
    pp = ctypes.POINTER(ctypes.c_char_p)
    sigs = {
        "ipp_probe": ([c_p, ip, ip, ip], c_int),
        "ipp_probe_bands": ([c_p, ip, ip, ip], c_int),
        "ipp_decode": ([c_p, u8p, c_int, c_int, c_int, ip, ip, ip], c_int),
        "ipp_decode_batch": (
            [pp, c_int, u8p, c_int, c_int, c_int, ip, c_int], None),
        "ipp_read_jpeg_coefs": (
            [c_p, i16p, c_int, c_int, c_int, c_int, u16p, ip], c_int),
        "ipp_read_jpeg_coefs_sparse": (
            [c_p, i32p, i16p, c_int, ip, c_int, c_int, c_int, c_int, u16p,
             ip], c_int),
        "ipp_read_jpeg_coefs_sparse_batch": (
            [pp, c_int, i32p, i16p, c_int, ip, c_int, c_int, c_int, c_int,
             u16p, ip, c_int], None),
        "ipp_read_jpeg_coefs_batch": (
            [pp, c_int, i16p, c_int, c_int, c_int, c_int, u16p, ip, c_int],
            None),
        "ipp_encode_jpeg": (
            [c_p, u8p, c_int, c_int, c_int, c_int, c_int], c_int),
        "ipp_encode_png": (
            [c_p, u8p, c_int, c_int, c_int, c_int, c_int], c_int),
        "ipp_encode_png_fast": (
            [c_p, u8p, c_int, c_int, c_int, c_int, c_int, c_int], c_int),
        "ipp_encode_png_tiled": (
            [c_p, u8p, c_int, c_int, c_int, c_int, c_int, c_int, c_int],
            c_int),
        "ipp_zlib_piece": ([ctypes.c_size_t], ctypes.c_size_t),
        "ipp_set_zlib_piece": ([ctypes.c_size_t], None),
        "ipp_write_jpeg_coefs": (
            [c_p, i16p, c_int, c_int, c_int, c_int, c_int, c_int, c_int],
            c_int),
        "ipp_write_jpeg_coefs_sparse": (
            [c_p, i32p, i16p, c_int, c_int, c_int, c_int, c_int, c_int,
             c_int, c_int], c_int),
        "ipp_write_jpeg_coefs_sparse_batch": (
            [pp, c_int, i32p, i16p, c_int, ip, c_int, c_int, c_int, c_int,
             ip, ip, c_int, ip, c_int], None),
        "ipp_parse_yolo": ([c_p, ip, ctypes.POINTER(ctypes.c_float), c_int],
                           c_int),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _c_path(path) -> Optional[bytes]:
    """Filesystem-encoded path bytes for the C ABI, or None when the name
    can't be encoded (surrogate-escaped names etc.) — callers then fall
    back to the Pillow path, which handles such names via os.fsencode."""
    try:
        return os.fsencode(str(path))
    except (UnicodeEncodeError, ValueError):
        return None


def _c_paths(paths):
    cps = [_c_path(p) for p in paths]
    if any(cp is None for cp in cps):
        return None
    return (ctypes.c_char_p * len(cps))(*cps)


def _threads(n_threads: int, n: int) -> int:
    return n_threads if n_threads > 0 else max(1, min(n, os.cpu_count() or 1))


def _hwc(lib_fn, path):
    lib = _load()
    cp = _c_path(path)
    if lib is None or cp is None:
        return None
    a, b, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = getattr(lib, lib_fn)(cp, ctypes.byref(a), ctypes.byref(b),
                              ctypes.byref(c))
    if rc != 0:
        return None
    return a.value, b.value, c.value


def probe(path: Path) -> Optional[Tuple[int, int, int]]:
    """Header-only dims probe: (h, w, decoded_channels) or None.
    decoded_channels is what the native decoder will produce (3 or 4)."""
    return _hwc("ipp_probe", path)


def probe_bands(path: Path) -> Optional[Tuple[int, int, int]]:
    """Band-safe header probe: (h, w, kind) where kind = 3 (native decode
    == Pillow native-bands RGB), 4 (RGBA), or 0 (grayscale/palette/16-bit/
    tRNS — callers must keep their per-item Pillow path).  None when the
    native engine or the file is unavailable."""
    return _hwc("ipp_probe_bands", path)


def decode_to_canvas(path: Path, canvas: Tuple[int, int],
                     channels: int = 3) -> Optional[Tuple[np.ndarray, int, int, int]]:
    """Decode into a zero-padded canvas buffer.  Returns (buf, h, w, nch)
    or None when the native path can't handle the file."""
    lib = _load()
    cp = _c_path(path)
    if lib is None or cp is None:
        return None
    buf = np.zeros((canvas[0], canvas[1], channels), np.uint8)
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib.ipp_decode(cp, _ptr(buf, ctypes.c_uint8), canvas[0], canvas[1],
                        channels, ctypes.byref(h), ctypes.byref(w),
                        ctypes.byref(c))
    if rc != 0:
        return None
    # RGB source promoted into an RGBA canvas needs opaque alpha
    if channels == 4 and c.value == 3:
        buf[: h.value, : w.value, 3] = 255
    return buf, h.value, w.value, c.value


def decode_batch(paths: Sequence[Path], canvas: Tuple[int, int],
                 channels: int = 3, n_threads: int = 0,
                 n_rows: Optional[int] = None,
                 out: Optional[np.ndarray] = None) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Threaded batch decode into one [N, H, W, C] canvas array.

    Returns (batch, dims[N, 3]) with dims rows (h, w, native_ch); a negative
    h marks a failed item.  None when the native engine is unavailable.
    ``n_rows`` (>= len(paths)) allocates extra all-zero rows at the tail so
    the result can serve directly as a ladder-padded batch's stacked array.
    ``out``: a zeroed C-contiguous uint8 array of that shape to decode
    into (the engine passes pinned memory for a step on a card).
    """
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    arr = _c_paths(paths)
    if arr is None:
        return None  # callers fall back to per-item decode
    shape = (max(n_rows or n, n), canvas[0], canvas[1], channels)
    batch = np.zeros(shape, np.uint8) if out is None else out
    assert batch.shape == shape and batch.flags.c_contiguous
    dims = np.zeros((n, 3), np.int32)
    lib.ipp_decode_batch(arr, n, _ptr(batch, ctypes.c_uint8), canvas[0],
                         canvas[1], channels, _ptr(dims, ctypes.c_int),
                         _threads(n_threads, n))
    return batch, dims


def _row_strided(arr: np.ndarray):
    """(base_pointer_array, stride_bytes, flip_x) when `arr` is a
    row-strided view with packed pixels — the native encoders consume it
    zero-copy.  Three view classes qualify:
      - canvas crops (arr[:h, :w] of a larger canvas): positive pitch;
      - vertically-flipped views (arr[::-1]): NEGATIVE pitch — the C row
        loop walks backwards from the view's first row;
      - horizontally-flipped views (arr[:, ::-1]): pixel stride -c — the
        pointer is normalized to memory order and flip_x=1 makes the
        encoder assemble each row reversed in its write loop.
    Falls back to a contiguous copy otherwise."""
    c = arr.shape[2] if arr.ndim == 3 else 1
    if arr.ndim == 3 and arr.strides[2] == 1:
        cand, flip_x = arr, 0
        if arr.strides[1] == -c and arr.shape[1] > 1:
            cand = arr[:, ::-1]  # memory-ordered pixels, same rows
            flip_x = 1
        if (cand.strides[1] == c
                and abs(cand.strides[0]) >= cand.shape[1] * c):
            return cand, int(cand.strides[0]), flip_x
    # fallback: contiguous copy of the ORIGINAL view (never the
    # flip-normalized candidate — that would silently encode the mirror)
    arr = np.ascontiguousarray(arr)
    return arr, arr.shape[1] * (arr.shape[2] if arr.ndim == 3 else 1), 0


def encode_jpeg(path: Path, rgb: np.ndarray, quality: int = 95) -> bool:
    """Baseline 4:2:0 JPEG at ``quality``: the bytes of cv2.imwrite and
    Pillow's Image.save at that quality on the same libjpeg."""
    lib = _load()
    if lib is None:
        return False
    if rgb.ndim != 3 or rgb.shape[2] != 3 or rgb.dtype != np.uint8:
        return False
    cp = _c_path(path)
    if cp is None:
        return False
    rgb, stride, flip_x = _row_strided(rgb)
    rc = lib.ipp_encode_jpeg(cp, _ptr(rgb, ctypes.c_uint8), rgb.shape[0],
                             rgb.shape[1], stride, quality, flip_x)
    return rc == 0


#: PNG encoder mode: "fast" (default) = SUB filter + libdeflate level 1 —
#: same pixels, faster and smaller files on photographic content;
#: "parity" = the cv2.imwrite byte-identical zlib Z_RLE stream.
PNG_MODE = os.environ.get("IPP_PNG_MODE", "fast")

#: Tiled parallel PNG encode (per-band raw deflate in threads, Z_FULL_FLUSH
#: stitching, adler32_combine).  "auto" (default) uses it only where it
#: beats single-threaded libdeflate: >= 4 cores per concurrent encode AND
#: a payload big enough to amortize thread spawn.  An integer forces that
#: thread count, clamped to [1, PNG_THREADS_MAX] (tests force 4 on small
#: hosts — same pixels either way).
PNG_THREADS = os.environ.get("IPP_PNG_THREADS", "auto")
PNG_THREADS_MAX = 64

#: auto mode's minimum raw payload (bytes) before threads pay for
#: themselves; ~1 MB = a 512x512 RGBA canvas
_PNG_TILE_MIN_BYTES = 1 << 20

#: how many encodes run concurrently (the engine's saver-pool width) —
#: file-level parallelism already owns those cores, so auto tiling
#: divides by it rather than oversubscribing (workers x ncpu threads)
_ENCODER_CONCURRENCY = 1


def set_encoder_concurrency(n: int) -> int:
    """Declare how many saver threads encode concurrently
    (ProcessingStep.workers); returns the previous value so the caller can
    restore it.  Auto-tiled PNG splits the remaining cores; at workers >=
    ncpu/4 it shuts off entirely."""
    global _ENCODER_CONCURRENCY
    prev = _ENCODER_CONCURRENCY
    _ENCODER_CONCURRENCY = max(1, int(n))
    return prev


def encoder_concurrency() -> int:
    return _ENCODER_CONCURRENCY


def _png_threads(nbytes: int) -> int:
    if PNG_THREADS == "auto":
        ncpu = (os.cpu_count() or 1) // _ENCODER_CONCURRENCY
        if ncpu >= 4 and nbytes >= _PNG_TILE_MIN_BYTES:
            return min(ncpu, 8)
        return 1
    try:
        return min(max(1, int(PNG_THREADS)), PNG_THREADS_MAX)
    except ValueError:
        return 1


def encode_png(path: Path, data: np.ndarray,
               mode: Optional[str] = None) -> bool:
    lib = _load()
    if lib is None:
        return False
    if data.ndim == 2:
        data = data[:, :, None]
    if data.dtype != np.uint8 or data.ndim != 3 or data.shape[2] not in (1, 3, 4):
        return False
    cp = _c_path(path)
    if cp is None:
        return False
    data, stride, flip_x = _row_strided(data)
    h, w, c = data.shape
    ptr = _ptr(data, ctypes.c_uint8)
    if (mode or PNG_MODE) == "fast":
        threads = _png_threads(h * w * c)
        if threads > 1:
            rc = lib.ipp_encode_png_tiled(cp, ptr, h, w, stride, c, 1,
                                          flip_x, threads)
        else:
            rc = lib.ipp_encode_png_fast(cp, ptr, h, w, stride, c, 1, flip_x)
    else:
        rc = lib.ipp_encode_png(cp, ptr, h, w, stride, c, flip_x)
    return rc == 0


def zlib_piece(remaining: int) -> int:
    """The bytes of a tiled-PNG band handed to zlib in one call (its
    counts are 32-bit): ``min(remaining, the piece limit)``."""
    return int(_load().ipp_zlib_piece(remaining))


def set_zlib_piece(limit: int) -> None:
    """Lower the piece limit (to no less than 64 bytes; 0 restores 1 GiB),
    so the piecewise path can be exercised on small images."""
    _load().ipp_set_zlib_piece(limit)


def parse_yolo(path: Path, max_boxes: int = 256) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    cp = _c_path(path)
    if lib is None or cp is None:
        return None
    cls = np.zeros((max_boxes,), np.int32)
    xywhn = np.zeros((max_boxes, 4), np.float32)
    n = lib.ipp_parse_yolo(cp, _ptr(cls, ctypes.c_int),
                           _ptr(xywhn, ctypes.c_float), max_boxes)
    if n < 0:
        return None
    return cls[:n].astype(np.int64), xywhn[:n]


def _caps(cap_blocks, cap_blocks_c):
    cap_by, cap_bx = cap_blocks
    if cap_blocks_c is None:
        cap_blocks_c = ((cap_by + 1) // 2, (cap_bx + 1) // 2)
    return cap_by, cap_bx, cap_blocks_c[0], cap_blocks_c[1]


def read_jpeg_coefs(path: Path, cap_blocks: Tuple[int, int],
                    cap_blocks_c: Optional[Tuple[int, int]] = None):
    """Entropy-decode a JPEG's quantized DCT coefficients (hybrid decode:
    the device finishes with dequant + IDCT + upsample + color conversion,
    ops/jpeg.py).  cap_blocks bounds the luma block grid; cap_blocks_c the
    chroma grids (default: half of cap_blocks, the 4:2:0 layout).

    Returns (coefs_y [cap_by, cap_bx, 64] int16,
    coefs_c [2, cap_by_c, cap_bx_c, 64] int16, qtabs [3, 64] uint16,
    info [16] int32 = {h, w, ncomp, (h_samp, v_samp, by, bx) x 3,
    jpeg_color_space}) or None when the native engine is unavailable or
    the file can't be handled.
    """
    lib = _load()
    cp = _c_path(path)
    if lib is None or cp is None:
        return None
    cap_by, cap_bx, cap_by_c, cap_bx_c = _caps(cap_blocks, cap_blocks_c)
    ny = cap_by * cap_bx * 64
    nc = cap_by_c * cap_bx_c * 64
    flat = np.zeros(ny + 2 * nc, np.int16)
    qtabs = np.zeros((3, 64), np.uint16)
    info = np.zeros(16, np.int32)
    rc = lib.ipp_read_jpeg_coefs(
        cp, _ptr(flat, ctypes.c_int16), cap_by, cap_bx, cap_by_c, cap_bx_c,
        _ptr(qtabs, ctypes.c_uint16), _ptr(info, ctypes.c_int))
    if rc != 0:
        return None
    return (flat[:ny].reshape(cap_by, cap_bx, 64),
            flat[ny:].reshape(2, cap_by_c, cap_bx_c, 64), qtabs, info)


def read_jpeg_coefs_batch(paths: Sequence[Path], cap_blocks: Tuple[int, int],
                          cap_blocks_c: Optional[Tuple[int, int]] = None,
                          n_threads: int = 0):
    """Threaded batch coefficient extraction (one C call for the bucket).

    Returns (coefs_y [N, cap_by, cap_bx, 64] int16,
    coefs_c [N, 2, cap_by_c, cap_bx_c, 64] int16, qtabs [N, 3, 64] uint16,
    infos [N, 16] int32; infos[i, 0] < 0 marks a failed item) or None when
    the native engine is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    arr = _c_paths(paths)
    if arr is None:
        return None
    cap_by, cap_bx, cap_by_c, cap_bx_c = _caps(cap_blocks, cap_blocks_c)
    ny = cap_by * cap_bx * 64
    nc = cap_by_c * cap_bx_c * 64
    flat = np.zeros((n, ny + 2 * nc), np.int16)
    qtabs = np.zeros((n, 3, 64), np.uint16)
    infos = np.zeros((n, 16), np.int32)
    lib.ipp_read_jpeg_coefs_batch(
        arr, n, _ptr(flat, ctypes.c_int16), cap_by, cap_bx, cap_by_c,
        cap_bx_c, _ptr(qtabs, ctypes.c_uint16), _ptr(infos, ctypes.c_int),
        _threads(n_threads, n))
    return (flat[:, :ny].reshape(n, cap_by, cap_bx, 64),
            flat[:, ny:].reshape(n, 2, cap_by_c, cap_bx_c, 64), qtabs, infos)


def read_jpeg_coefs_sparse_batch(paths: Sequence[Path],
                                 cap_blocks: Tuple[int, int],
                                 cap_blocks_c: Optional[Tuple[int, int]] = None,
                                 cap_nnz: Optional[int] = None,
                                 n_threads: int = 0):
    """Threaded sparse (COO) batch coefficient extraction.

    Each nonzero coefficient ships as a 6-byte (idx int32, val int16) pair
    instead of the dense grids — a device scatter-add reconstructs the
    dense layout (ops/jpeg.py:decode_finish_sparse).

    Returns (idx [N, cap_nnz] int32, val [N, cap_nnz] int16, nnz [N] int32,
    qtabs [N, 3, 64] uint16, infos [N, 16] int32) or None when the native
    engine is unavailable.  infos[i, 0] < 0 marks a failed item; -6 means
    the file's nonzero count exceeded cap_nnz (fall back to the dense
    reader for that file).  Padding entries are (0, 0) — harmless under
    scatter-add.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    arr = _c_paths(paths)
    if arr is None:
        return None
    cap_by, cap_bx, cap_by_c, cap_bx_c = _caps(cap_blocks, cap_blocks_c)
    if cap_nnz is None:
        # 6 B/pair vs 2 B/dense slot: a dense/4 cap keeps the worst case
        # below dense transport
        dense_slots = cap_by * cap_bx * 64 + 2 * cap_by_c * cap_bx_c * 64
        cap_nnz = max(1024, dense_slots // 4)
    idx = np.zeros((n, cap_nnz), np.int32)
    val = np.zeros((n, cap_nnz), np.int16)
    nnz = np.zeros((n,), np.int32)
    qtabs = np.zeros((n, 3, 64), np.uint16)
    infos = np.zeros((n, 16), np.int32)
    lib.ipp_read_jpeg_coefs_sparse_batch(
        arr, n, _ptr(idx, ctypes.c_int32), _ptr(val, ctypes.c_int16),
        cap_nnz, _ptr(nnz, ctypes.c_int), cap_by, cap_bx, cap_by_c,
        cap_bx_c, _ptr(qtabs, ctypes.c_uint16), _ptr(infos, ctypes.c_int),
        _threads(n_threads, n))
    return idx, val, nnz, qtabs, infos


def write_jpeg_coefs(path: Path, coefs_y: np.ndarray, coefs_c: np.ndarray,
                     h: int, w: int, quality: int) -> bool:
    """Entropy-only JPEG write from device-quantized coefficients (the
    host half of the hybrid device encode, ops/jpeg.py:encode_start).

    coefs_y: [cap_by, cap_bx, 64] int16; coefs_c: [2, cap_by_c, cap_bx_c,
    64] int16 (natural order, the reader's layout).  The file is
    byte-identical to encode_jpeg(quality) on the original pixels.
    """
    lib = _load()
    cp = _c_path(path)
    if lib is None or cp is None:
        return False
    coefs_y = np.ascontiguousarray(coefs_y, np.int16)
    coefs_c = np.ascontiguousarray(coefs_c, np.int16)
    flat = np.concatenate([coefs_y.ravel(), coefs_c.ravel()])
    rc = lib.ipp_write_jpeg_coefs(
        cp, _ptr(flat, ctypes.c_int16), coefs_y.shape[0], coefs_y.shape[1],
        coefs_c.shape[1], coefs_c.shape[2], int(h), int(w), int(quality))
    return rc == 0


def write_jpeg_coefs_sparse(path: Path, idx: np.ndarray, val: np.ndarray,
                            nnz: int, cap_blocks: Tuple[int, int],
                            cap_blocks_c: Tuple[int, int], h: int, w: int,
                            quality: int) -> int:
    """Single-item entropy-only JPEG write from sparse device coefficients
    (the saver-thread path of the device_encode transport).  Returns the
    native rc (0 = ok) or -100 when the engine is unavailable."""
    lib = _load()
    cp = _c_path(path)
    if lib is None or cp is None:
        return -100
    idx = np.ascontiguousarray(idx[:nnz], np.int32)
    val = np.ascontiguousarray(val[:nnz], np.int16)
    return lib.ipp_write_jpeg_coefs_sparse(
        cp, _ptr(idx, ctypes.c_int32), _ptr(val, ctypes.c_int16), int(nnz),
        cap_blocks[0], cap_blocks[1], cap_blocks_c[0], cap_blocks_c[1],
        int(h), int(w), int(quality))


def write_jpeg_coefs_sparse_batch(paths: Sequence[Path], idx: np.ndarray,
                                  val: np.ndarray, nnz: np.ndarray,
                                  cap_blocks: Tuple[int, int],
                                  cap_blocks_c: Tuple[int, int],
                                  hs: np.ndarray, ws: np.ndarray,
                                  quality: int, n_threads: int = 0):
    """Threaded batch entropy-only JPEG write from sparse (COO) device
    coefficients (ops/jpeg.py:encode_start_sparse output).

    idx [N, cap_nnz] int32 / val [N, cap_nnz] int16 / nnz [N] int32;
    nnz[i] > cap_nnz marks a device-side compaction overflow → rc -6 for
    that item.  Returns rcs [N] int32 (0 = ok) or None when the engine is
    unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    arr = _c_paths(paths)
    if arr is None:
        return None
    idx = np.ascontiguousarray(idx, np.int32)
    val = np.ascontiguousarray(val, np.int16)
    nnz = np.ascontiguousarray(nnz, np.int32)
    hs = np.ascontiguousarray(hs, np.int32)
    ws = np.ascontiguousarray(ws, np.int32)
    rcs = np.zeros((n,), np.int32)
    lib.ipp_write_jpeg_coefs_sparse_batch(
        arr, n, _ptr(idx, ctypes.c_int32), _ptr(val, ctypes.c_int16),
        int(idx.shape[1]), _ptr(nnz, ctypes.c_int), cap_blocks[0],
        cap_blocks[1], cap_blocks_c[0], cap_blocks_c[1],
        _ptr(hs, ctypes.c_int), _ptr(ws, ctypes.c_int), int(quality),
        _ptr(rcs, ctypes.c_int), _threads(n_threads, n))
    return rcs
