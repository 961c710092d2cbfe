"""ctypes bindings for the port's native IO engine (native/ipp_io.cpp):
header probes, threaded pixel decode into the stacked canvas, the
cv2/Pillow-parity JPEG pixel encoder, the PNG encoders and the YOLO label
parser.  The JPEG coefficient coder of the device_decode and
device_encode transports is not here: it is io/jcoef.py over
native/ipp_jcoef.cpp, which needs no codec library.

The library is built at first use with ``g++`` against the system's
libjpeg, libpng, zlib and libdeflate into ``_build/libipp_io.so`` by
utils/native_build.py (an flock, a temp file renamed into place, a
rebuild when the source is newer).  Where the compiler, a header or a
library is missing, ``available()`` is false, ``build_error()`` says why
in the compiler's words, and every function here returns its "not
handled" value (None, False or -100) so callers keep their Pillow path.

Environment: ``IPP_PNG_MODE`` ("fast" or "parity") and ``IPP_PNG_THREADS``
("auto" or a thread count, clamped to [1, 64]), read at import.
"""

from __future__ import annotations

import ctypes
import os
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from image_processor_pipeline_tpu_torch.utils import native_build

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


def _load():
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            _lib, _error = native_build.load(SOURCE, _SO, CXX_FLAGS, LIBS,
                                             _bind_symbols)
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
    ip = ctypes.POINTER(ctypes.c_int)
    pp = ctypes.POINTER(ctypes.c_char_p)
    sigs = {
        "ipp_probe": ([c_p, ip, ip, ip], c_int),
        "ipp_probe_bands": ([c_p, ip, ip, ip], c_int),
        "ipp_decode": ([c_p, u8p, c_int, c_int, c_int, ip, ip, ip], c_int),
        "ipp_decode_batch": (
            [pp, c_int, u8p, c_int, c_int, c_int, ip, c_int], None),
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
