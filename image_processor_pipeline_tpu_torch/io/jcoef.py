"""ctypes bindings for the port's JPEG coefficient coder
(native/ipp_jcoef.cpp): the host half of the coefficient transports.

The reader entropy-decodes a JPEG into its quantised DCT coefficients (the
device finishes the decode: ops/jpeg.py:decode_finish); the writer
entropy-encodes coefficients quantised on the device (ops/jpeg.py:
encode_start) into a baseline 4:2:0 file.  The arrays, tables, ``info``
rows, return codes and files are those of libjpeg's
``jpeg_read_coefficients`` / ``jpeg_write_coefficients``; the one
exception, -7 for arithmetic, lossless, hierarchical and 12-bit streams,
is documented in the source.

The library needs no codec library: it is built at first use with ``g++
-std=c++17`` and ``-lpthread`` alone into ``_build/libipp_jcoef.so`` by
utils/native_build.py (an flock, a temp file renamed into place, a
rebuild when the source is newer).  Where the compiler is missing, ``available()`` is false, ``build_error()`` says why
in the compiler's words, and every function here returns its "not
handled" value (None, False or -100).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

from image_processor_pipeline_tpu_torch.io.native import (
    _c_path,
    _c_paths,
    _ptr,
    _threads,
)
from image_processor_pipeline_tpu_torch.utils import native_build

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "ipp_jcoef.cpp"
BUILD = _PKG / "_build"
_SO = BUILD / "libipp_jcoef.so"

# -march=native is safe: _build/ is git-ignored and the library is built
# on the host that loads it
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-shared")
LIBS = ("-lpthread",)

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
    """Why the coder is unavailable (the compiler's or the loader's
    message), or None when it is built and loaded."""
    _load()
    return _error


def _bind_symbols(lib) -> None:
    """Declare argtypes/restypes for every exported symbol.  Raises
    AttributeError when the loaded library lacks one."""
    c_int, c_p = ctypes.c_int, ctypes.c_char_p
    i16p = ctypes.POINTER(ctypes.c_int16)
    u16p = ctypes.POINTER(ctypes.c_uint16)
    i32p = ctypes.POINTER(ctypes.c_int32)
    ip = ctypes.POINTER(ctypes.c_int)
    pp = ctypes.POINTER(ctypes.c_char_p)
    sigs = {
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
        "ipp_write_jpeg_coefs": (
            [c_p, i16p, c_int, c_int, c_int, c_int, c_int, c_int, c_int],
            c_int),
        "ipp_write_jpeg_coefs_sparse": (
            [c_p, i32p, i16p, c_int, c_int, c_int, c_int, c_int, c_int,
             c_int, c_int], c_int),
        "ipp_write_jpeg_coefs_sparse_batch": (
            [pp, c_int, i32p, i16p, c_int, ip, c_int, c_int, c_int, c_int,
             ip, ip, c_int, ip, c_int], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res


def _caps(cap_blocks, cap_blocks_c):
    cap_by, cap_bx = cap_blocks
    if cap_blocks_c is None:
        cap_blocks_c = ((cap_by + 1) // 2, (cap_bx + 1) // 2)
    return cap_by, cap_bx, cap_blocks_c[0], cap_blocks_c[1]


def read_jpeg_coefs(path: Path, cap_blocks: Tuple[int, int],
                    cap_blocks_c: Optional[Tuple[int, int]] = None):
    """Entropy-decode a JPEG's quantised DCT coefficients.  cap_blocks
    bounds the luma block grid; cap_blocks_c the chroma grids (default:
    half of cap_blocks, the 4:2:0 layout).

    Returns (coefs_y [cap_by, cap_bx, 64] int16,
    coefs_c [2, cap_by_c, cap_bx_c, 64] int16, qtabs [3, 64] uint16,
    info [16] int32 = {h, w, ncomp, (h_samp, v_samp, by, bx) x 3,
    jpeg_color_space}) or None when the coder is unavailable or the file
    can't be handled.
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
    the coder is unavailable.
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
    qtabs [N, 3, 64] uint16, infos [N, 16] int32) or None when the coder
    is unavailable.  infos[i, 0] < 0 marks a failed item; -6 means the
    file's nonzero count exceeded cap_nnz (fall back to the dense reader
    for that file).  Padding entries are (0, 0) — harmless under
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
    """Entropy-only JPEG write from device-quantised coefficients (the
    host half of the hybrid device encode, ops/jpeg.py:encode_start).

    coefs_y: [cap_by, cap_bx, 64] int16; coefs_c: [2, cap_by_c, cap_bx_c,
    64] int16 (natural order, the reader's layout).  The file is
    byte-identical to a baseline 4:2:0 libjpeg encode at ``quality`` of
    the pixels the coefficients came from.
    """
    lib = _load()
    cp = _c_path(path)
    if lib is None or cp is None:
        return False
    coefs_y = np.ascontiguousarray(coefs_y, np.int16)
    coefs_c = np.ascontiguousarray(coefs_c, np.int16)
    flat = np.concatenate([coefs_y.ravel(), coefs_c.ravel()])
    return lib.ipp_write_jpeg_coefs(
        cp, _ptr(flat, ctypes.c_int16), coefs_y.shape[0], coefs_y.shape[1],
        coefs_c.shape[1], coefs_c.shape[2], int(h), int(w),
        int(quality)) == 0


def write_jpeg_coefs_sparse(path: Path, idx: np.ndarray, val: np.ndarray,
                            nnz: int, cap_blocks: Tuple[int, int],
                            cap_blocks_c: Tuple[int, int], h: int, w: int,
                            quality: int) -> int:
    """Single-item entropy-only JPEG write from sparse device coefficients
    (the saver-thread path of the device_encode transport).  Returns the
    coder's rc (0 = ok) or -100 when the coder is unavailable."""
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
    that item.  Returns rcs [N] int32 (0 = ok) or None when the coder is
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
