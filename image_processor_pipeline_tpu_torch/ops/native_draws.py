"""ctypes bindings for the flagship chain's host draws
(native/ipp_draws.cpp): ``models/chains.py:_crop_params`` and
``_flip_and_params`` for a whole batch in one native call each, bit for
bit the draws of ``random.py`` (and so of ``jax.random``), which stays
their numpy twin and the chains' path where this library is unavailable.

The library is built at first use with ``g++`` straight from the source
into ``_build/libipp_draws.so`` by utils/native_build.py (an flock, a temp
file renamed into place, a rebuild when the source is newer); it links no
library.  ``-ffp-contract=off`` keeps every float32 operation rounded on
its own, as the bbox corners and the draws' single FMA need (never
``-ffast-math``).  Where the build or the load fails, ``available()`` is
false and ``build_error()`` says why in the compiler's words.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from image_processor_pipeline_tpu_torch.utils import native_build

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "ipp_draws.cpp"
BUILD = _PKG / "_build"
_SO = BUILD / "libipp_draws.so"

# -march=native is safe: _build/ is git-ignored and the library is built
# on the host that loads it
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-ffp-contract=off", "-shared")
LIBS = ()

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
    """Declare argtypes/restypes for the two exports.  Raises
    AttributeError when the loaded library lacks one."""
    c_int, p = ctypes.c_int, ctypes.c_void_p
    lib.ipp_chain_crop_draws.argtypes = [p, p, c_int, c_int, c_int, c_int,
                                         p, p, p]
    lib.ipp_chain_flip_draws.argtypes = [p, c_int, p, p]
    lib.ipp_chain_crop_draws.restype = lib.ipp_chain_flip_draws.restype = None


def _seeds(seeds: np.ndarray) -> np.ndarray:
    """The seeds [B] as uint64, checked as ``random.PRNGKey`` checks them:
    TypeError for a non-integer dtype, ValueError for a negative seed."""
    seeds = np.asarray(seeds)
    if seeds.dtype.kind not in "iu":
        raise TypeError(f"seed must be an integer, got dtype {seeds.dtype}")
    if seeds.dtype.kind == "i" and (seeds < 0).any():
        raise ValueError("seed must be non-negative")
    if seeds.ndim != 1:
        raise ValueError(f"seeds must be one-dimensional, got shape "
                         f"{seeds.shape}")
    return np.ascontiguousarray(seeds, np.uint64)


def crop_draws(seeds: np.ndarray, xywhn: np.ndarray, H: int, W: int,
               crop: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``_crop_params``' draws: (y0 [B] int32, x0 [B] int32, angle [B]
    float32) for non-negative integer ``seeds`` [B] and boxes ``xywhn``
    that broadcast to [B, 4] (rounded to float32).  The library must be
    available."""
    seeds = _seeds(seeds)
    B = len(seeds)
    boxes = np.ascontiguousarray(xywhn, np.float32)
    if boxes.shape != (B, 4):
        boxes = np.ascontiguousarray(np.broadcast_to(boxes, (B, 4)))
    y0, x0 = np.empty(B, np.int32), np.empty(B, np.int32)
    angle = np.empty(B, np.float32)
    _load().ipp_chain_crop_draws(
        seeds.ctypes.data, boxes.ctypes.data, B, H, W, crop, y0.ctypes.data,
        x0.ctypes.data, angle.ctypes.data)
    return y0, x0, angle


def flip_draws(seeds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``_flip_and_params``' draws: (flips [B] int32, prm [B, 8] float32)
    for non-negative integer ``seeds`` [B].  The library must be
    available."""
    seeds = _seeds(seeds)
    B = len(seeds)
    flips, prm = np.empty(B, np.int32), np.empty((B, 8), np.float32)
    _load().ipp_chain_flip_draws(seeds.ctypes.data, B, flips.ctypes.data,
                                 prm.ctypes.data)
    return flips, prm
