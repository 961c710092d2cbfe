"""ctypes bindings for the flagship chain's host draws
(native/ipp_draws.cpp): ``models/chains.py:_crop_params`` and
``_flip_and_params`` for a whole batch in one native call each, bit for
bit the draws of ``random.py`` (and so of ``jax.random``), which stays
their numpy twin and the chains' path where this library is unavailable;
``shear_factors``, ``geometry.shear_factors`` of the drawn angles, its
exact arithmetic in one native pass (``chain_angles``) and only ``tan``
and ``sin`` left to torch; and ``chain_pack``, which writes a
'cuda_full' call's item rows, enhance rows and shift vectors into one
buffer for one copy to the card.

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
import functools
import threading
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

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
    """Declare argtypes/restypes for the four exports.  Raises
    AttributeError when the loaded library lacks one."""
    c_int, p = ctypes.c_int, ctypes.c_void_p
    lib.ipp_chain_crop_draws.argtypes = [p, p, c_int, c_int, c_int, c_int,
                                         p, p, p]
    lib.ipp_chain_flip_draws.argtypes = [p, c_int, p, p]
    lib.ipp_chain_angles.argtypes = [c_int] + [p] * 4
    lib.ipp_chain_pack.argtypes = [c_int, c_int] + [p] * 8 + [c_int] * 2 \
        + [p] * 4
    for fn in (lib.ipp_chain_crop_draws, lib.ipp_chain_flip_draws,
               lib.ipp_chain_angles, lib.ipp_chain_pack):
        fn.restype = None


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


def chain_angles(angles: np.ndarray
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(quad [B] int32, phi / 2 [B] float32, phi [B] float32) of the drawn
    angles [B] in degrees (a contiguous float32 numpy array, as
    ``crop_draws`` gives them; any other form raises ValueError): the
    quarter turn and remainder of ``geometry.shear_factors``, from one
    native pass of its float32 and integer operations, bit for bit for
    finite angles.  The library must be available."""
    if not (isinstance(angles, np.ndarray) and angles.dtype == np.float32
            and angles.ndim == 1 and angles.flags.c_contiguous):
        raise ValueError("chain_angles needs the angles as a contiguous "
                         "float32 [B] numpy array")
    B = len(angles)
    quad = torch.empty(B, dtype=torch.int32)
    half_phi, phi = torch.empty(B), torch.empty(B)
    _load().ipp_chain_angles(B, angles.ctypes.data, quad.data_ptr(),
                             half_phi.data_ptr(), phi.data_ptr())
    return quad, half_phi, phi


def shear_factors(angles: np.ndarray
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(quad, a = tan(phi / 2), s = sin(phi)) [B] of ``chain_angles``:
    ``geometry.shear_factors``' quad and a, and the negation of its b,
    with ``tan`` and ``sin`` torch's, in place on the [B] host tensors."""
    quad, a, s = chain_angles(angles)
    return quad, a.tan_(), s.sin_()


#: each section of ``chain_pack``'s buffer starts at a multiple of this
ALIGN = 256


class PackLayout(NamedTuple):
    """Byte offsets of the sections of ``chain_pack``'s buffer for B items
    and S px crops, and its size: item rows [B, 4] int32, enhance rows
    [B, 8] float32, sh1 and sh2 [B, S] int32."""
    B: int
    S: int
    items: int
    enh: int
    sh1: int
    sh2: int
    nbytes: int


@functools.lru_cache(maxsize=None)
def pack_layout(B: int, S: int) -> PackLayout:
    def up(n):
        return -(-n // ALIGN) * ALIGN
    enh = up(16 * B)
    sh1 = enh + up(32 * B)
    sh2 = sh1 + up(4 * B * S)
    return PackLayout(B, S, 0, enh, sh1, sh2, sh2 + 4 * B * S)


def section(buf: torch.Tensor, layout: PackLayout, name: str):
    """The section ``name`` ("items", "enh", "sh1" or "sh2") of a packed
    buffer, viewed with its dtype and shape."""
    B, S = layout.B, layout.S
    dtype, shape = {"items": (torch.int32, (B, 4)),
                    "enh": (torch.float32, (B, 8)),
                    "sh1": (torch.int32, (B, S)),
                    "sh2": (torch.int32, (B, S))}[name]
    start = getattr(layout, name)
    n = 4 * shape[0] * shape[1]
    return buf[start:start + n].view(dtype).view(shape)


def chain_pack(out: torch.Tensor, layout: PackLayout, y0, x0, flips, prm,
               quad, a, s, d4, lim1: int, lim2: int) -> None:
    """Write a 'cuda_full' call's rows into the uint8 host buffer ``out``
    (``layout.nbytes`` bytes or more) at ``layout``'s offsets: the item
    rows of y0, x0 [B] int32, the D4 code ``d4`` [16] gives quarter turn
    ``quad`` and user flip ``flips`` [B] int32, and 0; the enhance rows
    ``prm`` [B, 8] float32; and ``geometry.shear_params``' sh1, sh2 [B, S]
    from ``shear_factors``' quad, a and s = sin(phi) [B] (CPU tensors; the
    pack negates s into ``geometry.shear_factors``' b), clipped to
    ``lim1`` and ``lim2`` (``geometry.shift_limits``).  The rows are
    taken as they are, contiguous numpy arrays of these dtypes (the
    draws'), ``d4`` int32 [16]: any other form raises ValueError.  The
    library must be available."""
    B, S = layout.B, layout.S
    arrays = ((y0, np.int32, (B,)), (x0, np.int32, (B,)),
              (flips, np.int32, (B,)), (prm, np.float32, (B, 8)),
              (d4, np.int32, (16,)))
    factors = ((quad, torch.int32), (a, torch.float32), (s, torch.float32))
    if not (all(isinstance(v, np.ndarray) and v.dtype == dtype
                and v.shape == shape and v.flags.c_contiguous
                for v, dtype, shape in arrays)
            and all(t.dtype == dtype and t.shape == (B,) and t.is_cpu
                    and t.is_contiguous() for t, dtype in factors)):
        raise ValueError(f"chain_pack needs contiguous int32 [{B}] rows, "
                         f"float32 [{B}, 8] enhance rows, 16 int32 D4 "
                         f"codes and [{B}] factors on the host")
    if (out.dtype != torch.uint8 or not out.is_cpu
            or not out.is_contiguous() or out.numel() < layout.nbytes):
        raise ValueError(f"chain_pack needs a contiguous uint8 host buffer "
                         f"of {layout.nbytes} bytes")
    base = out.data_ptr()
    _load().ipp_chain_pack(
        B, S, y0.ctypes.data, x0.ctypes.data, flips.ctypes.data,
        prm.ctypes.data, quad.data_ptr(), a.data_ptr(), s.data_ptr(),
        d4.ctypes.data, lim1, lim2, base + layout.items, base + layout.enh,
        base + layout.sh1, base + layout.sh2)
