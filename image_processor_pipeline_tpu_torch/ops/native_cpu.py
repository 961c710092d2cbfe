"""ctypes bindings for the port's native CPU compute backend
(native/ipp_cpu.cpp): bit-exact C++ twins of the transforms' batch
computations, run on host threads when a step sets
``options["native_compute"]=True`` (``BatchTransform.native_fn``).

The library is built at first use with ``g++`` straight from the source
into ``_build/libipp_cpu.so`` by utils/native_build.py (an flock, a temp
file renamed into place, a rebuild when the source is newer); it links
``-lpthread`` only, so it builds wherever a C++17 compiler is.
``-ffp-contract=off`` keeps every float32 operation rounded on its own, as
the twins' exactness needs (never ``-ffast-math``).  Where the build or
the load fails, ``available()`` is false, ``build_error()`` says why in
the compiler's words, and every function here returns None.

The C++ kernels replicate the same fixed-point formulations as the port's
torch ops (ops/color.py, ops/photometric.py, ops/ccl.py, ops/geometry.py);
tests/test_torch_native_cpu.py holds them byte for byte against the torch
path and the JAX package's own library.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from image_processor_pipeline_tpu_torch.utils import native_build

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "ipp_cpu.cpp"
BUILD = _PKG / "_build"
_SO = BUILD / "libipp_cpu.so"

# -march=native is safe: _build/ is git-ignored and the library is built
# on the host that loads it
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-ffp-contract=off", "-shared")
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
    """Why the library is unavailable (the compiler's or the loader's
    message), or None when it is built and loaded."""
    _load()
    return _error


def _bind_symbols(lib) -> None:
    """Declare argtypes/restypes for the seven exports.  Raises
    AttributeError when the loaded library lacks one."""
    c_int = ctypes.c_int
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    sigs = {
        "ipp_cpu_colormask_batch": [
            u8p, c_int, c_int, c_int, i32p, i32p, i32p, c_int, u8p, c_int],
        "ipp_cpu_enhance_batch": [
            u8p, c_int, c_int, c_int, i32p, f32p, u8p, u8p, c_int],
        "ipp_cpu_flips_batch": [
            u8p, c_int, c_int, c_int, c_int, i32p, i32p, c_int, u8p, c_int],
        "ipp_cpu_chain_batch": [
            u8p, c_int, c_int, c_int, i32p,  # imgs, sizes
            i32p, c_int,                     # ops
            i32p, i32p, i32p,                # rot params
            i32p,                            # flip codes
            i32p, i32p, i32p, i32p,          # mask params
            f32p, u8p,                       # enhance
            f32p,                            # border margins
            i32p,                            # ccl params
            u8p, i32p, c_int],               # outs
        "ipp_cpu_ccl_batch": [
            u8p, c_int, c_int, c_int, i32p, c_int, c_int, u8p, i32p, c_int],
        "ipp_cpu_rotations_batch": [
            u8p, c_int, c_int, c_int, i32p, f64p, i32p, c_int, u8p, i32p,
            c_int],
        "ipp_cpu_overlay_batch": [
            u8p, c_int, c_int, c_int, i32p, u8p, c_int, c_int, i32p, i32p,
            u8p, c_int],
    }
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _u8(a):
    return np.ascontiguousarray(a, np.uint8)


def _i32(a):
    return np.ascontiguousarray(a, np.int32)


def colormask_batch(imgs: np.ndarray, sizes: np.ndarray,
                    bounds: np.ndarray, zones: np.ndarray,
                    n_threads: int = 1) -> Optional[np.ndarray]:
    """Batched HSV color-mask alpha: cv2-exact twin of
    ops/color.py:color_mask_alpha.

    imgs: [N, H, W, 3] uint8 canvases; sizes: [N, 2] int32 valid (h, w);
    bounds: [F, 6] int32 (lo HSV, hi HSV), already saturate-rounded the
    way cv2.inRange casts its bound scalars; zones: [F, 4] int32 margins.
    Returns [N, H, W] uint8 alpha (zero outside each valid region), or
    None when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs, sizes = _u8(imgs), _i32(sizes)
    n, H, W = imgs.shape[:3]
    bounds = _i32(bounds).reshape(-1, 6)
    zones = _i32(zones).reshape(-1, 4)
    alphas = np.zeros((n, H, W), np.uint8)
    lib.ipp_cpu_colormask_batch(
        _ptr(imgs, ctypes.c_uint8), n, H, W, _ptr(sizes, ctypes.c_int32),
        _ptr(bounds, ctypes.c_int32), _ptr(zones, ctypes.c_int32),
        bounds.shape[0], _ptr(alphas, ctypes.c_uint8), max(1, n_threads))
    return alphas


def enhance_batch(imgs: np.ndarray, sizes: np.ndarray,
                  factors: np.ndarray, flags: np.ndarray,
                  n_threads: int = 1) -> Optional[np.ndarray]:
    """Batched PIL-exact enhance chain: twin of ops/photometric.py:enhance.

    imgs: [N, H, W, 3] uint8 canvases; sizes: [N, 2] int32 valid (h, w);
    factors: [N, 7] float32 (brightness, contrast, color, blur sigma,
    gain RGB); flags: [N, 2] uint8 (apply_blur, apply_rgb).  Returns
    [N, H, W, 3] uint8 (zero outside each valid region), or None when the
    library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs, sizes = _u8(imgs), _i32(sizes)
    n, H, W = imgs.shape[:3]
    factors = np.ascontiguousarray(factors, np.float32)
    flags = _u8(flags)
    outs = np.zeros_like(imgs)
    lib.ipp_cpu_enhance_batch(
        _ptr(imgs, ctypes.c_uint8), n, H, W, _ptr(sizes, ctypes.c_int32),
        _ptr(factors, ctypes.c_float), _ptr(flags, ctypes.c_uint8),
        _ptr(outs, ctypes.c_uint8), max(1, n_threads))
    return outs


def flips_batch(imgs: np.ndarray, sizes: np.ndarray, codes: np.ndarray,
                n_threads: int = 1) -> Optional[np.ndarray]:
    """Batched dihedral flips: exact twin of ops/geometry.py flip_h/v/hv
    on padded canvases (a flip is a pure permutation of the valid region).

    imgs: [N, H, W, C] uint8 (C = 3 or 4); sizes: [N, 2] int32 (h, w);
    codes: [K] int32 flips (1='h', 2='v', 3='hv').  Returns
    [K, N, H, W, C] uint8, or None when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs, sizes, codes = _u8(imgs), _i32(sizes), _i32(codes)
    n, H, W, C = imgs.shape
    outs = np.zeros((len(codes),) + imgs.shape, np.uint8)
    lib.ipp_cpu_flips_batch(
        _ptr(imgs, ctypes.c_uint8), n, H, W, C, _ptr(sizes, ctypes.c_int32),
        _ptr(codes, ctypes.c_int32), len(codes), _ptr(outs, ctypes.c_uint8),
        max(1, n_threads))
    return outs


def ccl_batch(imgs: np.ndarray, sizes: np.ndarray, min_size: int,
              keep_large: bool, n_threads: int = 1):
    """Batched component cleanup + alpha tight crop: exact twin of
    ops/ccl.py:cleanup_and_fit (the same C++ pass the fused-chain executor
    runs).

    imgs: [N, H, W, 4] uint8 RGBA canvases; sizes: [N, 2] int32 (h, w).
    Returns (outs [N, H, W, 4] uint8, out_sizes [N, 2] int32), or None
    when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs, sizes = _u8(imgs), _i32(sizes)
    n, H, W, C = imgs.shape
    if C != 4:
        raise ValueError("cleanup requires RGBA canvases")
    outs = np.zeros_like(imgs)
    out_sizes = np.zeros((n, 2), np.int32)
    lib.ipp_cpu_ccl_batch(
        _ptr(imgs, ctypes.c_uint8), n, H, W, _ptr(sizes, ctypes.c_int32),
        int(min_size), int(bool(keep_large)), _ptr(outs, ctypes.c_uint8),
        _ptr(out_sizes, ctypes.c_int32), max(1, n_threads))
    return outs, out_sizes


def overlay_batch(ovs: np.ndarray, ov_sizes: np.ndarray, bgs: np.ndarray,
                  bg_sizes: np.ndarray, geo: np.ndarray,
                  n_threads: int = 1) -> Optional[np.ndarray]:
    """Batched overlay compositing: Pillow's premultiplied fixed-point
    LANCZOS resample + Paste.c blend, byte-identical to the reference's
    Pillow composite and to transforms/overlays.py:paste_overlays.

    ovs: [N, Ho, Wo, 4] uint8 RGBA overlay canvases; bgs: [N, Hb, Wb, 3]
    uint8 RGB background canvases; *_sizes: [N, 2] int32 valid (h, w);
    geo: [N, 5] int32 (new_h, new_w, py, px, ok) from
    transforms/overlays.py:draw_geometry.  Returns [N, Hb, Wb, 3] uint8
    composites, or None when the library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    ovs, bgs = _u8(ovs), _u8(bgs)
    ov_sizes, bg_sizes, geo = _i32(ov_sizes), _i32(bg_sizes), _i32(geo)
    n, Ho, Wo = ovs.shape[:3]
    Hb, Wb = bgs.shape[1:3]
    outs = np.zeros_like(bgs)
    lib.ipp_cpu_overlay_batch(
        _ptr(ovs, ctypes.c_uint8), n, Ho, Wo, _ptr(ov_sizes, ctypes.c_int32),
        _ptr(bgs, ctypes.c_uint8), Hb, Wb, _ptr(bg_sizes, ctypes.c_int32),
        _ptr(geo, ctypes.c_int32), _ptr(outs, ctypes.c_uint8),
        max(1, n_threads))
    return outs


def rotations_batch(imgs: np.ndarray, sizes: np.ndarray, mats: np.ndarray,
                    osizes: np.ndarray, n_rot: int, n_threads: int = 1):
    """Batched Pillow-exact nearest rotate-expand fan-out
    (Image.rotate(angle, expand=True, resample=NEAREST) + getbbox crop,
    reference rotations.py:96-109): Pillow's 16.16 fixed-point affine walk.

    imgs: [N, H, W, 4] uint8 RGBA canvases; sizes: [N, 2] int32 (h, w);
    mats: [N * n_rot, 6] float64 Pillow matrices
    (ops/geometry.py:_pil_rotate_matrix); osizes: [N * n_rot, 2] int32
    expanded (nh, nw), each within (H, W).  Returns (outs [N, n_rot, H, W,
    4], out_sizes [N, n_rot, 2] tight-crop extents), or None when the
    library is unavailable or an expanded box exceeds the canvas.
    """
    lib = _load()
    if lib is None:
        return None
    imgs, sizes = _u8(imgs), _i32(sizes)
    n, H, W = imgs.shape[:3]
    mats = np.ascontiguousarray(mats, np.float64).reshape(-1, 6)
    osizes = _i32(osizes).reshape(-1, 2)
    if (osizes[:, 0] > H).any() or (osizes[:, 1] > W).any():
        return None
    outs = np.zeros((n, n_rot, H, W, 4), np.uint8)
    out_sizes = np.zeros((n * n_rot, 2), np.int32)
    lib.ipp_cpu_rotations_batch(
        _ptr(imgs, ctypes.c_uint8), n, H, W, _ptr(sizes, ctypes.c_int32),
        _ptr(mats, ctypes.c_double), _ptr(osizes, ctypes.c_int32), n_rot,
        _ptr(outs, ctypes.c_uint8), _ptr(out_sizes, ctypes.c_int32),
        max(1, n_threads))
    return outs, out_sizes.reshape(n, n_rot, 2)


def chain_batch(imgs: np.ndarray, sizes: np.ndarray, ops: np.ndarray,
                rot_quad: np.ndarray, rot_sh1: np.ndarray,
                rot_sh2: np.ndarray, flip_code: np.ndarray,
                mask_F: np.ndarray, mask_bounds: np.ndarray,
                mask_zones: np.ndarray, mask_replace: np.ndarray,
                enh_factors: np.ndarray, enh_flags: np.ndarray,
                bc_margins: np.ndarray, ccl_params: np.ndarray,
                n_threads: int = 1):
    """Batched fused-chain executor: bit-exact twin of FusedChain's device
    computation (native/ipp_cpu.cpp:chain_one for the op semantics).

    imgs: [N, H, W, 4] uint8 RGBA canvases; sizes: [N, 2] int32 (h, w);
    ops: [n_ops] int32 opcodes; the per-op draw arrays are item-major
    ([N, slot, ...]), the mask and border parameters static.  Returns
    (outs [N, H, W, 4], out_sizes [N, 2]) or None when the library is
    unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    imgs, sizes = _u8(imgs), _i32(sizes)
    n, H, W = imgs.shape[:3]
    i32 = [_i32(a) for a in (ops, rot_quad, rot_sh1, rot_sh2, flip_code,
                             mask_F, mask_bounds, mask_zones, mask_replace)]
    ops, rot_quad, rot_sh1, rot_sh2, flip_code, mask_F, mask_bounds, \
        mask_zones, mask_replace = i32
    enh_factors = np.ascontiguousarray(enh_factors, np.float32)
    enh_flags = _u8(enh_flags)
    bc_margins = np.ascontiguousarray(bc_margins, np.float32)
    ccl_params = _i32(ccl_params)
    outs = np.zeros_like(imgs)
    out_sizes = np.zeros((n, 2), np.int32)
    p32 = [_ptr(a, ctypes.c_int32) for a in i32[1:]]
    lib.ipp_cpu_chain_batch(
        _ptr(imgs, ctypes.c_uint8), n, H, W, _ptr(sizes, ctypes.c_int32),
        _ptr(ops, ctypes.c_int32), len(ops), *p32,
        _ptr(enh_factors, ctypes.c_float), _ptr(enh_flags, ctypes.c_uint8),
        _ptr(bc_margins, ctypes.c_float), _ptr(ccl_params, ctypes.c_int32),
        _ptr(outs, ctypes.c_uint8), _ptr(out_sizes, ctypes.c_int32),
        max(1, n_threads))
    return outs, out_sizes
