"""The batched shear rotation's kernel wrappers (port of
image_processor_pipeline_tpu/ops/pallas/rotate.py:71-230).

``shear_rotate`` rotates square uint8 images ``[B, S, S, C]``, any C >= 1,
by an exact quarter turn and the Paeth three shears, given the shift
vectors; ``shear_rotate_crop`` does the same to an S x S crop of uint8
canvases ``[B, H, W, 3|4]`` (RGB out), the chain mode ``cuda_shear``'s
crop and rotation.  On a CPU tensor each runs its plain twin
(``geometry.rotate_square_shear_by``, after ``augment._crop`` for a crop);
on a CUDA tensor it launches the hand-written kernel in
``csrc/shear_rotate.cu`` or raises.  That kernel replaces the TPU kernels
``_shear_kernel_packed`` (C in {3, 4}) and ``_shear_kernel`` (any other
C), folds the quarter turn into its gather and reads a crop straight from
the canvas.  The TPU launchers' ``images_per_step`` and ``interpret`` are
grid and test knobs of the TPU and have no counterpart here.
"""

from __future__ import annotations

import torch

from image_processor_pipeline_tpu_torch import kernels
from image_processor_pipeline_tpu_torch.ops import geometry
from image_processor_pipeline_tpu_torch.ops.augment import _check, _crop

PATHS = ("tiled", "direct")


def _check_shifts(B, S, dev, quad, sh1, sh2):
    for name, t, shape in (("quad", quad, (B,)), ("sh1", sh1, (B, S)),
                           ("sh2", sh2, (B, S))):
        _check(name, t, torch.int32, shape, dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_card(dev, name):
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")


def shear_rotate(images, quad, sh1, sh2):
    """Rotate ``images`` [B, S, S, C] uint8 (contiguous) by the quarter
    turns ``quad`` [B] int32 and the shears ``sh1``/``sh2`` [B, S] int32,
    as made by ``geometry.shear_params``.  Returns [B, S, S, C] uint8.
    CPU tensors run the plain twin; CUDA tensors launch the kernel (no
    fallback); other devices raise."""
    if not isinstance(images, torch.Tensor) or images.dtype != torch.uint8 \
            or images.ndim != 4 or images.shape[1] != images.shape[2] \
            or images.shape[3] < 1:
        raise ValueError("images must be a uint8 [B, S, S, C] tensor")
    if not images.is_contiguous():
        raise ValueError("images must be contiguous")
    B, S = images.shape[:2]
    dev = images.device
    _check_shifts(B, S, dev, quad, sh1, sh2)
    if dev.type == "cpu":
        return geometry.rotate_square_shear_by(images, quad, sh1, sh2)
    _on_card(dev, "shear_rotate")
    return launch_shear(images, quad, sh1, sh2)


def shear_rotate_crop(canvas, y0, x0, quad, sh1, sh2, crop: int):
    """Rotate the [crop, crop] window at (``y0``, ``x0``) [B] int32 of each
    uint8 canvas [B, H, W, 3|4] (contiguous; lax.dynamic_slice's offset
    rule) as ``shear_rotate`` does, ``sh1``/``sh2`` being [B, crop].
    Returns the RGB result [B, crop, crop, 3] uint8.  CPU tensors run
    ``_crop`` then the plain twin; CUDA tensors launch the kernel, which
    reads the window from the canvas (no fallback); other devices raise."""
    if not isinstance(canvas, torch.Tensor) or canvas.dtype != torch.uint8 \
            or canvas.ndim != 4 or canvas.shape[3] not in (3, 4):
        raise ValueError("canvas must be a uint8 [B, H, W, 3|4] tensor")
    if not canvas.is_contiguous():
        raise ValueError("canvas must be contiguous")
    B, H, W = canvas.shape[:3]
    if not 1 <= crop <= min(H, W):
        raise ValueError(f"crop {crop} must lie in [1, {min(H, W)}]")
    dev = canvas.device
    _check("y0", y0, torch.int32, (B,), dev)
    _check("x0", x0, torch.int32, (B,), dev)
    _check_shifts(B, crop, dev, quad, sh1, sh2)
    if dev.type == "cpu":
        return geometry.rotate_square_shear_by(
            _crop(canvas[..., :3], y0, x0, crop), quad, sh1, sh2)
    _on_card(dev, "shear_rotate_crop")
    return launch_shear(canvas, quad, sh1, sh2, offsets=(y0, x0),
                        channels=3)


def launch_shear(src, quad, sh1, sh2, offsets=None, channels=None,
                 path: str = "tiled"):
    """Launch csrc/shear_rotate.cu's ipp_shear_rotate on ``src``' card.

    src: uint8 [B, H, W, Cin], contiguous; quad [B], sh1, sh2 [B, S] int32
    as the caller has them (the kernel applies ``applied_shifts``);
    offsets: (y0, x0) [B] int32 of an S x S crop, or None for the whole
    image (H = W = S); channels: the output's, Cin or 3 from 4.  ``path``
    "direct" sends every tile to the direct gather ("tiled", the default,
    stages each tile's source window).  Counts the launch and returns [B,
    S, S, channels] uint8; raises for a shape the kernel does not take (an
    S beyond its shared memory, some 39,000)."""
    B, H, W, Cin = src.shape
    S = sh1.shape[1]
    C = Cin if channels is None else channels
    if path not in PATHS:
        raise ValueError(f"unknown shear path {path!r}; choose from {PATHS}")
    dev = src.device
    counter = kernels.direct_tiles
    if counter is not None and (counter.device != dev
                                or counter.dtype != torch.int32):
        raise ValueError("kernels.direct_tiles must be int32 on the "
                         "kernel's card")
    y0, x0 = (None, None) if offsets is None else \
        (t.contiguous() for t in offsets)
    quad, sh1, sh2 = (t.contiguous() for t in (quad, sh1, sh2))
    out = torch.empty((B, S, S, C), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = kernels.library().ipp_shear_rotate(
            src.data_ptr(), out.data_ptr(), _ptr(y0), _ptr(x0),
            quad.data_ptr(), sh1.data_ptr(), sh2.data_ptr(), _ptr(counter),
            B, H, W, Cin, S, C, int(path == "direct"), stream)
    kernels.check(code)
    kernels.launch_counts[
        "shear_rotate_packed" if C in (3, 4) else "shear_rotate"] += 1
    return out


def rotate_square_shear_batch(images, angles, shifts=None):
    """Rotate square images [B, S, S, C] uint8 CCW about their centres by
    ``angles`` [B] degrees on a fixed canvas: the contract of
    ``vmap(geometry.rotate_square_shear)``.  ``shifts``: (quad, sh1, sh2)
    to use instead of ``geometry.shear_params(angles, S)``."""
    if shifts is None:
        angles = torch.as_tensor(angles, device=images.device)
        shifts = geometry.shear_params(angles, images.shape[1])
    return shear_rotate(images, *shifts)
