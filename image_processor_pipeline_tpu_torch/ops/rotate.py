"""The batched shear rotation's kernel wrapper (port of
image_processor_pipeline_tpu/ops/pallas/rotate.py:71-230).

``shear_rotate`` rotates square uint8 images ``[B, S, S, C]``, any C >= 1,
by an exact quarter turn and the Paeth three shears, given the shift
vectors.  On a CPU tensor it runs the plain twin
``geometry.rotate_square_shear_by``; on a CUDA tensor it launches the
hand-written kernel in ``csrc/shear_rotate.cu`` or raises.  That kernel
replaces the TPU kernels ``_shear_kernel_packed`` (C in {3, 4}) and
``_shear_kernel`` (any other C), and folds the quarter turn into its
gather.  The TPU launchers' ``images_per_step`` and ``interpret`` are grid
and test knobs of the TPU and have no counterpart here.
"""

from __future__ import annotations

import torch

from image_processor_pipeline_tpu_torch import kernels
from image_processor_pipeline_tpu_torch.ops import geometry
from image_processor_pipeline_tpu_torch.ops.augment import _check, d4_codes


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
    B, S, _, C = images.shape
    dev = images.device
    for name, t, shape in (("quad", quad, (B,)), ("sh1", sh1, (B, S)),
                           ("sh2", sh2, (B, S))):
        _check(name, t, torch.int32, shape, dev)
    if dev.type == "cpu":
        return geometry.rotate_square_shear_by(images, quad, sh1, sh2)
    if dev.type != "cuda":
        raise ValueError(f"shear_rotate runs on cpu or cuda, not {dev}")
    quad, sh1, sh2 = (t.contiguous() for t in
                      geometry.applied_shifts(quad, sh1, sh2, S))
    return launch_shear(images, d4_codes(dev)[quad * 4], sh1, sh2)


def launch_shear(images, codes, sh1, sh2):
    """Launch csrc/shear_rotate.cu's ipp_shear_rotate on ``images``' card:
    codes [B] int32, the D4 code of each quarter turn; sh1, sh2 [B, S]
    int32 as applied (geometry.applied_shifts), all contiguous.  Counts the
    launch and returns the rotated [B, S, S, C] uint8."""
    B, S, _, C = images.shape
    dev = images.device
    out = torch.empty_like(images)
    lib = kernels.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.ipp_shear_rotate(
            images.data_ptr(), out.data_ptr(), codes.data_ptr(),
            sh1.data_ptr(), sh2.data_ptr(), B, S, C, stream)
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
