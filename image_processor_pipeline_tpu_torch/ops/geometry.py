"""Geometric ops of the flagship chain (twin of
image_processor_pipeline_tpu/ops/geometry.py:32-43, 615-744).

Images are batched ``[B, H, W, C]`` tensors and per-item parameters are
``[B]`` or ``[B, N]`` tensors on the same device: the batch axis written out
where the JAX package vmaps a per-image function.
"""

from __future__ import annotations

import numpy as np
import torch

# float32 constants exactly as jnp rounds its weakly typed python floats
_DEG2RAD = float(np.float32(np.pi / 180))
_TWO_PI = float(np.float32(2 * np.pi))
_PI_4 = float(np.float32(np.pi / 4))
_PI_2 = float(np.float32(np.pi / 2))


def valid_mask(h, w, H: int, W: int, device=None):
    """Boolean [H, W] mask of the valid region [0:h, 0:w]."""
    iy = torch.arange(H, dtype=torch.int32, device=device)[:, None]
    ix = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    return (iy < h) & (ix < w)


def shift_bits_for(size: int) -> int:
    """Bit passes so the shear-shift offset covers ±0.354*size (the
    worst-case Paeth shift at ±45°)."""
    need = int(0.35356 * size) + 2
    bits = 1
    while (1 << (bits - 1)) < need:
        bits += 1
    return max(bits, 4)


def shear13_bits_for(size: int) -> int:
    """Bit passes for the first and third Paeth shears, whose shift
    |rint(tan(φ/2)·y)| <= 0.208·size."""
    need = int(0.20711 * size) + 2
    bits = 1
    while (1 << (bits - 1)) < need:
        bits += 1
    return max(bits, 4)


def shear_params(angles, H: int):
    """(quad [B] int32, sh1 [B, H] int32, sh2 [B, H] int32) for the Paeth
    3-shear rotation of an H×H canvas by ``angles`` [B] degrees.

    The float32 operations are the JAX function's, in its order.  ``tan``
    and ``sin`` come from the device's own library, so a shift can differ by
    one from XLA's where the product lands next to a .5 boundary (a few in
    10^5 angles at H=512 on the CPU); callers that must agree with another
    backend pass the same vectors to both.
    """
    theta = torch.as_tensor(angles).to(torch.float32) * _DEG2RAD
    # jnp.mod: the exact remainder, moved into [0, 2π)
    theta = torch.fmod(theta, _TWO_PI)
    theta = torch.where(theta < 0, theta + _TWO_PI, theta)
    # a tensor divisor: CUDA turns division by a python scalar into a
    # multiply by its reciprocal, which is not the IEEE quotient
    quad = torch.remainder(torch.floor(
        (theta + _PI_4) / torch.full_like(theta, _PI_2)).to(torch.int32), 4)
    phi = theta - quad.to(torch.float32) * _PI_2
    a = torch.tan(phi / 2)
    b = -torch.sin(phi)
    c = (float(H) - 1.0) / 2.0   # exact in float32
    iy = torch.arange(H, dtype=torch.float32, device=theta.device) - c
    sh1 = torch.round(a[:, None] * iy[None, :]).to(torch.int32)
    sh2 = torch.round(b[:, None] * iy[None, :]).to(torch.int32)
    return (quad, *_clip_shifts(sh1, sh2, H))


def _clip_shifts(sh1, sh2, H: int):
    """sh1 and sh2 clipped to the ranges ``_row_shift`` applies on an H×H
    canvas (``shear13_bits_for`` and ``shift_bits_for`` bits)."""
    o13 = 1 << (shear13_bits_for(H) - 1)
    o2 = 1 << (shift_bits_for(H) - 1)
    return sh1.clamp(-(o13 - 1), o13 - 1), sh2.clamp(-(o2 - 1), o2 - 1)


def applied_shifts(quad, sh1, sh2, H: int):
    """The (quad, sh1, sh2) that ``rotate_square_shear_by`` applies on an
    H×H canvas: a quad outside [0, 4) turns nothing, and each shift is
    clipped as ``_row_shift`` clips it.  A kernel given these applies the
    plain version's permutation for any vectors; ``shear_params``' own
    vectors come back unchanged."""
    quad = torch.where((quad >= 0) & (quad < 4), quad, 0)
    return (quad, *_clip_shifts(sh1, sh2, H))


def _row_shift(img, shifts, axis: int = 1, bits: int = 9):
    """Shift each row (axis=1) or column (axis=0) of every image by a
    per-index amount, zero-filling vacated pixels: out[p] = in[p - t] where
    0 <= p - t < size, else 0.

    img: [B, H, W, C]; shifts: [B, H] for axis=1, [B, W] for axis=0.  The
    JAX package's bit-decomposed roll+select form, kept so the twin applies
    the very same permutation.
    """
    dim = axis + 1
    size = img.shape[dim]
    offset = 1 << (bits - 1)
    t = shifts.clamp(-(offset - 1), offset - 1)
    u = t + offset
    sel = t[:, :, None, None] if axis == 1 else t[:, None, :, None]
    usel = u[:, :, None, None] if axis == 1 else u[:, None, :, None]
    out = img
    for k in range(bits):
        rolled = torch.roll(out, 1 << k, dims=dim)
        out = torch.where(((usel >> k) & 1).bool(), rolled, out)
    out = torch.roll(out, -offset, dims=dim)
    pos = torch.arange(size, device=img.device)
    pos = pos[None, None, :, None] if axis == 1 else pos[None, :, None, None]
    valid = (pos >= sel) & (pos < size + sel)
    return torch.where(valid, out, torch.zeros((), dtype=img.dtype,
                                               device=img.device))


def rotate_square_shear_by(img, quad, sh1, sh2):
    """Rotate square images by the exact quarter turns ``quad`` [B] and the
    Paeth shears ``sh1``/``sh2`` [B, S] (as made by ``shear_params``).

    The quarter turn is the 3-pass form of geometry.py:695-700
    (q1 = flip0∘T, q2 = flip0∘flip1, q3 = flip1∘T)."""
    B, H, W, _ = img.shape
    if H != W:
        raise ValueError("rotate_square_shear requires a square canvas")
    q = quad.reshape(B, 1, 1, 1)
    img = torch.where((q == 1) | (q == 3), img.transpose(1, 2), img)
    img = torch.where((q == 1) | (q == 2), img.flip(1), img)
    img = torch.where((q == 2) | (q == 3), img.flip(2), img)
    img = _row_shift(img, sh1, axis=1, bits=shear13_bits_for(H))
    img = _row_shift(img, sh2, axis=0, bits=shift_bits_for(H))
    return _row_shift(img, sh1, axis=1, bits=shear13_bits_for(H))


def rotate_square_shear(img, angles):
    """Rotate square, fully valid images [B, S, S, C] CCW about their
    centres by ``angles`` [B] degrees on a fixed canvas (Paeth three-shear
    rotation; pixels leaving the frame are cut, uncovered ones are 0)."""
    return rotate_square_shear_by(img, *shear_params(angles, img.shape[1]))
