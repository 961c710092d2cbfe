"""Plain Paeth three-shear rotation on a square canvas, written for the
benchmark's reference from its definition: an exact quarter turn, then
three row or column shifts, each an index gather that leaves the
vacated pixels 0.

``shear_params`` computes the shift vectors in ``dtype`` (float32 is the
precision the system states; the control computes them in bfloat16).
"""

from __future__ import annotations

import numpy as np
import torch

# float32 constants of the rotation (degrees to radians, 2 pi, pi/4, pi/2)
_DEG2RAD = float(np.float32(np.pi / 180))
_TWO_PI = float(np.float32(2 * np.pi))
_PI_4 = float(np.float32(np.pi / 4))
_PI_2 = float(np.float32(np.pi / 2))


def _bits(need: int) -> int:
    bits = 1
    while (1 << (bits - 1)) < need:
        bits += 1
    return max(bits, 4)


def shift_limits(size: int):
    """The largest shift magnitudes applied on a canvas of ``size``: the
    first and third shears cover 0.208 * size, the second 0.354 * size."""
    o13 = 1 << (_bits(int(0.20711 * size) + 2) - 1)
    o2 = 1 << (_bits(int(0.35356 * size) + 2) - 1)
    return o13 - 1, o2 - 1


def shear_params(angles, size: int, dtype=torch.float32):
    """(quad [n] int64, sh1 [n, size] int64, sh2 [n, size] int64) for
    rotations by ``angles`` [n] degrees counter-clockwise, computed on
    the host in ``dtype``: the angle reduced to [0, 2 pi), the quarter
    turn nearest to it, and the shears tan(phi/2) and -sin(phi) of the
    rest, times each row's distance from the centre, rounded."""
    theta = torch.as_tensor(np.asarray(angles, np.float32)).to(dtype) \
        * _DEG2RAD
    theta = torch.fmod(theta, _TWO_PI)
    theta = torch.where(theta < 0, theta + _TWO_PI, theta)
    quad = torch.remainder(torch.floor(
        (theta + _PI_4) / torch.full_like(theta, _PI_2)).to(torch.int64), 4)
    phi = theta - quad.to(dtype) * _PI_2
    a = torch.tan(phi / 2)
    b = -torch.sin(phi)
    rows = torch.arange(size, dtype=dtype) - (size - 1.0) / 2.0
    sh1 = torch.round(a[:, None] * rows[None, :]).to(torch.int64)
    sh2 = torch.round(b[:, None] * rows[None, :]).to(torch.int64)
    l13, l2 = shift_limits(size)
    return quad, sh1.clamp(-l13, l13), sh2.clamp(-l2, l2)


def _shift_rows(img, t):
    """out[b, y, x] = img[b, y, x - t[b, y]] where that lies in the row."""
    B, H, W, C = img.shape
    x = torch.arange(W, device=img.device)
    src = x[None, None, :] - t[:, :, None]
    ok = (src >= 0) & (src < W)
    idx = src.clamp(0, W - 1)[..., None].expand(B, H, W, C)
    out = torch.gather(img, 2, idx)
    return torch.where(ok[..., None], out, torch.zeros_like(out))


def _shift_cols(img, t):
    """out[b, y, x] = img[b, y - t[b, x], x] where that lies in the column."""
    B, H, W, C = img.shape
    y = torch.arange(H, device=img.device)
    src = y[None, :, None] - t[:, None, :]
    ok = (src >= 0) & (src < H)
    idx = src.clamp(0, H - 1)[..., None].expand(B, H, W, C)
    out = torch.gather(img, 1, idx)
    return torch.where(ok[..., None], out, torch.zeros_like(out))


def rotate(img, quad, sh1, sh2):
    """Rotate square images [B, S, S, C] by the quarter turns ``quad`` [B]
    (q = 1: transpose then flip rows; 2: flip both; 3: transpose then flip
    columns) and then by the shears sh1 (rows), sh2 (columns), sh1 (rows)."""
    dev = img.device
    q = quad.to(dev).reshape(-1, 1, 1, 1)
    img = torch.where((q == 1) | (q == 3), img.transpose(1, 2), img)
    img = torch.where((q == 1) | (q == 2), img.flip(1), img)
    img = torch.where((q == 2) | (q == 3), img.flip(2), img)
    sh1, sh2 = sh1.to(dev), sh2.to(dev)
    img = _shift_rows(img, sh1)
    img = _shift_cols(img, sh2)
    return _shift_rows(img, sh1)
