"""Geometric ops on padded images (twin of
image_processor_pipeline_tpu/ops/geometry.py:32-580, 615-744).

Representation: a padded canvas ``[B, H, W, C]`` holding, per item, a valid
region ``[0:h, 0:w]``.  Invariant maintained by every op here: pixels
outside the valid region are 0.  Per-item parameters are ``[B]`` or
``[B, N]`` tensors on the images' device (python numbers broadcast): the
batch axis written out where the JAX package vmaps a per-image function.

``rotate_expand`` samples nearest or bilinear in float32, one angle an
item, as the JAX function does for traced angles (the engine's path);
``rotate_bilinear_exact`` is the PIL-exact bilinear rotation of one image
by an angle and a size the host knows.  The JAX package emulates float64
there in double-double arithmetic, the TPU having none; the CPU and the
H100 have float64, so this port computes Pillow's own double arithmetic
in Pillow's order, which gives Pillow's bits (and the double-double
form's on every test case).
"""

from __future__ import annotations

import functools
import math

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


def item_extent(v, device):
    """An extent ``h`` or ``w`` (a number, or a tensor of one value an item)
    as an int32 tensor that broadcasts against [..., H, W] planes."""
    t = torch.as_tensor(v, device=device).to(torch.int32)
    return t.reshape(t.shape + (1, 1))


def _per_item(v, B: int, device, dtype=torch.int32):
    """``v`` (a number or a [B] tensor) as a [B] tensor on ``device``."""
    return torch.as_tensor(v, device=device).to(dtype).expand(B)


def apply_mask(img, h, w):
    """Zero pixels outside each item's valid region [0:h, 0:w]."""
    B, H, W, _ = img.shape
    h = _per_item(h, B, img.device).view(B, 1, 1)
    w = _per_item(w, B, img.device).view(B, 1, 1)
    m = valid_mask(h, w, H, W, device=img.device)
    return torch.where(m[..., None], img,
                       torch.zeros((), dtype=img.dtype, device=img.device))


def _gather2(img, rows, cols):
    """out[b, y, x] = img[b, rows[b, y], cols[b, x]]; rows [B, H'] and cols
    [B, W'] hold indices into the canvas."""
    b = torch.arange(img.shape[0], device=img.device)[:, None, None]
    return img[b, rows[:, :, None].long(), cols[:, None, :].long()]


def roll2(img, dy, dx):
    """Circular shift of each item by its own (dy, dx) along (H, W):
    ``jnp.roll(img, (dy, dx), axis=(0, 1))`` vmapped over the batch."""
    B, H, W, _ = img.shape
    dy = _per_item(dy, B, img.device)
    dx = _per_item(dx, B, img.device)
    iy = torch.arange(H, dtype=torch.int32, device=img.device)
    ix = torch.arange(W, dtype=torch.int32, device=img.device)
    return _gather2(img, torch.remainder(iy[None, :] - dy[:, None], H),
                    torch.remainder(ix[None, :] - dx[:, None], W))


# ---------------------------------------------------------------------------
# dihedral flips (cv2.flip semantics: 1=horizontal/x, 0=vertical/y, -1=both)
# ---------------------------------------------------------------------------

def _flip(img, h, w, flip_y: bool, flip_x: bool):
    """Mirror each item's valid region in place: the JAX package's flip of
    the canvas followed by a roll back to the origin, as one gather."""
    B, H, W, _ = img.shape
    iy = torch.arange(H, dtype=torch.int32, device=img.device)[None, :]
    ix = torch.arange(W, dtype=torch.int32, device=img.device)[None, :]
    rows, cols = iy.expand(B, H), ix.expand(B, W)
    if flip_y:
        h = _per_item(h, B, img.device)
        rows = torch.remainder(h[:, None] - 1 - iy, H)
    if flip_x:
        w = _per_item(w, B, img.device)
        cols = torch.remainder(w[:, None] - 1 - ix, W)
    return _gather2(img, rows, cols)


def flip_h(img, h, w):
    """Horizontal mirror (flip around the vertical axis), size-preserving."""
    return _flip(img, h, w, False, True)


def flip_v(img, h, w):
    """Vertical mirror (flip around the horizontal axis), size-preserving."""
    return _flip(img, h, w, True, False)


def flip_hv(img, h, w):
    """180° rotation (both flips)."""
    return _flip(img, h, w, True, True)


def dihedral(img, h, w, sym: str):
    """Apply one of the reference's symmetry generators 'o'/'h'/'v'/'hv'
    (reference symmetry.py:114-119)."""
    if sym == "o":
        return img
    if sym == "h":
        return flip_h(img, h, w)
    if sym == "v":
        return flip_v(img, h, w)
    if sym == "hv":
        return flip_hv(img, h, w)
    raise ValueError(f"unknown symmetry {sym!r}")


# ---------------------------------------------------------------------------
# crops
# ---------------------------------------------------------------------------

def crop(img, y0, x0, ch, cw):
    """Move each item's window [y0:y0+ch, x0:x0+cw] to the canvas origin.

    The window must lie inside the valid region (callers guarantee this).
    A circular roll by the item's own offsets (no wraparound can reach the
    new valid region because y0+ch <= h <= H), then a mask.
    """
    B = img.shape[0]
    y0 = _per_item(y0, B, img.device)
    x0 = _per_item(x0, B, img.device)
    return apply_mask(roll2(img, -y0, -x0), ch, cw)


def content_bbox(img, h, w):
    """Tight bbox (y0, x0, bh, bw), each [B] int32, of each item's content.

    Parity: PIL Image.getbbox() (Pillow >= 10, ``alpha_only=True``): on a
    4-channel image only the alpha plane counts; on 1/3 channels any
    nonzero channel does.  (0, 0, 0, 0) for an all-zero (or fully
    transparent RGBA) item.
    """
    B, H, W, C = img.shape
    hv = _per_item(h, B, img.device).view(B, 1, 1)
    wv = _per_item(w, B, img.device).view(B, 1, 1)
    inside = valid_mask(hv, wv, H, W, device=img.device)
    if C == 4:
        nz = (img[..., 3] != 0) & inside
    else:
        nz = (img != 0).any(dim=-1) & inside
    rows = nz.any(dim=2)
    cols = nz.any(dim=1)
    iy = torch.arange(H, dtype=torch.int32, device=img.device)
    ix = torch.arange(W, dtype=torch.int32, device=img.device)
    big = 1 << 30
    y0 = torch.where(rows, iy, big).amin(dim=1)
    y1 = torch.where(rows, iy, -1).amax(dim=1)
    x0 = torch.where(cols, ix, big).amin(dim=1)
    x1 = torch.where(cols, ix, -1).amax(dim=1)
    any_nz = rows.any(dim=1)
    zero = torch.zeros((), dtype=torch.int32, device=img.device)
    y0 = torch.where(any_nz, y0, zero)
    x0 = torch.where(any_nz, x0, zero)
    bh = torch.where(any_nz, y1 - y0 + 1, zero)
    bw = torch.where(any_nz, x1 - x0 + 1, zero)
    return y0, x0, bh, bw


def fit_crop(img, h, w):
    """Tight-crop each item to its content bbox; returns (img, bh, bw).

    An EMPTY bbox (getbbox() None in PIL — e.g. a fully transparent RGBA
    image) keeps the item UNCROPPED at its extent (h, w), clamped at 0 for
    a degenerate (negative) extent handed down by an upstream stage: the
    reference never emits a 0x0 output.
    """
    B = img.shape[0]
    y0, x0, bh, bw = content_bbox(img, h, w)
    empty = bh == 0
    hj = _per_item(h, B, img.device).clamp(min=0)
    wj = _per_item(w, B, img.device).clamp(min=0)
    bh = torch.where(empty, hj, bh)
    bw = torch.where(empty, wj, bw)
    zero = torch.zeros((), dtype=torch.int32, device=img.device)
    y0 = torch.where(empty, zero, y0)
    x0 = torch.where(empty, zero, x0)
    return crop(img, y0, x0, bh, bw), bh, bw


def border_crop(img, h, w, top, bottom, left, right):
    """Crop margins (absolute pixel counts, [B] or numbers) off each side of
    every item (reference recadrages.py:13-61).  Returns (img, ch, cw)."""
    B = img.shape[0]
    h, w, top, bottom, left, right = (
        _per_item(v, B, img.device) for v in (h, w, top, bottom, left, right))
    ch = h - top - bottom
    cw = w - left - right
    return crop(img, top, left, ch, cw), ch, cw


# ---------------------------------------------------------------------------
# arbitrary-angle rotation with expand (PIL semantics)
# ---------------------------------------------------------------------------

def _expand_extents(h, w, angle_deg):
    """(cos, sin, hf, wf, ex, ey) of the PIL expand box, float32, in the
    JAX function's operation order."""
    theta = torch.as_tensor(angle_deg).to(torch.float32) * _DEG2RAD
    cos, sin = torch.cos(theta), torch.sin(theta)
    c, s = cos.abs(), sin.abs()
    hf = torch.as_tensor(h, device=theta.device).to(torch.float32)
    wf = torch.as_tensor(w, device=theta.device).to(torch.float32)
    ex = (wf * c + hf * s) / 2
    ey = (wf * s + hf * c) / 2
    return cos, sin, hf, wf, ex, ey


_EXPAND_EPS = 1e-4


def rotated_size(h, w, angle_deg):
    """Expanded canvas extents (h2, w2), int32, after rotating (h, w) by
    angle (degrees CCW); all three broadcast.

    Mirrors PIL's expand box (Image.rotate): transform the four corners
    around the center (w/2, h/2), then size = ceil(max) - floor(min) per
    axis.  A small epsilon snaps exact multiples of 90°.
    """
    _, _, hf, wf, ex, ey = _expand_extents(h, w, angle_deg)
    cx = wf / 2
    cy = hf / 2
    eps = _EXPAND_EPS
    w2 = (torch.ceil(cx + ex - eps) - torch.floor(cx - ex + eps)).to(torch.int32)
    h2 = (torch.ceil(cy + ey - eps) - torch.floor(cy - ey + eps)).to(torch.int32)
    return h2, w2


INTERPOLATIONS = ("nearest", "bilinear")


def _premultiply(img):
    """RGBA uint8 → premultiplied int32, as PIL converts RGBA to RGBa
    before a transform: c' = MULDIV255(c, a)."""
    ci = img[..., :3].to(torch.int32)
    ai = img[..., 3:].to(torch.int32)
    tmp = ci * ai + 128
    return torch.cat([((tmp >> 8) + tmp) >> 8, ai], dim=-1)


def _unpremultiply(out_i):
    """Premultiplied int32 → RGBA int32: floor(c'*255 / a), 0 where a=0."""
    a_out = out_i[..., 3:]
    rgb = torch.div(out_i[..., :3] * 255, a_out.clamp(min=1),
                    rounding_mode="floor").clamp(0, 255)
    rgb = torch.where(a_out > 0, rgb, 0)
    return torch.cat([rgb, a_out], dim=-1)


def _bilinear_taps(work, y0, x0, h, w):
    """The four taps [B, H, W, C] of ``work`` [B, H, W, C] at (y0, x0),
    (y0, x0+1), (y0+1, x0), (y0+1, x0+1) (int32 [B, H, W]), replicate-
    clamped at each item's valid extent h, w ([B, 1, 1])."""
    B, H, W, C = work.shape
    flat = work.reshape(B, H * W, C)

    def sample(yy, xx):
        yyc = torch.minimum(yy.clamp(min=0), h - 1)
        xxc = torch.minimum(xx.clamp(min=0), w - 1)
        index = (yyc * W + xxc).reshape(B, H * W, 1).long()
        return torch.gather(flat, 1, index.expand(B, H * W, C)).reshape(
            B, H, W, C)

    return (sample(y0, x0), sample(y0, x0 + 1), sample(y0 + 1, x0),
            sample(y0 + 1, x0 + 1))


def rotate_expand(img, h, w, angle_deg, interpolation: str = "nearest"):
    """Rotate each item CCW by its ``angle_deg`` with canvas expansion, fill
    transparent (PIL Image.rotate(angle, expand=True)), sampling nearest or
    bilinear in float32.

    img [B, H, W, C] uint8; h, w, angle_deg [B].  The rotated content lands
    at the canvas origin with new extents (h2, w2) [B] int32.  Outside
    pixels are 0.  Returns (out_img, h2, w2).

    'bilinear' follows PIL's transform(AFFINE, BILINEAR): the output→input
    affine with the angle negated, fill where the source point lies outside
    [0, w) × [0, h) before the half-pixel shift, taps replicate-clamped at
    the valid extent, RGBA through premultiplied alpha, the result
    truncated.  In float32 a pixel on a fill boundary can differ from
    Pillow by one; ``rotate_bilinear_exact`` is bit-exact.
    """
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"unknown interpolation {interpolation!r}; choose "
                         f"from {INTERPOLATIONS}")
    B, H, W, C = img.shape
    dev = img.device
    h = _per_item(h, B, dev)
    w = _per_item(w, B, dev)
    angle_deg = _per_item(angle_deg, B, dev, torch.float32)
    cos, sin, hf, wf, ex, ey = (
        t.view(B, 1, 1) for t in _expand_extents(h, w, angle_deg))
    h2, w2 = rotated_size(h, w, angle_deg)
    cy_in = hf / 2
    cx_in = wf / 2
    iy = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1)
    ix = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W)
    zero = torch.zeros((), dtype=img.dtype, device=dev)

    if interpolation == "nearest":
        # PIL places the output origin at floor(min corner coordinate), not
        # at a center-to-center alignment — keep the same subpixel offset.
        tx = torch.floor(cx_in - ex + _EXPAND_EPS)
        ty = torch.floor(cy_in - ey + _EXPAND_EPS)
        # output pixel centers in the pre-shift frame
        dy = (iy + 0.5 + ty) - cy_in
        dx = (ix + 0.5 + tx) - cx_in
        # inverse map of a visual-CCW rotation (image y axis points down)
        sx = cos * dx - sin * dy + cx_in
        sy = sin * dx + cos * dy + cy_in
        inb = (sx >= 0) & (sx < wf) & (sy >= 0) & (sy < hf)
        ixc = torch.floor(sx).to(torch.int32).clamp(0, W - 1)
        iyc = torch.floor(sy).to(torch.int32).clamp(0, H - 1)
        flat = img.reshape(B, H * W, C)
        index = (iyc * W + ixc).reshape(B, H * W, 1).long().expand(
            B, H * W, C)
        out = torch.gather(flat, 1, index).reshape(B, H, W, C)
        out = torch.where(inb[..., None], out, zero)
        return apply_mask(out, h2, w2), h2, w2

    # cos(-θ) = cos θ and sin(-θ) = -sin θ exactly, in float32 as in XLA
    ca, sa = cos, -sin
    c0 = ca * (-cx_in) + sa * (-cy_in) + cx_in
    f0 = -sa * (-cx_in) + ca * (-cy_in) + cy_in
    ex2 = -(w2.to(torch.float32).view(B, 1, 1) - wf) / 2
    ey2 = -(h2.to(torch.float32).view(B, 1, 1) - hf) / 2
    c1 = ca * ex2 + sa * ey2 + c0
    f1 = -sa * ex2 + ca * ey2 + f0
    X, Y = ix + 0.5, iy + 0.5
    xin = ca * X + sa * Y + c1
    yin = -sa * X + ca * Y + f1
    inb = (xin >= 0) & (xin < wf) & (yin >= 0) & (yin < hf)
    fx, fy = xin - 0.5, yin - 0.5
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    tx_w, ty_w = (fx - x0f)[..., None], (fy - y0f)[..., None]
    work = _premultiply(img) if C == 4 else img
    v00, v01, v10, v11 = _bilinear_taps(
        work.to(torch.float32), y0f.to(torch.int32), x0f.to(torch.int32),
        h.view(B, 1, 1), w.view(B, 1, 1))
    # PIL's BILINEAR macro is v = a + d*(b - a) — keep the same form
    top = v00 + tx_w * (v01 - v00)
    bot = v10 + tx_w * (v11 - v10)
    outf = top + ty_w * (bot - top)
    outf = torch.where(inb[..., None], outf, 0.0)
    # (UINT8)v — truncation toward zero (values are >= 0)
    out_i = torch.floor(outf).clamp(0, 255).to(torch.int32)
    if C == 4:
        out_i = _unpremultiply(out_i)
    return apply_mask(out_i.to(img.dtype), h2, w2), h2, w2


def _pil_rotate_matrix(w: int, h: int, angle: float):
    """Pillow Image.rotate(expand=True) affine construction, replicated in
    float64 verbatim (trig rounded to 15 decimals, corner-based expand
    size, center-preserving translation).  Returns (matrix[6], nw, nh)."""
    angle = angle % 360.0
    rc_x, rc_y = w / 2.0, h / 2.0
    a_r = -math.radians(angle)
    m = [round(math.cos(a_r), 15), round(math.sin(a_r), 15), 0.0,
         round(-math.sin(a_r), 15), round(math.cos(a_r), 15), 0.0]

    def trans(x, y):
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    m[2], m[5] = trans(-rc_x, -rc_y)
    m[2] += rc_x
    m[5] += rc_y
    xx, yy = [], []
    for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
        px, py = trans(x, y)
        xx.append(px)
        yy.append(py)
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    m[2], m[5] = trans(-(nw - w) / 2.0, -(nh - h) / 2.0)
    return m, nw, nh


def rotate_bilinear_exact(img, angle: float, h: int, w: int):
    """PIL-exact bilinear rotate-expand of ONE image for a host-known angle
    and size: bit-identical to Image.rotate(angle, expand=True,
    resample=BILINEAR).  img: uint8 [H, W, C] holding the image in
    [0:h, 0:w]; returns (out [H, W, C], nh, nw), the expanded extents as
    python ints (they must fit the canvas).

    The affine constants come from ``_pil_rotate_matrix``; the per-pixel
    affine, fill predicate, tap weights and blends are Pillow's own float64
    operations in Pillow's order (Geometry.c: affine_transform,
    bilinear_filter), and RGBA goes through the premultiplied round trip of
    Image.transform.  Multiples of 90° take Pillow's transpose path, a
    pixel copy.
    """
    H, W, C = img.shape
    dev = img.device
    angle, h, w = float(angle), int(h), int(w)
    angle_mod = angle % 360.0
    if angle_mod % 90.0 == 0.0:
        rot = torch.rot90(img[:h, :w], int(angle_mod // 90.0) % 4, (0, 1))
        nh, nw = rot.shape[0], rot.shape[1]
        out = torch.zeros_like(img)
        out[:nh, :nw] = rot
        return out, nh, nw

    m, nw, nh = _pil_rotate_matrix(w, h, angle)
    X = torch.arange(W, dtype=torch.float64, device=dev).view(1, W) + 0.5
    Y = torch.arange(H, dtype=torch.float64, device=dev).view(H, 1) + 0.5
    xin = m[0] * X + m[1] * Y + m[2]
    yin = m[3] * X + m[4] * Y + m[5]
    inb = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    fx, fy = xin - 0.5, yin - 0.5
    x0f, y0f = torch.floor(fx), torch.floor(fy)
    dx, dy = (fx - x0f)[..., None], (fy - y0f)[..., None]
    work = _premultiply(img) if C == 4 else img
    extent = torch.tensor([h, w], dtype=torch.int32, device=dev)
    v00, v01, v10, v11 = (t[0] for t in _bilinear_taps(
        work.to(torch.float64)[None], y0f.to(torch.int32)[None],
        x0f.to(torch.int32)[None], extent[0].view(1, 1, 1),
        extent[1].view(1, 1, 1)))
    top = v00 + dx * (v01 - v00)
    bot = v10 + dx * (v11 - v10)
    outv = top + dy * (bot - top)
    out_i = torch.floor(outv).clamp(0, 255).to(torch.int32)
    out_i = torch.where(inb[..., None], out_i, 0)
    if C == 4:
        out_i = _unpremultiply(out_i)
    out = apply_mask(out_i.to(img.dtype)[None], nh, nw)[0]
    return out, nh, nw


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


# ---------------------------------------------------------------------------
# separable resize: Pillow's fixed-point resample (Resample.c)
# ---------------------------------------------------------------------------

#: Pillow's 8-bit fixed point: taps are int32 with this many fraction bits
PRECISION_BITS = 32 - 8 - 2


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3) if -3.0 <= x < 3.0 else 0.0


def _bilinear(x: float) -> float:
    x = -x if x < 0.0 else x
    return 1.0 - x if x < 1.0 else 0.0


#: filter and support of each method; C's sin through ``math.sin``
RESIZE_FILTERS = {"bilinear": (_bilinear, 1.0), "lanczos": (_lanczos, 3.0)}


@functools.lru_cache(maxsize=4096)
def resample_coeffs(in_size: int, out_size: int, method: str):
    """One pass of Pillow's resample from ``in_size`` to ``out_size``
    pixels: (xmin [out] int64, taps [out, ksize] int64), output pixel xx
    summing taps[xx, k] * in[xmin[xx] + k].  Pillow's
    ``precompute_coeffs`` in float64 and ``normalize_coeffs_8bpc``
    (rounded half away from zero to PRECISION_BITS).  Read-only arrays,
    cached by their arguments."""
    if method not in RESIZE_FILTERS:
        raise ValueError(f"unknown resize filter {method!r}; choose from "
                         f"{tuple(RESIZE_FILTERS)}")
    filt, support = RESIZE_FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    xmins = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [filt((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in w:
            ww += v
        for x, v in enumerate(w):
            v = v / ww if ww != 0.0 else v
            v = v * (1 << PRECISION_BITS)
            taps[xx, x] = int(v - 0.5 if v < 0 else v + 0.5)
        xmins[xx] = xmin
    xmins.flags.writeable = False
    taps.flags.writeable = False
    return xmins, taps


def _pass_tables(n_in, n_out, In: int, Out: int, method: str):
    """Gather indices and taps [B, Out, K] int64 of one pass for a batch:
    item b resamples its n_in[b] valid pixels to n_out[b] (at most
    ``Out``); an unchanged extent copies (Pillow skips that pass), and
    outputs past n_out get no taps."""
    tables = []
    for i, o in zip(np.asarray(n_in).tolist(), np.asarray(n_out).tolist()):
        if i == o or i <= 0 or o <= 0:
            n = max(min(i, o), 0)
            xmin, t = (np.arange(n, dtype=np.int64),
                       np.full((n, 1), 1 << PRECISION_BITS, np.int64))
        else:
            xmin, t = resample_coeffs(i, o, method)
        tables.append((xmin[:Out], t[:Out]))
    K = max(t.shape[1] for _, t in tables)
    idx = np.zeros((len(tables), Out, K), np.int64)
    taps = np.zeros((len(tables), Out, K), np.int64)
    for b, (xmin, t) in enumerate(tables):
        n, k = t.shape
        idx[b, :n, :k] = np.minimum(xmin[:, None] + np.arange(k), In - 1)
        taps[b, :n, :k] = t
    return idx, taps


def _resample_pass(img, idx, taps, dim: int):
    """One fixed-point pass along ``dim`` (1 rows, 2 columns) of uint8
    [B, H, W, C]: int64 sums of the taps from ``1 << (PRECISION_BITS-1)``,
    then Pillow's clip8 (shift out the fraction, clamp to 0..255)."""
    shape = [img.shape[0], 1, 1, 1]
    shape[dim] = idx.shape[1]
    acc = torch.full((), 1 << (PRECISION_BITS - 1), dtype=torch.int64,
                     device=img.device)
    for k in range(idx.shape[2]):
        src = torch.take_along_dim(img, idx[:, :, k].reshape(shape), dim=dim)
        acc = acc + src.to(torch.int64) * taps[:, :, k].reshape(shape)
    return (acc >> PRECISION_BITS).clamp(0, 255).to(torch.uint8)


def resize(img, h, w, out_h, out_w, method: str = "lanczos",
           out_canvas=None):
    """Resize each item's valid region [0:h, 0:w] to (out_h, out_w), as
    ``PIL.Image.resize(..., LANCZOS | BILINEAR)`` on one band at a time.

    img: uint8 [B, H, W, C]; h, w, out_h, out_w: one host integer an item
    (numbers or [B] arrays: the coefficients are made on the host).
    Returns uint8 [B, Ho, Wo, C] on ``out_canvas`` = (Ho, Wo) (default the
    input canvas), zero outside [0:out_h, 0:out_w].

    Pillow's fixed-point form, not the JAX function's float32 matmuls
    (which are Pillow ±2): float64 coefficients rounded to int32 taps,
    summed in int64, the horizontal pass first into a rounded uint8
    intermediate, then the vertical one; a pass whose extent does not
    change is skipped.  Integer arithmetic, so the card and the CPU give
    the same bytes.  Replaces PIL Image.resize at reference
    overlays.py:129.
    """
    B, H, W, C = img.shape
    Ho, Wo = out_canvas if out_canvas is not None else (H, W)
    n = lambda v: np.broadcast_to(np.asarray(v, np.int64), (B,))
    h, w, out_h, out_w = (n(v) for v in (h, w, out_h, out_w))
    # resample only the columns and rows some item fills; the rest of the
    # canvas stays 0
    wmax, hmax = (min(int(v.max(initial=0)), lim)
                  for v, lim in ((out_w, Wo), (out_h, Ho)))
    dev = img.device
    idx, taps = (torch.from_numpy(a).to(dev)
                 for a in _pass_tables(w, out_w, W, wmax, method))
    tmp = _resample_pass(img, idx, taps, dim=2)
    idx, taps = (torch.from_numpy(a).to(dev)
                 for a in _pass_tables(h, out_h, H, hmax, method))
    out = torch.zeros((B, Ho, Wo, C), dtype=img.dtype, device=dev)
    out[:, :hmax, :wmax] = _resample_pass(tmp, idx, taps, dim=1)
    return out
