"""Plain reference of the flagship augment chain (640 -> 512), written for
the benchmark from the chain's definition in plain PyTorch.

For each image: a 512 px crop that holds its box, a flip (bit 0 mirrors
the columns, bit 1 the rows), a rotation by the Paeth shears, an HSV mask
into alpha (cv2's 8-bit HSV, two in-range filters, the second inside a
margin), then Pillow's brightness, contrast and colour blends and a gain
per channel.  Every draw is worked out again from the item's seed with
the frozen threefry copy (``draws.py``).  ``dtype`` is the precision of
the float arithmetic: float32 is what the system states, and the control
runs bfloat16.
"""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import draws, shear

#: the chain's two-range HSV exclusion stack (cv2 scale) and its margins
FILTER_LOWERS = ((35.0, 60.0, 60.0), (100.0, 40.0, 40.0))
FILTER_UPPERS = ((85.0, 255.0, 255.0), (140.0, 230.0, 230.0))
FILTER_ZONES = ((0, 0, 0, 0), (16, 16, 8, 8))


def draws_for(seeds, xywhn, H: int, W: int, crop: int):
    """Each item's (y0, x0, angle, flip, enhance [B, 6]) from its seed and
    its normalised box: the crop offset uniform among those that hold the
    box, the angle uniform in [1, 359), the flip in {0..3}, brightness,
    contrast and colour in [0.7, 1.3) and the gains in [0.75, 1.25)."""
    seeds = np.asarray(seeds, np.int64)
    xywhn = np.asarray(xywhn, np.float32)
    keys = draws.split(draws.prng_key(seeds), 5)
    cx, cy, bw, bh = (xywhn[:, i] for i in range(4))
    half = np.float32(2)
    x1 = np.float32(W) * (cx - bw / half)
    y1 = np.float32(H) * (cy - bh / half)
    x2 = np.float32(W) * (cx + bw / half)
    y2 = np.float32(H) * (cy + bh / half)
    x1, y1, x2, y2 = (v.astype(np.int32).astype(np.int64)
                      for v in (x1, y1, x2, y2))
    lo_x = np.maximum(0, x2 - crop)
    hi_x = np.maximum(lo_x, np.minimum(x1, W - crop))
    lo_y = np.maximum(0, y2 - crop)
    hi_y = np.maximum(lo_y, np.minimum(y1, H - crop))
    x0 = draws.randint(keys[:, 0], (), lo_x, hi_x + 1)
    y0 = draws.randint(keys[:, 1], (), lo_y, hi_y + 1)
    angle = draws.uniform(keys[:, 2], (), 1.0, 359.0)
    flip = draws.randint(keys[:, 3], (), 0, 4)
    kb, kc, kcol, krgb = np.moveaxis(draws.split(keys[:, 4], 4), -2, 0)
    enh = np.concatenate([
        np.stack([draws.uniform(k, (), 0.7, 1.3) for k in (kb, kc, kcol)],
                 axis=-1),
        draws.uniform(krgb, (3,), 0.75, 1.25)], axis=-1)
    return y0, x0, angle, flip, enh


def hsv_u8(rgb, dtype):
    """cv2's 8-bit RGB -> HSV (fixed point, 12 fraction bits), its two
    reciprocal tables computed as quotients in ``dtype``."""
    r, g, b = (rgb[..., i].to(torch.int32) for i in range(3))
    v = torch.maximum(torch.maximum(r, g), b)
    diff = v - torch.minimum(torch.minimum(r, g), b)
    vf = v.clamp(min=1).to(dtype)
    sdiv = torch.round(torch.full_like(vf, 1044480.0) / vf).to(torch.int32)
    s = (diff * sdiv + 2048) >> 12
    hnum = torch.where(v == r, g - b,
                       torch.where(v == g, b - r + 2 * diff,
                                   r - g + 4 * diff))
    df = diff.clamp(min=1).to(dtype)
    hdiv = torch.round(torch.full_like(df, 122880.0) / df).to(torch.int32)
    h = (hnum * hdiv + 2048) >> 12
    h = torch.where(h < 0, h + 180, h)
    return h, s, v


def mask_alpha(rgb, dtype):
    """255 where no filter matches, 0 where one does; [B, S, S] uint8."""
    S = rgb.shape[1]
    h, s, v = hsv_u8(rgb, dtype)
    iy = torch.arange(S, device=rgb.device)[:, None]
    ix = torch.arange(S, device=rgb.device)[None, :]
    hit = torch.zeros(h.shape, dtype=torch.bool, device=rgb.device)
    for lo, hi, (top, bottom, left, right) in zip(
            FILTER_LOWERS, FILTER_UPPERS, FILTER_ZONES):
        lo = [min(255, max(0, round(x))) for x in lo]
        hi = [min(255, max(0, round(x))) for x in hi]
        inside = ((h >= lo[0]) & (h <= hi[0]) & (s >= lo[1]) & (s <= hi[1])
                  & (v >= lo[2]) & (v <= hi[2]))
        zone = ((iy >= top) & (iy < S - bottom) & (ix >= left)
                & (ix < S - right))
        hit = hit | (inside & zone)
    return torch.where(hit, 0, 255).to(torch.uint8)


def _blend(base, img, factor):
    """Pillow's Image.blend truncated: floor(clip(base + f * (img - base)))."""
    t = base + factor * (img - base)
    return torch.floor(torch.clamp(t, 0.0, 255.0))


def _luma(img_i32):
    """Pillow's convert('L'): (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    return (img_i32[..., 0] * 19595 + img_i32[..., 1] * 38470
            + img_i32[..., 2] * 7471 + 0x8000) >> 16


def enhance(rgb, enh, dtype):
    """Brightness, contrast (about the rounded mean luma), colour, then
    the gains rounded half to even; [B, S, S, 3] uint8 in and out."""
    f = torch.as_tensor(np.asarray(enh, np.float32), device=rgb.device) \
        .to(dtype)
    per = lambda k: f[:, k].reshape(-1, 1, 1, 1)
    img = torch.floor(torch.clamp(rgb.to(dtype) * per(0), 0.0, 255.0))
    lum = _luma(img.to(torch.int32))
    n = lum.shape[1] * lum.shape[2]
    total = lum.sum(dim=(1, 2), dtype=torch.int64)
    mean = torch.div(2 * total + n, 2 * n, rounding_mode="floor")
    img = _blend(mean.to(dtype).reshape(-1, 1, 1, 1), img, per(1))
    lum = _luma(img.to(torch.int32)).to(dtype)[..., None]
    img = _blend(lum, img, per(2))
    gains = f[:, 3:6].reshape(-1, 1, 1, 3)
    return torch.clamp(torch.round(img * gains), 0, 255).to(torch.uint8)


def chain(canvas, xywhn, seeds, crop: int = 512, dtype=torch.float32):
    """The chain on uint8 canvases [B, H, W, 3] (any device) for the
    normalised boxes [B, 4] and seeds [B]: RGBA [B, crop, crop, 4]."""
    B, H, W = canvas.shape[:3]
    y0, x0, angle, flip, enh = draws_for(seeds, xywhn, H, W, crop)
    dev = canvas.device
    ar = torch.arange(crop, device=dev)
    rows = torch.as_tensor(y0, device=dev).long()[:, None] + ar
    cols = torch.as_tensor(x0, device=dev).long()[:, None] + ar
    b = torch.arange(B, device=dev)[:, None, None]
    img = canvas[b, rows[:, :, None], cols[:, None, :], :3]
    f = torch.as_tensor(flip, device=dev).reshape(-1, 1, 1, 1)
    img = torch.where((f & 1).bool(), img.flip(2), img)
    img = torch.where((f & 2).bool(), img.flip(1), img)
    img = shear.rotate(img, *shear.shear_params(angle, crop, dtype))
    alpha = mask_alpha(img, dtype)
    return torch.cat([enhance(img, enh, dtype), alpha[..., None]], dim=-1)
