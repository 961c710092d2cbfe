"""Color-space ops (twin of image_processor_pipeline_tpu/ops/color.py):
cv2-exact RGB→HSV, cv2.inRange, zone rectangles, the mask→alpha conversion
and the GIMP-scale conversion of filter bounds."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from image_processor_pipeline_tpu_torch.ops.geometry import (
    item_extent,
    valid_mask,
)


def rgb_to_hsv_u8(img):
    """uint8 RGB [..., 3] → uint8 HSV, bit-exact vs cv2's 8U conversion
    (fixed point, hsv_shift=12): S = (diff·rint(1044480/V) + 2048) >> 12,
    H = (h_num·rint(122880/diff) + 2048) >> 12, +180 if negative, with
    h_num = G-B | B-R+2·diff | R-G+4·diff by sector (V==R priority).

    The table entries are IEEE float32 quotients: the numerator is a
    tensor, because ``scalar / tensor`` in torch multiplies by a reciprocal.
    """
    r = img[..., 0].to(torch.int32)
    g = img[..., 1].to(torch.int32)
    b = img[..., 2].to(torch.int32)
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = v - mn
    vf = v.clamp(min=1).to(torch.float32)
    sdiv = torch.round(torch.full_like(vf, 1044480.0) / vf)
    s8 = (diff * sdiv.to(torch.int32) + 2048) >> 12
    hnum = torch.where(
        v == r, g - b,
        torch.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    df = diff.clamp(min=1).to(torch.float32)
    hdiv = torch.round(torch.full_like(df, 122880.0) / df)
    h8 = (hnum * hdiv.to(torch.int32) + 2048) >> 12
    h8 = torch.where(h8 < 0, h8 + 180, h8)
    return torch.stack([h8, s8, v], dim=-1).to(torch.uint8)


def in_range(hsv, lower, upper):
    """cv2.inRange: bool mask where lower <= hsv <= upper channelwise, with
    the bounds saturate-rounded to uint8 first (half to even, [0, 255])."""
    h = hsv.to(torch.float32)
    lo = torch.round(torch.as_tensor(lower, dtype=torch.float32,
                                     device=h.device)).clamp(0, 255)
    hi = torch.round(torch.as_tensor(upper, dtype=torch.float32,
                                     device=h.device)).clamp(0, 255)
    return torch.all((h >= lo) & (h <= hi), dim=-1)


def zone_mask(H: int, W: int, h, w, top, bottom, left, right, device=None):
    """Bool [H, W] mask of a margin-inset rectangle of the valid region."""
    iy = torch.arange(H, dtype=torch.int32, device=device)[:, None]
    ix = torch.arange(W, dtype=torch.int32, device=device)[None, :]
    return (iy >= top) & (iy < h - bottom) & (ix >= left) & (ix < w - right)


def color_mask_alpha(img_rgb, h, w, lowers, uppers, zones):
    """OR of F HSV in-range masks, each ANDed with its zone, inverted into a
    uint8 alpha [..., H, W] (255 = keep, 0 = masked out; 0 outside the
    valid region).  h, w: numbers, or one value an item (a tensor of shape
    ``img_rgb.shape[:-3]``); lowers/uppers: [F, 3], any F; zones: [F, 4]
    margins (top, bottom, left, right)."""
    H, W = img_rgb.shape[-3], img_rgb.shape[-2]
    dev = img_rgb.device
    h, w = item_extent(h, dev), item_extent(w, dev)
    hsv = rgb_to_hsv_u8(img_rgb[..., :3])
    lowers = torch.as_tensor(lowers, dtype=torch.float32).reshape(-1, 3)
    uppers = torch.as_tensor(uppers, dtype=torch.float32).reshape(-1, 3)
    zones = torch.as_tensor(zones, dtype=torch.int32).reshape(-1, 4).tolist()
    acc = torch.zeros(hsv.shape[:-1], dtype=torch.bool, device=dev)
    for lo, hi, zn in zip(lowers, uppers, zones):
        acc = acc | (in_range(hsv, lo, hi)
                     & zone_mask(H, W, h, w, *zn, device=dev))
    alpha = torch.where(acc, 0, 255).to(torch.uint8)
    return torch.where(valid_mask(h, w, H, W, device=dev), alpha,
                       torch.zeros((), dtype=torch.uint8, device=dev))


def gimp_to_cv_hsv(hsv_bound: Sequence[float]) -> Tuple[float, float, float]:
    """GIMP-scale HSV (H∈[0,360], S,V∈[0,100]) → cv2 8-bit scale: H
    floor-divided by 2, S and V multiplied by 2.55 without rounding
    (``in_range`` saturate-rounds the bounds at compare time)."""
    h, s, v = hsv_bound
    if not (0 <= h <= 360 and 0 <= s <= 100 and 0 <= v <= 100):
        raise ValueError(f"HSV bound out of GIMP range: {hsv_bound}")
    return (h // 2, s * 2.55, v * 2.55)


def rescale_filter(filter_tuple, use_gimp_scale: bool = False):
    """Validate/convert one 6-tuple (Hmin,Smin,Vmin,Hmax,Smax,Vmax):
    OpenCV scale is validated (H <= 180); GIMP scale is converted
    (reference filtres_liste.py:8-39)."""
    mn_h, mn_s, mn_v, mx_h, mx_s, mx_v = filter_tuple
    if not use_gimp_scale:
        if mn_h > 180 or mx_h > 180:
            raise ValueError(
                f"H values ({mn_h}-{mx_h}) exceed the OpenCV range [0, 180]"
            )
        return tuple(filter_tuple)
    if any(sv > 100 for sv in (mn_s, mn_v, mx_s, mx_v)):
        raise ValueError(
            f"S/V values ({mn_s},{mn_v},{mx_s},{mx_v}) exceed the GIMP "
            "range [0, 100]"
        )
    return (mn_h // 2, mn_s * 2.55, mn_v * 2.55,
            mx_h // 2, mx_s * 2.55, mx_v * 2.55)
