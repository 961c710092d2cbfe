"""PIL-exact photometric enhance (twin of
image_processor_pipeline_tpu/ops/photometric.py): the blends of
ImageEnhance, the fixed-point box passes of ImageFilter.GaussianBlur and
the per-channel gains.

Every blend is written as a separate multiply and add: each torch op rounds
once, as PIL's C code does.  A fused multiply-add (which XLA's CPU backend
makes of the same expression under ``jit``) can move a truncated result by
one.

Factors are python floats, 0-d tensors or per-image tensors of shape
``img.shape[:-3]``; gains have a trailing axis of 3.  ``h``/``w`` give
each item's valid extent on a padded canvas (numbers, or one value an
item).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from image_processor_pipeline_tpu_torch.ops.geometry import (
    apply_mask,
    item_extent,
    valid_mask,
)


def _per_image(factor, img, channels: bool = False):
    """Factor as float32 on img's device, broadcastable to [..., H, W, C]."""
    f = torch.as_tensor(factor, dtype=torch.float32, device=img.device)
    if channels:
        return f.reshape(f.shape[:-1] + (1, 1, f.shape[-1]))
    return f.reshape(f.shape + (1, 1, 1))


def _luminance_i32(img_i32):
    """ITU-R 601-2 luma exactly as PIL convert('L') computes it:
    (R*19595 + G*38470 + B*7471 + 0x8000) >> 16."""
    return (img_i32[..., 0] * 19595 + img_i32[..., 1] * 38470
            + img_i32[..., 2] * 7471 + 0x8000) >> 16


def _blend_trunc(deg_f, img_f, factor):
    """PIL Image.blend: float32 ``deg + factor*(img - deg)``, truncated
    (one floor(clip(...)) covers both of PIL's branches)."""
    t = deg_f + factor * (img_f - deg_f)
    return torch.floor(torch.clamp(t, 0.0, 255.0))


def brightness(img, factor):
    """PIL ImageEnhance.Brightness: blend(black, img, factor), truncated."""
    f = img.to(torch.float32) * _per_image(factor, img)
    return torch.floor(torch.clamp(f, 0.0, 255.0)).to(img.dtype)


def exact_mean_round_half_up(lum, n, mask=None):
    """floor(sum(lum)/n + 0.5) over the last two axes, exactly: torch sums
    int32 into int64, so the mean is the integer floor((2T + n) / (2n)).
    ``n``: the count of pixels, a number or one value an item; ``mask``
    (bool, broadcastable to ``lum``): the pixels that count.  The JAX
    package reaches the same integer with a float estimate and an integer
    residual correction, having no 64-bit integers on the TPU."""
    if mask is not None:
        lum = torch.where(mask, lum, 0)
    total = lum.sum(dim=(-2, -1), dtype=torch.int64)
    return torch.div(2 * total + n, 2 * n, rounding_mode="floor").to(
        torch.int32)


def contrast(img, factor, h=None, w=None):
    """PIL ImageEnhance.Contrast: blend(gray(mean_L), img, factor), with
    PIL's mean ``int(mean(convert('L')) + 0.5)`` over the valid region
    [0:h, 0:w] of each item (the whole canvas without ``h``/``w``)."""
    lum = _luminance_i32(img.to(torch.int32))
    H, W = img.shape[-3], img.shape[-2]
    if h is not None:
        m = valid_mask(item_extent(h, img.device), item_extent(w, img.device),
                       H, W, device=img.device)
        n = m.sum(dim=(-2, -1)).clamp(min=1)
        mean = exact_mean_round_half_up(lum, n, mask=m)
    else:
        mean = exact_mean_round_half_up(lum, H * W)
    mean = mean.to(torch.float32)
    out = _blend_trunc(mean[..., None, None, None], img.to(torch.float32),
                       _per_image(factor, img))
    return out.to(img.dtype)


def color_balance(img, factor):
    """PIL ImageEnhance.Color: blend(grayscale, img, factor), truncated."""
    lum = _luminance_i32(img.to(torch.int32)).to(torch.float32)[..., None]
    out = _blend_trunc(lum, img.to(torch.float32), _per_image(factor, img))
    return out.to(img.dtype)


def box_radius_bound(sigma_max: float, passes: int = 3) -> int:
    """Static tap-window bound for gaussian_blur: the smallest max_radius
    that covers the box radius Pillow derives from ``sigma_max`` (the far
    taps sit at r+1 <= max_radius+1, so max_radius = floor(fr) suffices;
    +1 slack absorbs float32 rounding of the radius formula)."""
    sigma2 = sigma_max * sigma_max / passes
    L = math.sqrt(12.0 * sigma2 + 1.0)
    ll = math.floor((L - 1.0) / 2.0)
    a = (2 * ll + 1) * (ll * (ll + 1) - 3 * sigma2)
    a /= 6 * (sigma2 - (ll + 1) * (ll + 1))
    return int(ll + a) + 1


def box_weights(sigma, passes: int = 3, max_radius: int = 12):
    """Pillow's box-pass constants for GaussianBlur(radius=sigma), on the
    host: (r int32, ww int64, fw int64), each of ``sigma``'s shape.

    fr = l + a is the fractional box radius of BoxBlur.c, r = (int)fr,
    ww = (UINT32)(2^24 / (fr*2 + 1)) (a float32 divide, truncated) and
    fw = (2^24 - (2r+1)*ww) / 2.  Every operation is numpy float32 in
    the order of the JAX function called eagerly, which is Pillow's C
    arithmetic.  Under ``jit`` XLA turns the division by ``passes`` into a
    multiply by a reciprocal and contracts one subtraction into a fused
    multiply-add, which moves ww by up to 2 for some 7 % of sigmas in
    [0.5, 3]: such items of a jitted JAX run are a documented delta."""
    f32 = np.float32
    sig = np.maximum(np.asarray(sigma, f32), f32(1e-6))
    sigma2 = sig * sig / f32(passes)
    L = np.sqrt(f32(12.0) * sigma2 + f32(1.0))
    l = np.floor((L - f32(1.0)) / f32(2.0))
    a = (f32(2) * l + f32(1)) * (l * (l + f32(1)) - f32(3) * sigma2)
    a = a / (f32(6) * (sigma2 - (l + f32(1)) * (l + f32(1))))
    fr = l + a
    r = np.minimum(fr.astype(np.int32), np.int32(max_radius))
    ww = (f32(1 << 24) / (fr * f32(2) + f32(1))).astype(np.uint32)
    fw = (np.uint32(1 << 24) - (2 * r + 1).astype(np.uint32) * ww) \
        // np.uint32(2)
    return r, ww.astype(np.int64), fw.astype(np.int64)


def gaussian_blur(img, sigma, passes: int = 3, max_radius: int = 12,
                  h=None, w=None, sigma_max=None):
    """Gaussian blur bit-exact vs PIL ImageFilter.GaussianBlur: ``passes``
    fractional-radius box blurs per axis (horizontal passes first, then
    vertical), each pass integer fixed point,

        out[x] = (ww*sum(in[x-r..x+r]) + fw*(in[x-r-1] + in[x+r+1])
                  + 2^23) >> 24

    with clamp-to-edge taps and the constants of ``box_weights``.

    img: uint8 [..., H, W, C]; ``sigma``: a number or one value an item,
    on the host (a draw: numpy or a CPU tensor), so that the constants are
    numpy float32 arithmetic on any device.  ``h``/``w``: the valid extent
    on a padded canvas; the last valid row and column are replicated into
    the padding before every pass, so padding never bleeds into the valid
    region.  Taps are bounded by ``max_radius``: a sigma (or ``sigma_max``,
    the top of the range the sigmas are drawn from) whose box radius
    exceeds it raises instead of degrading.

    The JAX function works in uint32 (tap sums stay below 255·2^24 +
    510·fw < 2^32); torch's uint32 supports few ops, so the sums here are
    int64 and never wrap.
    """
    if isinstance(sigma, torch.Tensor):
        sigma = sigma.detach().cpu().numpy()
    sigma = np.asarray(sigma, np.float32)
    for name, top in (("sigma_max", sigma_max),
                      ("sigma", float(sigma.max()) if sigma.size else None)):
        if top is not None and box_radius_bound(float(top), passes) \
                > max_radius:
            raise ValueError(
                f"{name}={top} needs a box window of "
                f"{box_radius_bound(float(top), passes)} taps but "
                f"max_radius={max_radius}; raise max_radius "
                "(see box_radius_bound)")
    dev = img.device
    lead = sigma.shape + (1, 1, 1)
    r, ww, fw = (torch.as_tensor(v, device=dev).reshape(lead)
                 for v in box_weights(sigma, passes, max_radius))
    H, W = img.shape[-3], img.shape[-2]
    pad = max_radius + 1

    def box1d(arr, dim, n):
        """One Pillow box pass along ``dim`` (arr: int64 <= 255), the
        lines from ``n`` on first set to line n - 1."""
        size = arr.shape[dim]
        shape = [1] * arr.ndim
        shape[dim] = size
        if n is not None:
            line = torch.arange(size, device=dev).reshape(shape)
            n = item_extent(n, dev).unsqueeze(-1).long()
            idx = torch.minimum(line, (n - 1).clamp(min=0))
            arr = torch.gather(arr, dim, idx.expand(arr.shape))
        first = arr.narrow(dim, 0, 1)
        last = arr.narrow(dim, size - 1, 1)
        reps = [1] * arr.ndim
        reps[dim] = pad
        ap = torch.cat([first.repeat(reps), arr, last.repeat(reps)], dim)
        bulk = torch.zeros_like(arr)
        for k in range(-pad, pad + 1):
            wk = torch.where(abs(k) <= r, ww,
                             torch.where(abs(k) == r + 1, fw, 0))
            bulk = bulk + ap.narrow(dim, k + pad, size) * wk
        return (bulk + (1 << 23)) >> 24

    out = img.to(torch.int64)
    for dim, n in ((-2, w), (-3, h)):
        for _ in range(passes):
            out = box1d(out, dim, n)
    return out.to(img.dtype)


def channel_gains(img, gains):
    """Per-channel multiplicative gain, rounded half to even (PIL point()'s
    LUT rounding) and clamped to [0, 255]."""
    f = img.to(torch.float32) * _per_image(gains, img, channels=True)
    return torch.clamp(torch.round(f), 0, 255).to(img.dtype)


def enhance(img, h, w, b_factor, c_factor, col_factor, blur_sigma,
            apply_blur, rgb_gains, apply_rgb, blur_max_radius: int = 12,
            blur_sigma_max=None):
    """Full enhance chain of reference tranfo.py:9-55 on a batch: img
    [B, H, W, 3] uint8, h, w [B]; the factors, ``rgb_gains`` [B, 3] and the
    flags ``apply_blur``/``apply_rgb`` (bool [B]) one value an item;
    ``blur_sigma`` on the host (see ``gaussian_blur``).  The blur is run
    for the whole batch and kept where ``apply_blur`` says."""
    out = brightness(img, b_factor)
    out = contrast(out, c_factor, h, w)
    out = color_balance(out, col_factor)
    blurred = gaussian_blur(out, blur_sigma, max_radius=blur_max_radius,
                            h=h, w=w, sigma_max=blur_sigma_max)
    out = torch.where(_flag(apply_blur, img), blurred, out)
    out = torch.where(_flag(apply_rgb, img), channel_gains(out, rgb_gains),
                      out)
    return apply_mask(out, h, w)


def _flag(flag, img):
    """A per-item bool flag on img's device, broadcastable to img."""
    f = torch.as_tensor(flag, dtype=torch.bool, device=img.device)
    return f.reshape(f.shape + (1, 1, 1))
