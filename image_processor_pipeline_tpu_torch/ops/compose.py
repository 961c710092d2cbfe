"""Alpha compositing: paste RGBA overlays onto RGB backgrounds at per-item
offsets, each overlay's alpha band as its mask (port of
image_processor_pipeline_tpu/ops/compose.py).

Parity target: reference overlays.py:138-139 —
``background.copy().paste(resized_overlay, (x, y), mask=resized_overlay)``.
The JAX package composites one item (``alpha_paste``) and vmaps it
(``alpha_paste_batch``); this one function takes a batch, with one value
an item for every extent and offset.
"""

from __future__ import annotations

import torch

from image_processor_pipeline_tpu_torch.ops import geometry


def alpha_paste(bg_rgb, bg_h, bg_w, ov_rgba, ov_h, ov_w, py, px):
    """Paste each overlay (valid region [0:ov_h, 0:ov_w] of its canvas)
    onto its background at (py, px).  bg_rgb [B, H, W, 3+] and ov_rgba
    [B, H, W, 4] are uint8 canvases of one [H, W]; the extents and offsets
    are numbers or [B] tensors.  Returns [B, H, W, 3] uint8.

    Paste.c's BLEND in exact integers: out = (bg*(255-a) + ov*a + 127) //
    255 inside the pasted box and the background's valid region, bg
    elsewhere — byte-identical to ``background.paste(ov, (px, py),
    mask=ov)`` given the same inputs.
    """
    B, H, W = bg_rgb.shape[:3]
    dev = bg_rgb.device
    # move overlay content from the canvas origin to the paste position
    ov = geometry.roll2(ov_rgba, py, px)
    py, px, ov_h, ov_w, bg_h, bg_w = (
        geometry._per_item(v, B, dev).view(B, 1, 1)
        for v in (py, px, ov_h, ov_w, bg_h, bg_w))
    iy = torch.arange(H, dtype=torch.int32, device=dev).view(1, H, 1)
    ix = torch.arange(W, dtype=torch.int32, device=dev).view(1, 1, W)
    inside = ((iy >= py) & (iy < py + ov_h) & (ix >= px) & (ix < px + ov_w)
              & (iy < bg_h) & (ix < bg_w))
    a = torch.where(inside, ov[..., 3].to(torch.int32), 0)[..., None]
    bgi = bg_rgb[..., :3].to(torch.int32)
    ovi = ov[..., :3].to(torch.int32)
    out = torch.div(bgi * (255 - a) + ovi * a + 127, 255,
                    rounding_mode="floor")
    return out.to(bg_rgb.dtype)
